"""The entry ``genpc_tpu_torch.parallel.batched_runner.run_batched`` (the
Redwood pipeline with batched stages) and its plain reference,
``portbench/reference/plain/parallel/batched_runner.run_batched``.

An entry file gives the harness five calls, so that a cell on another
entry of the port comes as a new file of this kind, named by its traffic
mix's ``entry`` key:

- ``port_config(overrides)``: the port's configuration;
- ``run(cfg, flags, data_dir, timings)``: one pass over the objects,
  returning ``{flag: {score: value}}``; ``timings``, when a dict,
  receives the pass's stage walls in seconds;
- ``recording()``: a context in which each object record the timed path
  makes is appended to the list it yields (attributes as on the port's
  ``ObjectArtifacts``, which the check's fields name);
- ``release()``: drops what the port keeps between passes;
- ``reference(overrides, flags, data_dir, check)``: the reference's
  scores of the ``check`` flags and ``{flag: record}`` of every flag.

The port's records are taken by wrapping ``batched_runner.
input_artifacts``, whose records the pass fills in place.
"""

from __future__ import annotations

from contextlib import contextmanager


def port_config(overrides: dict):
    from genpc_tpu_torch.config import load_config
    return load_config(**overrides)


def run(cfg, flags, data_dir: str, timings=None):
    from genpc_tpu_torch.parallel import batched_runner
    return batched_runner.run_batched(cfg, flags, data_dir, timings=timings)


@contextmanager
def recording():
    from genpc_tpu_torch.parallel import batched_runner
    made: list = []
    original = batched_runner.input_artifacts

    def record(*args, **kwargs):
        art = original(*args, **kwargs)
        made.append(art)
        return art

    batched_runner.input_artifacts = record
    try:
        yield made
    finally:
        batched_runner.input_artifacts = original


def release() -> None:
    from genpc_tpu_torch.parallel import batched_runner
    getattr(batched_runner, "_GT_DEVICE_CACHE", {}).clear()


def reference(overrides: dict, flags, data_dir: str, check):
    from portbench.reference.plain.config import load_config
    from portbench.reference.plain.parallel.batched_runner import run_batched
    scores, arts = run_batched(load_config(**overrides), flags, data_dir,
                               check=check)
    return scores, {a.flag: a for a in arts}

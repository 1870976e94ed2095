"""One run of one benchmark cell of the port (``genpc_tpu_torch``).

A cell names a configuration (``configs/<config>.json``: the port's
configuration overrides) and a traffic mix (``traffic/<traffic>.json``:
objects a pass, GT points, the path's overrides, the objects the check
samples).  The traffic mix names, by file, the three pieces a run is
made of, so that a cell on another path comes as new files:

- ``entry``: ``entries/<entry>.py``, the port's entry the window drives
  and its plain reference (``entries/batched.py`` says what it gives);
- ``generator``: ``traffic/<generator>.py``, whose ``write(root,
  traffic, seed)`` writes the inputs from the seed and returns their
  flags;
- ``check``: ``checks/<check>.json``, the numbers that decide
  ``correct`` and their limits (``reference/judge.py``).

A run:

1. set-up: loads the port's kernels (built into the checkout's ``build/``
   on the first run there, and that build's seconds logged apart),
   writes the cell's inputs from the seed into ``TMPDIR``, runs one
   warm-up pass at the cell's shapes;
2. the window: a closed loop of whole passes of the entry over those
   inputs, the next pass as soon as one ends, none started once the
   window's seconds have elapsed.  With tracing on, every pass records its
   stage walls (``timings``) and the launches of the wrappers named in
   ``kernels/*.json``, and one more pass runs under ``torch.profiler``;
3. the check: once the window has closed and the peak memory is read,
   the entry's plain reference runs the pipeline again, and
   ``reference/judge`` holds the object records of the window's last
   pass, and every pass's scores, to it by the cell's check;
4. the result: one JSON line, ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's end-to-end metrics, or with tracing its
   per-layer metrics, each read by ``metrics/<name>.py`` from the run's
   record), ``device``, ``breakdown`` when traced, and ``checks`` last.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded when the result prints
BANNED = ("jax", "jaxlib", "flax", "genpc_tpu")
STAGES = ("load", "stage1", "generate", "stage2", "stage3", "metric")
SUBSTAGES = {"stage3": ("reg_prep", "reg_pose", "reg_coarse", "reg_fine",
                        "reg_refine", "reg_fusion")}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell's entry with its configuration, traffic, end-to-end and
    per-layer metrics, all found by name."""
    bench = json.loads(bench_path.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved
                              else [])]
    return {"name": name, "chips": int(cell["chips"]),
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads(
                (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": e2e, "per_layer": layer}


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_wrappers() -> Dict[str, object]:
    """name -> the port's traced wrapper, for each ``kernels/<name>.json``."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = getattr(importlib.import_module(spec["module"]),
                                 spec["attr"])
    return out


def _module(folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric_reader(name: str):
    return _module("metrics", name).read


def entry(cell: dict):
    """The cell's entry file (``entries/<entry>.py``)."""
    return _module("entries", cell["traffic"]["entry"])


def check_spec(cell: dict) -> dict:
    """The cell's check (``checks/<check>.json``)."""
    from portbench.reference import judge
    return judge.load(cell["traffic"]["check"])


def _stage_spans(t0: float, timings: Dict[str, float]) -> List[tuple]:
    """(name, start, end) in the timeline of t0 (seconds) for each stage
    of one pass, and for the registration steps inside stage 3 (the
    finest span containing a time names it)."""
    spans, cursor = [], t0
    for stage in STAGES:
        d = timings.get(stage)
        if d is None:
            continue
        spans.append((stage, cursor, cursor + d))
        sub = cursor
        for step in SUBSTAGES.get(stage, ()):
            if step in timings:
                spans.append((f"{stage}/{step}", sub, sub + timings[step]))
                sub += timings[step]
        cursor += d
    return spans


def summarize_profile(events, timings: Dict[str, float]) -> dict:
    """From the profiler's raw events of one pass (inside the range
    ``portbench.pass``): the pass's wall, the seconds in which any device
    operation ran (the union of their intervals; annotations of host
    ranges on the device's timeline are not operations), the device
    operations that took most time, and the device's idle time by the
    stage that was open on the host."""
    import torch
    mark = [e for e in events if e.name() == "portbench.pass"
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if not mark:
        return {}
    t0 = mark[0].start_ns() / 1e9
    t1 = t0 + mark[0].duration_ns() / 1e9
    ivals, by_name = [], {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation() or e.name() == "portbench.pass":
            continue
        a = max(e.start_ns() / 1e9, t0)
        b = min(e.start_ns() / 1e9 + e.duration_ns() / 1e9, t1)
        if b > a:
            ivals.append((a, b))
            name = e.name()[:160]
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    ivals.sort()
    busy, gaps, end = 0.0, [], t0
    for a, b in ivals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((end, t1))
    # cut the pass at every stage boundary; each piece is named by the
    # finest stage span holding it, and each gap's idle time is shared
    # among the pieces it overlaps
    spans = _stage_spans(t0, timings)
    cuts = sorted({t0, t1, *(x for sp in spans for x in sp[1:]
                             if t0 < x < t1)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        inside = [sp for sp in spans if sp[1] <= mid < sp[2]]
        pieces.append((a, b, min(inside, key=lambda sp: sp[2] - sp[1])[0]
                       if inside else "outside the stage marks"))
    idle = {}
    for a, b in gaps:
        for pa, pb, name in pieces:
            over = min(b, pb) - max(a, pa)
            if over > 0:
                idle[name] = idle.get(name, 0.0) + over
    return {"window_s": t1 - t0, "busy_s": busy,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_by_stage": sorted(idle.items(), key=lambda kv: -kv[1])[:10]}


def write_inputs(cell: dict, root: Path, seed: int) -> list:
    """The cell's inputs from the seed, written under root by its traffic
    mix's generator; returns their flags."""
    if root.exists():
        shutil.rmtree(root)
    traffic = cell["traffic"]
    return _module("traffic", traffic["generator"]).write(str(root),
                                                          traffic, seed)


def checked_flags(flags: list, k: int, seed: int) -> list:
    """The objects the check compares, drawn from the seed."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(flags), min(k, len(flags)), replace=False)
    return [flags[i] for i in sorted(pick)]


def cell_overrides(cell: dict, device: str,
                   overrides: Optional[dict] = None) -> dict:
    """The configuration's overrides, then the traffic's, then the given
    ones, with the run's device."""
    return {**cell["config"]["overrides"], **cell["traffic"]["overrides"],
            **(overrides or {}), "device": device}


def reference_records(cell: dict, flags: list, check: list, data_dir: str,
                      device: str, tf32: bool = False,
                      overrides: Optional[dict] = None):
    """The plain reference's (scores of the checked flags, flag -> record
    of every flag), in fp32 with TF32 off, or with ``tf32`` in TF32 (the
    control), by the cell's entry file."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return entry(cell).reference(cell_overrides(cell, device, overrides),
                                     flags, data_dir, check)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _load_kernels() -> Optional[float]:
    """Loads the port's kernel library; returns the seconds spent building
    it where this checkout had no build yet, else None."""
    from genpc_tpu_torch import _kernels
    built = _kernels.library_path().exists()
    t = time.time()
    _kernels.lib()
    return None if built else time.time() - t


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None,
             tmp_root: Optional[str] = None) -> dict:
    """One run of the cell; returns the result's fields (``overrides``
    and the CPU serve the tests, which run tiny shapes on the host)."""
    t_start = time.time() if t_start is None else t_start
    import torch
    dev = torch.device(device)
    ent = entry(cell)
    build_s = _load_kernels() if dev.type == "cuda" else None
    if build_s is not None:
        log(f"kernel build: {build_s:.3f} s (this checkout's first run; "
            "inside setup_s)")
    traffic = cell["traffic"]
    data_dir = Path(tmp_root or tempfile.gettempdir()) / \
        f"portbench-{cell['name']}-{seed}"
    flags = write_inputs(cell, data_dir, seed)
    cfg = ent.port_config(cell_overrides(cell, device, overrides))
    wrappers = _kernel_wrappers() if trace and dev.type == "cuda" else {}
    try:
        with ent.recording() as made:
            ent.run(cfg, flags, str(data_dir))                 # warm-up
            _sync(dev)
            setup_s = time.time() - t_start
            peak = torch.cuda.max_memory_allocated(dev) \
                if dev.type == "cuda" else 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            for w in wrappers.values():
                w.trace = []
            passes, scores = [], []
            t_w = time.time()
            while not passes or time.time() - t_w < seconds:
                made.clear()
                timings = {} if trace else None
                t_p = time.time()
                res = ent.run(cfg, flags, str(data_dir), timings)
                passes.append({"seconds": time.time() - t_p,
                               "timings": timings})
                scores.append(res)
            records = {a.flag: a for a in made}
            made.clear()
        log("passes (s): " + " ".join(f"{p['seconds']:.4f}"
                                      for p in passes))
        kernels = {}
        for name, w in wrappers.items():
            _sync(dev)
            kernels[name] = [(tuple(shape), s.elapsed_time(e) / 1e3)
                             for shape, s, e in w.trace]
            w.trace = None
        profile = None
        if trace:
            profile = _profiled_pass(ent, cfg, flags, data_dir, dev)
        window_peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
    finally:
        for w in wrappers.values():
            w.trace = None
    record = {"cell": cell["name"], "objects": len(flags), "passes": passes,
              "kernels": kernels, "profile": profile, "setup_s": setup_s,
              "build_s": build_s,
              "memory": {"window_peak_bytes": window_peak,
                         "peak_bytes": max(peak, window_peak)}}

    # the program's state goes before the reference runs
    ent.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check = checked_flags(flags, int(traffic["checked_objects"]), seed)
    t_ref = time.time()
    ref_scores, ref_records = reference_records(
        cell, flags, check, str(data_dir), device, overrides=overrides)
    from portbench.reference import judge
    spec = check_spec(cell)
    nums = judge.numbers(spec, records, scores, ref_records, ref_scores,
                         dev)
    log(f"reference: {len(check)} objects {check} in "
        f"{time.time() - t_ref:.3f} s")
    shutil.rmtree(data_dir, ignore_errors=True)

    failed = sum(1 for res in scores for f in flags
                 if not all(math.isfinite(v) for v in
                            (res.get(f) or {"": math.nan}).values()))
    return {"record": record, "numbers": nums, "check": spec,
            "correct": judge.verdict(spec, nums) and failed == 0,
            "attempted": len(flags) * len(passes), "failed": failed}


def _profiled_pass(ent, cfg, flags, data_dir, dev) -> dict:
    """One more pass under torch.profiler, kept in memory."""
    from torch.profiler import ProfilerActivity, profile, record_function
    timings: Dict[str, float] = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.pass"):
            ent.run(cfg, flags, str(data_dir), timings)
            _sync(dev)
    out = summarize_profile(prof.profiler.kineto_results.events(),
                            timings)
    out["timings"] = timings
    return out


def result_line(cell: dict, run: dict, trace: bool) -> dict:
    """The last line: the cell's metrics read from the run's record."""
    import torch
    record = run["record"]
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = _metric_reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": record["memory"]["peak_bytes"]}
    line = {"correct": run["correct"], "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    prof = record.get("profile") or {}
    if trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in prof["device_ops"]],
            "idle_gaps": [[n, s] for n, s in prof["idle_by_stage"]]}
    from portbench.reference import judge
    line["checks"] = judge.report(run["check"], run["numbers"])
    return line

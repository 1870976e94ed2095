"""Faults planted in the port under a run, to show that the check catches
them: each one breaks the timed path underneath and the run's
``correct`` has to come out false.

- ``pose_unchanged``: the pose optimisation returns its state unchanged
  (identity poses), on the registration path;
- ``fill_unchanged``: the stage-1 depth fill returns its input unfilled;
- ``half_the_points``: half of each object's points left out of the
  metric, the mean taken over the rest;
- ``cd_altered``: an answer altered where it is produced (each object's
  CD times 1.05).

One card runs the cells, so there is no exchange between chips to leave
out.  The CPU tests plant them at a tiny size; on the card,

    python3 portbench/faults.py --workload <cell> --fault <name> --seeds <n> [<n> ...]

runs the cell at its own size, one timed pass a seed, and prints one
JSON line a seed with the compared numbers and the verdict."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def pose_unchanged(setattr_):
    import torch
    from genpc_tpu_torch.parallel import batched_runner
    setattr_(batched_runner, "batched_pose_optim",
             lambda c, *a, **k: torch.eye(4, device=c.device).expand(
                 c.shape[0], 4, 4).clone())


def fill_unchanged(setattr_):
    import torch
    from genpc_tpu_torch.render import inpaint
    setattr_(inpaint, "diffusion_inpaint",
             lambda img, hole, iters=250: img.to(torch.float32))


def half_the_points(setattr_):
    from genpc_tpu_torch.parallel import batched_runner
    original = batched_runner.batched_metric_sampled

    def half(p, g, **kw):
        n = p.shape[1] // 2
        return original(p[:, :n].contiguous(), g[:, :n].contiguous(), **kw)

    setattr_(batched_runner, "batched_metric_sampled", half)


def cd_altered(setattr_):
    from genpc_tpu_torch.parallel import batched_runner
    original = batched_runner.batched_metric_sampled

    def altered(p, g, **kw):
        cd, emd = original(p, g, **kw)
        return cd * 1.05, emd

    setattr_(batched_runner, "batched_metric_sampled", altered)


FAULTS = {f.__name__: f for f in (pose_unchanged, fill_unchanged,
                                  half_the_points, cd_altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    FAULTS[args.fault](setattr)
    for seed in args.seeds:
        t = time.time()
        run = harness.run_cell(cell, seed, 0.0, trace=False)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": run["correct"],
                          "seconds": time.time() - t,
                          "numbers": run["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

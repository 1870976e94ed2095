"""The control of the FLUX check (``checks/flux.json``): the plain
reference with the inputs of every linear layer and every attention
rounded to fp8 e4m3 (the nearest precision below the configuration's bf16
activations; the int4 weights stay as they are), put in the port's place
and judged as a run's outputs are, against the fp32 reference, on the
cell's own objects.  It has to come out not correct, through
``paint_v0_gap`` or ``gen_v0_gap``.  (``control.py``'s TF32 keeps more
precision than the port's bf16, so it cannot fail a limit the port
passes.)

    python3 portbench/flux_control.py --workload flux_reg3 --seeds <n> ...

prints one JSON line a seed with the compared numbers and the verdict.
Run on the card; the benchmark's own runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the reference's setting that rounds to fp8 e4m3
FP8 = {"reference_precision": "fp8_e4m3"}


def control_numbers(cell: dict, seed: int, device: str = "cuda",
                    overrides=None, tmp_root=None) -> dict:
    """The judge's numbers for the fp8 reference against the fp32 one on
    the cell's checked objects of this seed."""
    from portbench import harness
    from portbench.reference import judge
    data = Path(tmp_root or tempfile.gettempdir()) / \
        f"portbench-flux-control-{cell['name']}-{seed}"
    flags = harness.write_inputs(cell, data, seed)
    check = harness.checked_flags(
        flags, int(cell["traffic"]["checked_objects"]), seed)
    ref_scores, ref = harness.reference_records(
        cell, flags, check, str(data), device, overrides=overrides)
    low_scores, low = harness.reference_records(
        cell, flags, check, str(data), device,
        overrides={**(overrides or {}), **FP8})
    return judge.numbers(harness.check_spec(cell), low, [low_scores], ref,
                         ref_scores, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    from portbench.reference import judge
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        t = time.time()
        nums = control_numbers(cell, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": judge.verdict(
                              harness.check_spec(cell), nums),
                          "seconds": time.time() - t,
                          "numbers": nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

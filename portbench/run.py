"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The last
line of standard output is the result (``harness.result_line``); the
compared numbers, each with its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without CUDA or enough
devices, or when JAX or the JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of a run lives at a fixed path inside the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from portbench import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count()}")
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    line = harness.result_line(cell, run, bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        harness.log(f"loaded in the result's process: {banned}")
        return 3
    from portbench.reference import judge
    for text in judge.lines(run["check"], run["numbers"]):
        harness.log(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

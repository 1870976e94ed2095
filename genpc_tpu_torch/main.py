"""End-to-end pipeline entry point (counterpart of the ``--batched`` branch of
genpc_tpu/main.py: the object-batched runner is the only one ported).

Usage:
  python -m genpc_tpu_torch.main --config configs/redwood.yaml \
      --data-dir DATA --flags 01184 05117 [--aligned] [--device cuda]

Stage 3 registers every completion to its partial (pose optimisation,
coarse and fine ICP sweeps, final refine), the reference's headline
path.  ``--aligned`` (``trust_aligned_completion=True``) takes the fast
path instead: completions their backend declares aligned skip
registration.  Workspace saving is not ported: runs use ``save=False``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from genpc_tpu_torch.categories import REDWOOD_FLAGS, get_category
from genpc_tpu_torch.config import load_config


def summarize(results):
    """Per-category print + averages (reference: main.py:70-78)."""
    if not results:
        return {}
    for flag, m in results.items():
        emd_txt = f", EMD: {m['emd']*100:.3f}" if "emd" in m else ""
        print(f"Category: {get_category(flag)}, CD: {m['cd']*100:.3f}"
              f"{emd_txt}")
    avg = {k: float(np.mean([m[k] for m in results.values() if k in m]))
           for k in next(iter(results.values()))}
    print(f"Average CD: {avg['cd']*100:.6f}")
    if "emd" in avg:
        print(f"Average EMD: {avg['emd']*100:.6f}")
    return avg


def main(argv=None):
    ap = argparse.ArgumentParser(description="genpc_tpu_torch pipeline")
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--gt-dir", default=None)
    ap.add_argument("--flags", nargs="*", default=None,
                    help="object flags (default: all redwood flags present)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="override all generative backends (synthetic)")
    ap.add_argument("--aligned", action="store_true",
                    help="trust_aligned_completion: skip registration for "
                         "completions already in the input frame (the "
                         "fast path; default: register)")
    ap.add_argument("--no-emd", action="store_true")
    args = ap.parse_args(argv)

    cfg = load_config(args.config, save=False)
    if args.device:
        cfg.device = args.device
    if args.backend:
        cfg.control_model = args.backend
        cfg.rembg_model = args.backend
        cfg.generative_model = args.backend
    if args.aligned:
        cfg.trust_aligned_completion = True
    flags = args.flags or [f for f in REDWOOD_FLAGS if os.path.exists(
        os.path.join(args.data_dir, f"{f}.ply"))]

    from genpc_tpu_torch.parallel.batched_runner import run_batched
    start = time.time()
    results = run_batched(cfg, flags, args.data_dir, args.gt_dir,
                          with_emd=not args.no_emd)
    wall = time.time() - start
    if results:
        print("\n=== Results ===")
        summarize(results)
    print(f"\n{len(flags)} objects in {wall:.1f}s "
          f"({len(flags) / wall * 60:.2f} objects/min)")


if __name__ == "__main__":
    main()

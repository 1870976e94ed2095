"""Standalone metric evaluation CLI (counterpart of
genpc_tpu/metric_cli.py; reference: metric.py:173-196).

Scores the fused clouds of a workspace directory against GT on the card
(``--device cpu`` otherwise):
  python -m genpc_tpu_torch.metric_cli --workspace workspace \
      --gt-dir DATA/GT --flags 01184 05117 [--device cpu]

Both GT conventions are exposed: main.py compares unrotated, the
reference's metric.py rotates GT 180° about x (--rotate-gt).
"""

from __future__ import annotations

import argparse

from genpc_tpu_torch.categories import REDWOOD_FLAGS
from genpc_tpu_torch.metrics.metric import evaluate_workspace, summarize
from genpc_tpu_torch.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="genpc_tpu_torch metric "
                                             "evaluation")
    ap.add_argument("--workspace", default="workspace")
    ap.add_argument("--gt-dir", required=True)
    ap.add_argument("--flags", nargs="*", default=None)
    ap.add_argument("--generative-model", default="synthetic")
    ap.add_argument("--rotate-gt", action="store_true",
                    help="rotate GT 180 deg about x (reference metric.py:11-14)")
    ap.add_argument("--no-emd", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    results = {}
    for flag in args.flags or REDWOOD_FLAGS:
        m = evaluate_workspace(flag, args.workspace, args.gt_dir,
                               generative_model=args.generative_model,
                               rotate_gt_x180=args.rotate_gt,
                               with_emd=not args.no_emd, device=device)
        if m is not None:
            results[flag] = m
    if not results:
        print("no fused clouds found")
        return {}
    return summarize(results)


if __name__ == "__main__":
    main()

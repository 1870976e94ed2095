#!/usr/bin/env python3
"""Does the FLUX pass of chip_smoke.py (phase 8) repeat across processes?

    python3 flux_repeat.py --out A.npz
    python3 flux_repeat.py --out B.npz --compare A.npz

One run_batched pass on the registration path over the 13 seeded
synthetic objects with chip_smoke.FLUX (the FLUX inpainter paints stage
1's depths, FLUX.1-Depth-dev generates the images, int4 MMDiT and T5 in
both), recording each stage's output in order: every T5 / CLIP-L prompt
encoding, the painted depths, the generated images, the stage-2
completions, each registration step's result, the fusion's input clouds
and fused clouds, and the CD/EMD.  With --compare the recording is held
against another process's, stage by stage: the first stage that differs
is printed with its largest difference, and the exit code is 0 whether
or not they agree.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def record_pass(root: str) -> dict:
    """One FLUX pass; -> {stage key: array}, keys in pipeline order."""
    import torch
    import chip_smoke as cs
    from genpc_tpu_torch.categories import REDWOOD_FLAGS
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    from genpc_tpu_torch.parallel import batched_runner as br
    rec = {}

    def put(name, value):
        rec[f"{len(rec):03d}_{name}"] = np.asarray(value)

    enc = DiTDepthEdit.encode_flux

    def encode(self, prompts):
        ctx, pooled = enc(self, prompts)
        put("t5_context", ctx.float().cpu())
        put("clip_pooled", pooled.float().cpu())
        return ctx, pooled

    stage1, gen = br.batched_stage1, br._generate_images
    sa_batch = br.ScaleAdapter.scale_adapter_batch
    fuse = br.fuse_clouds_batched

    def rec_stage1(cfg, arts, viewpoints, core=None, dp=None):
        stage1(cfg, arts, viewpoints, core=core, dp=dp)
        put("raw_depths", np.stack([a.raw_depth for a in arts]))
        put("painted_depths", np.stack([a.depth for a in arts]))

    def rec_gen(cfg, dp, arts):
        gen(cfg, dp, arts)
        put("images", np.stack([a.image for a in arts]))

    def rec_stage2(self, arts):
        sa_batch(self, arts)
        for a in arts:
            put(f"completion_{a.flag}", a.complete_xyz)

    def rec_fuse(sources, targets, *a, **k):
        for i, (s, t) in enumerate(zip(sources, targets)):
            put(f"fusion_source_{i}", s)
            put(f"fusion_target_{i}", t)
        out = fuse(sources, targets, *a, **k)
        for i, (pts, _) in enumerate(out):
            put(f"fused_{i}", pts)
        return out

    def rec_step(name):
        fn = getattr(br, name)

        def call(*a, **k):
            out = fn(*a, **k)
            for o in (out if isinstance(out, tuple) else (out,)):
                put(name, o.cpu() if hasattr(o, "cpu") else o)
            return out
        return call

    cfg = load_config(device="cuda", **cs.FLUX)
    flags = list(REDWOOD_FLAGS)
    with cs.patched((DiTDepthEdit, "encode_flux", encode),
                    (br, "batched_stage1", rec_stage1),
                    (br, "_generate_images", rec_gen),
                    (br.ScaleAdapter, "scale_adapter_batch", rec_stage2),
                    (br, "fuse_clouds_batched", rec_fuse),
                    *[(br, n, rec_step(n)) for n in cs.REG_STEPS]):
        t0 = time.time()
        results = br.run_batched(cfg, flags, root)
        torch.cuda.synchronize()
        wall = time.time() - t0
    put("cd", [results[f]["cd"] for f in flags])
    put("emd", [results[f]["emd"] for f in flags])
    cds = rec[max(k for k in rec if k.endswith("_cd"))]
    print(f"flux pass: {wall:.3f} s, mean CD x100 {cds.mean() * 100:.4f}, "
          f"{len(rec)} recorded stage outputs", flush=True)
    return rec


def compare(a: dict, b: dict) -> None:
    """Print each recorded stage's agreement, in pipeline order, and the
    first that differs."""
    first = None
    for key in sorted(set(a) | set(b)):
        if key not in a or key not in b:
            print(f"  {key}: recorded in one process only")
            first = first or key
            continue
        x, y = a[key], b[key]
        if x.shape != y.shape:
            print(f"  {key}: shapes {x.shape} vs {y.shape}")
            first = first or key
            continue
        same = np.array_equal(x, y)
        gap = float(np.abs(x.astype(np.float64) - y).max()) if x.size else 0.0
        print(f"  {key} {x.shape}: bitwise equal {same}, max |d| {gap:.3e}")
        if not same and first is None:
            first = key
    print(f"first stage that differs across the two processes: {first}"
          if first else "the two processes agree at every recorded stage")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("flux_repeat.py needs a CUDA card", file=sys.stderr)
        return 1
    from genpc_tpu_torch import _kernels
    from genpc_tpu_torch.categories import REDWOOD_FLAGS
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    _kernels.build()
    _kernels.lib()
    with tempfile.TemporaryDirectory(prefix="flux_repeat_") as tmp:
        write_dataset(tmp, list(REDWOOD_FLAGS), seed=0)
        rec = record_pass(tmp)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **rec)
    if args.compare:
        other = dict(np.load(args.compare))
        compare(other, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())

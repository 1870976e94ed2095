"""End-to-end pipeline entry point (counterpart of genpc_tpu/main.py).

Runs the three stages over a set of object flags and evaluates CD/EMD
against GT.  By default one object at a time (``run_pipeline``: stage 1
per object, then stages 2-3 and the metric per object, a failed object
printed and skipped); ``--batched`` runs the object-batched runner
(``parallel/batched_runner.run_batched``).  Both register every
completion to its partial (pose optimisation, coarse and fine ICP
sweeps, final refine), the reference's headline path; ``--aligned``
(``trust_aligned_completion=True``) lets completions their backend
declares aligned skip registration.  Work runs on ``cfg.device``
(``--device``, the card by default), or over a device mesh (``--mesh``,
``cfg.mesh_shape``: ``dp`` splits the batched runner's objects, ``sp``
the per-object metric's chamfer).  With ``save`` set (the config
default) the workspace files are written under ``--output``.  The
generation backends are the synthetic ones unless ``--control-model``
asks for a depth generator (``controlnet`` or ``adapter``: SDXL;
``qwen``: Qwen-Image-Edit; ``flux``: FLUX.1-Depth-dev) or
``--generative-model instantmesh`` for the InstantMesh image-to-3D
backend (per object through ``ScaleAdapter.scale_adapter``, batched
through ``generate_meshes_batch`` in chunks of ``image23d_batch``), at
``--model-size tiny`` or ``full`` (the published widths), with seeded
random weights unless ``cfg.weights_dir`` holds the checkpoints.  The
DiT generators (``qwen``, ``flux``) quantise their MMDiT
(``--quant-bits``) and their prompt towers (``--tower-quant-bits``:
Qwen2.5-VL, or T5-XXL) to int4 at full size unless told 8 or 0 (bf16).
The FLUX inpainter of stage 1 is chosen in the config (``inpainter:
flux``), as in the reference.

Usage:
  python -m genpc_tpu_torch.main --config configs/redwood.yaml \
      --data-dir DATA --flags 01184 05117 [--batched] [--device cpu]
  python -m genpc_tpu_torch.main --data-dir DATA --batched \
      --control-model controlnet --model-size full
  python -m genpc_tpu_torch.main --data-dir DATA --batched \
      --generative-model instantmesh --model-size full
  python -m genpc_tpu_torch.main --data-dir DATA --batched \
      --control-model flux --model-size full [--quant-bits 8]
  python -m genpc_tpu_torch.main --data-dir DATA --mesh dp=4 \
      [--mesh-devices cuda:0,cuda:0,cuda:0,cuda:0]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict, List, Optional

from genpc_tpu_torch.categories import REDWOOD_FLAGS
from genpc_tpu_torch.config import Config, load_config
from genpc_tpu_torch.io.ply import load_xyz
from genpc_tpu_torch.metrics.frame_fixes import apply_frame_fix
from genpc_tpu_torch.metrics.metric import evaluate_pair, summarize
from genpc_tpu_torch.parallel.mesh import get_mesh
from genpc_tpu_torch.pipeline.artifacts import input_artifacts
from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting
from genpc_tpu_torch.pipeline.registration import reg
from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import recording, span, trace


def run_pipeline(cfg: Config, flags: List[str], data_dir: str,
                 gt_dir: Optional[str] = None, with_metric: bool = True,
                 with_emd: bool = True) -> Dict[str, Dict[str, float]]:
    """Per-object pipeline over flags; returns {flag: {'cd', 'emd'}} for
    the objects that finished and have a GT.  Spans (``tracing``): load,
    stage1, stage2, stage3, metric, one each an object."""
    mesh = get_mesh(cfg)
    device = resolve_device(cfg.device, mesh)
    gt_dir = gt_dir or os.path.join(data_dir, "GT")
    dp = DepthPrompting(cfg)
    sa = ScaleAdapter(cfg)

    n_in = int(cfg.get("input_points", 65536))
    arts = {}
    for flag in flags:
        print(f"Processing {flag}...")
        with span("load", sync=device):
            xyz, rgb = load_xyz(os.path.join(data_dir, f"{flag}.ply"))
            art = input_artifacts(flag, xyz, rgb, n_in)
        with span("stage1", sync=device):
            dp.get_image(art)
        arts[flag] = art

    results: Dict[str, Dict[str, float]] = {}
    for flag, art in arts.items():
        # per-object fault isolation: one bad scan must not end the run
        # (the reference's drivers print and continue)
        try:
            with span("stage2", sync=device):
                sa.scale_adapter(art)
            with span("stage3", sync=device):
                reg(cfg, art, cd_inv_weight=0.5, diff_init=True,
                    reg_fine_xyz=True)
        except Exception as e:  # noqa: BLE001
            print(f"Flag: {flag} FAILED: {type(e).__name__}: {e}")
            continue
        if with_metric:
            gt_path = os.path.join(gt_dir, f"{flag}.ply")
            if os.path.exists(gt_path):
                with span("metric", sync=device):
                    gt, _ = load_xyz(gt_path)
                    gt = apply_frame_fix(flag, gt)
                    m = evaluate_pair(art.fused_xyz, gt,
                                      num_points=int(cfg.metric_points),
                                      emd_eps=float(cfg.emd_eps),
                                      emd_iters=int(cfg.emd_iters),
                                      with_emd=with_emd, mesh=mesh,
                                      device=device)
                emd_txt = f", EMD: {m['emd']*100:.3f}" if "emd" in m else ""
                print(f"Flag: {flag}, CD: {m['cd']*100:.3f}{emd_txt}")
                results[flag] = m

    if with_metric and results:
        print("\n=== Results ===")
        summarize(results)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="genpc_tpu_torch pipeline")
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--gt-dir", default=None)
    ap.add_argument("--flags", nargs="*", default=None,
                    help="object flags (default: all redwood flags present)")
    ap.add_argument("--output", default=None, help="workspace dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="override all generative backends (synthetic)")
    ap.add_argument("--control-model", default=None,
                    help="depth->image backend")
    ap.add_argument("--rembg-model", default=None,
                    help="background removal backend")
    ap.add_argument("--generative-model", default=None,
                    help="image->3D backend")
    ap.add_argument("--model-size", default=None,
                    help="generative preset scale (tiny/base/full)")
    ap.add_argument("--quant-bits", type=int, default=None,
                    choices=(0, 4, 8),
                    help="weight-only quantization of the MMDiT of the DiT "
                         "depth->image backends (--control-model qwen or "
                         "flux): 4 (int4, the default at full size), 8 "
                         "(int8) or 0 (bf16, the default below full size)")
    ap.add_argument("--tower-quant-bits", type=int, default=None,
                    choices=(0, 4, 8),
                    help="the same for their prompt towers: Qwen2.5-VL "
                         "(qwen) or T5-XXL (flux); CLIP-L stays bf16")
    ap.add_argument("--aligned", action="store_true",
                    help="trust_aligned_completion: skip registration for "
                         "completions already in the input frame")
    ap.add_argument("--no-metric", action="store_true")
    ap.add_argument("--no-emd", action="store_true")
    ap.add_argument("--batched", action="store_true",
                    help="object-batched runner (each stage over the "
                         "whole set)")
    ap.add_argument("--mesh", default=None,
                    help="device mesh, e.g. dp=8 or sp=4: dp splits the "
                         "objects of the batched runner (and implies "
                         "--batched), sp the per-object metric's chamfer; "
                         "the mesh takes every CUDA device, or "
                         "--mesh-devices")
    ap.add_argument("--mesh-devices", default=None,
                    help="the mesh's devices in order, repeats allowed, "
                         "e.g. cuda:0,cuda:0,cuda:0,cuda:0")
    ap.add_argument("--timings", action="store_true",
                    help="record the spans (tracing) and print their "
                         "table")
    ap.add_argument("--profile", default=None,
                    help="torch.profiler trace dir (Chrome trace)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.device:
        cfg.device = args.device
    if args.output:
        cfg.output_path = args.output
    if args.backend:
        cfg.control_model = args.backend
        cfg.rembg_model = args.backend
        cfg.generative_model = args.backend
    if args.control_model:
        cfg.control_model = args.control_model
    if args.rembg_model:
        cfg.rembg_model = args.rembg_model
    if args.generative_model:
        cfg.generative_model = args.generative_model
    if args.model_size:
        cfg.model_size = args.model_size
    for key in ("quant_bits", "tower_quant_bits"):
        if getattr(args, key) is not None:
            if cfg.control_model not in ("qwen", "flux"):
                ap.error(f"--{key.replace('_', '-')} applies to the DiT "
                         f"depth->image backends (--control-model qwen or "
                         f"flux)")
            cfg[key] = getattr(args, key)
    if args.aligned:
        cfg.trust_aligned_completion = True
    if args.mesh:
        cfg.mesh_shape = {k: int(v) for k, v in
                          (kv.split("=") for kv in args.mesh.split(","))}
        args.batched = args.batched or "dp" in cfg.mesh_shape
    if args.mesh_devices:
        cfg.mesh_devices = args.mesh_devices.split(",")
    flags = args.flags or [f for f in REDWOOD_FLAGS if os.path.exists(
        os.path.join(args.data_dir, f"{f}.ply"))]

    timed = recording() if args.timings else contextlib.nullcontext()
    start = time.time()
    with trace(args.profile), timed as rec:
        if args.batched:
            from genpc_tpu_torch.parallel.batched_runner import run_batched
            results = run_batched(cfg, flags, args.data_dir, args.gt_dir,
                                  with_emd=not args.no_emd)
            if results:
                print("\n=== Results ===")
                summarize(results)
        else:
            run_pipeline(cfg, flags, args.data_dir, args.gt_dir,
                         with_metric=not args.no_metric,
                         with_emd=not args.no_emd)
    wall = time.time() - start
    if rec is not None:
        print()
        rec.report()
        # the counters (span:counter), among them the int4 layers' paths:
        # quant_w4 (kernel K6) and quant_w4_plain (its plain twin)
        for key, n in sorted(rec.flat().items()):
            if ":" in key:
                print(f"{key:<40}{n:10.0f}")
    print(f"\n{len(flags)} objects in {wall:.1f}s "
          f"({len(flags) / wall * 60:.2f} objects/min)")


if __name__ == "__main__":
    main()

"""Waymo LiDAR completion entry point (counterpart of
genpc_tpu/main_lidar.py).

Runs the per-object pipeline over ``data_dir/{CAR,PED,OTHER}`` scans
(``run_lidar``): stage 1 for every scan, then stages 2-3 per scan with
the reference's final settings (``cd_inv_weight=0.5``, ``diff_init``,
``reg_fine_xyz``).  ``--stage 1|2`` reproduces the reference's split
workflow: stage 1 saves its workspace files, and stage 2 resumes from
them.  LiDAR scans have no GT, so each object is scored by the
partial->completion UHD.  The object-batched variant with the held-out
wedge is ``parallel/batched_runner.run_batched_lidar``.  Work runs on
``cfg.device`` (the card by default).  No weights are loaded: the
ported backends are the synthetic ones.

Usage:
  python -m genpc_tpu_torch.main_lidar --config configs/lidar.yaml \
      --data-dir WAYMO --category CAR --limit 5
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np

from genpc_tpu_torch.config import load_config
from genpc_tpu_torch.io.ply import load_xyz
from genpc_tpu_torch.metrics.metric import uhd
from genpc_tpu_torch.parallel.mesh import get_mesh
from genpc_tpu_torch.pipeline.artifacts import Workspace, input_artifacts
from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting
from genpc_tpu_torch.pipeline.registration import reg
from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
from genpc_tpu_torch.runtime import resolve_device


def list_scans(data_dir: str, category: str, limit: Optional[int] = None
               ) -> List[str]:
    d = os.path.join(data_dir, category)
    flags = sorted(f[:-4] for f in os.listdir(d) if f.endswith(".ply"))
    return flags[:limit] if limit else flags


def run_lidar(cfg, flags: List[str], data_dir: str, category: str,
              stage: str = "all"):
    """Per-object LiDAR pipeline; returns {flag: UHD} of the objects that
    ran stages 2-3.  With cfg.mesh_shape the work runs on the mesh's
    first device."""
    device = resolve_device(cfg.device, get_mesh(cfg))
    n_in = int(cfg.get("input_points", 65536))
    ws = Workspace(cfg.output_path, cfg.generative_model)
    results = {}

    def scan(flag):
        xyz, rgb = load_xyz(os.path.join(data_dir, category, f"{flag}.ply"))
        return input_artifacts(flag, xyz, rgb, n_in)

    arts = {}
    if stage in ("all", "1"):
        dp = DepthPrompting(cfg)
        for flag in flags:
            print(f"[stage 1] {flag}")
            art = scan(flag)
            dp.get_image(art)
            arts[flag] = art

    if stage in ("all", "2"):
        sa = ScaleAdapter(cfg)
        for flag in flags:
            if flag not in arts:  # resume from the workspace (split run)
                arts[flag] = ws.load_stage1(flag, scan(flag))
            print(f"[stage 2+3] {flag}")
            art = arts[flag]
            sa.scale_adapter(art)
            # the reference's final loop (main_lidar.py:87-89)
            reg(cfg, art, cd_inv_weight=0.5, diff_init=True,
                reg_fine_xyz=True)
            h = uhd(art.xyz, art.fused_xyz, device=device)
            results[flag] = h
            print(f"  UHD x100: {h * 100:.3f}")

    if results:
        print(f"\nAverage UHD x100 over {len(results)}: "
              f"{np.mean(list(results.values())) * 100:.3f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="genpc_tpu_torch Waymo LiDAR pipeline")
    ap.add_argument("--config", default="configs/lidar.yaml")
    ap.add_argument("--data-dir", required=True,
                    help="directory holding CAR/, PED/ and OTHER/ scans")
    ap.add_argument("--category", default="CAR",
                    choices=["CAR", "PED", "OTHER"])
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--stage", default="all", choices=["all", "1", "2"])
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_config(args.config if os.path.exists(args.config) else None)
    if args.category == "PED" and args.config == "configs/lidar.yaml" \
            and os.path.exists("configs/lidar_ped.yaml"):
        cfg = load_config("configs/lidar_ped.yaml")
    if args.output:
        cfg.output_path = args.output
    if args.device:
        cfg.device = args.device
    flags = list_scans(args.data_dir, args.category, args.limit)
    print(f"{len(flags)} {args.category} scans")
    start = time.time()
    run_lidar(cfg, flags, args.data_dir, args.category, args.stage)
    wall = time.time() - start
    print(f"{len(flags)} scans in {wall:.1f}s "
          f"({len(flags) / max(wall, 1e-9) * 60:.2f} objects/min)")


if __name__ == "__main__":
    main()

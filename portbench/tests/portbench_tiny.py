"""Shared set-up of the benchmark's CPU tests: a tiny cell on the host.

The shapes are cut far below the cells' so that the port's plain paths
finish on the CPU (the symmetry sweep's 4,096-point sample is fixed, and
sets most of the time); ``host_k3`` makes the port's host EMD bid take
the form kernel K3 computes on the card (the port's own host form is the
matrix expansion, which rounds otherwise)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(view_num=16, downsample_num=256, res=64, cam_res=64,
            generate_res=64, input_points=512, inpaint_iters=10,
            glb_sample_points=512, fused_points=256, metric_points=256,
            pose_complete_points=64, icp_points=64, pose_iters=3,
            pose_render_size=32, fine_scale_steps=2)
SEED = 2 ** 31 + 11


def tiny_cell(name: str, objects: int = 2, checked: int = 1) -> dict:
    from portbench import harness
    cell = harness.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], objects=objects, gt_points=2048,
                           checked_objects=checked)
    return cell


def host_k3(monkeypatch) -> None:
    import genpc_tpu_torch.ops.emd_kernel as ek
    monkeypatch.setattr(ek, "bid_plain", ek.bid_plain_direct)


def run_tiny(name: str, tmp_path, **kw) -> dict:
    import torch
    from portbench import harness
    torch.set_num_threads(4)
    return harness.run_cell(tiny_cell(name, **kw), SEED, 0.0, trace=False,
                            device="cpu", overrides=TINY,
                            tmp_root=str(tmp_path))

"""Evaluation protocols: per-object CD/EMD, UHD, and suite drivers
(counterpart of genpc_tpu/metrics/metric.py).

  * ``evaluate_pair`` ≡ main.py:11-36 — FPS both clouds to 16384 (kernel
    K2, one object a launch), CD-ℓ1 = (mean√d1+mean√d2)/2 (K1) and
    auction EMD (K3; eps 0.005, iters 50).
  * ``uhd`` ≡ metric.py:105-132 — unidirectional Hausdorff distance
    (max, or a percentile, of the partial's NN distances into the
    completion; K1).
  * ``evaluate_workspace`` ≡ metric.py:10-48 — score a workspace's fused
    cloud against its GT, optionally with the GT turned 180° about x.
  * ``evaluate_mesh`` ≡ metric.py:49-94 — sample a predicted mesh's
    surface (io/glb), fit it into the GT's bounding box with the floors
    level, then ``evaluate_pair``.
  * ``summarize`` — the per-category print and averages of main.py.

Inputs are numpy; ``device`` is where the work runs (the card unless
the caller asks for the CPU).  With a device mesh that has an ``sp``
axis, ``evaluate_pair``'s chamfer splits both clouds' rows over it
(``parallel.mesh.sharded_chamfer_l1``); the EMD stays on ``device``, as
in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from genpc_tpu_torch.categories import get_category
from genpc_tpu_torch.geometry.transforms import get_rotate_matrix
from genpc_tpu_torch.io.glb import sample_mesh_surface
from genpc_tpu_torch.io.ply import load_ply
from genpc_tpu_torch.metrics.losses import CompletionLoss
from genpc_tpu_torch.ops.chamfer import nearest_neighbor
from genpc_tpu_torch.ops.fps import farthest_point_sample


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def evaluate_pair(pred: np.ndarray, gt: np.ndarray, num_points: int = 16384,
                  emd_eps: float = 0.005, emd_iters: int = 50,
                  with_emd: bool = True, mesh=None,
                  device: torch.device | str = "cuda") -> Dict[str, float]:
    """FPS both to num_points, return {'cd': ..., 'emd': ...} (raw scale).
    With a mesh that has an 'sp' axis the chamfer is the sp-sharded one
    (reference: metric.py:44-49)."""
    p, _ = farthest_point_sample(_t(pred, device), num_points)
    g, _ = farthest_point_sample(_t(gt, device), num_points)
    if mesh is not None and "sp" in mesh.axis_names:
        from genpc_tpu_torch.parallel.mesh import sharded_chamfer_l1
        out = {"cd": float(sharded_chamfer_l1(p, g, mesh))}
    else:
        out = {"cd": float(CompletionLoss("cd_l1").get_loss(p, g))}
    if with_emd:
        out["emd"] = float(CompletionLoss("emd", emd_eps=emd_eps,
                                          emd_iters=emd_iters).get_loss(p, g))
    return out


def uhd(partial: np.ndarray, completion: np.ndarray,
        percentile: float = 100.0,
        device: torch.device | str = "cuda") -> float:
    """Unidirectional Hausdorff distance partial -> completion
    (reference: metric.py:105-132, scipy cdist max-of-min)."""
    d2, _ = nearest_neighbor(_t(partial, device), _t(completion, device))
    d = np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))
    if percentile >= 100.0:
        return float(d.max())
    return float(np.percentile(d, percentile))


def evaluate_workspace(flag: str, workspace_root: str, gt_dir: str,
                       generative_model: str = "synthetic",
                       rotate_gt_x180: bool = False,
                       with_emd: bool = True,
                       device: torch.device | str = "cuda"
                       ) -> Optional[Dict[str, float]]:
    """Score workspace/{flag}/{flag}_fused.ply against gt_dir/{flag}.ply."""
    fused_path = os.path.join(workspace_root, flag, f"{flag}_fused.ply")
    gt_path = os.path.join(gt_dir, f"{flag}.ply")
    if not (os.path.exists(fused_path) and os.path.exists(gt_path)):
        return None
    pred, _ = load_ply(fused_path)
    gt, _ = load_ply(gt_path)
    if rotate_gt_x180:
        gt = gt @ get_rotate_matrix("x", 180).T
    return evaluate_pair(pred.astype(np.float32), gt.astype(np.float32),
                         with_emd=with_emd, device=device)


def evaluate_mesh(pred_mesh, gt_points: np.ndarray, num_points: int = 16384,
                  normalize_by_gt_bbox: bool = True,
                  with_emd: bool = False,
                  device: torch.device | str = "cuda") -> Dict[str, float]:
    """Mesh-vs-cloud evaluation (reference: metric.py:49-94
    metric_sds_redwood): sample the predicted mesh, optionally rescale it
    into the GT's bounding box (centre, longest side, then the floors
    level in y), then run ``evaluate_pair``."""
    pred, _ = sample_mesh_surface(pred_mesh, max(num_points * 2, 32768))
    gt = np.asarray(gt_points, np.float32)
    if normalize_by_gt_bbox:
        p, ref = pred.astype(np.float64), gt.astype(np.float64)
        p_c = (p.max(0) + p.min(0)) / 2
        r_c = (ref.max(0) + ref.min(0)) / 2
        scale = ((ref.max(0) - ref.min(0)).max()
                 / max((p.max(0) - p.min(0)).max(), 1e-9))
        pred = (p - p_c) * scale + r_c
        pred[:, 1] += ref[:, 1].min() - pred[:, 1].min()
    return evaluate_pair(pred.astype(np.float32), gt, num_points=num_points,
                         with_emd=with_emd, device=device)


def summarize(results: Dict[str, Dict[str, float]]) -> Dict[str, float]:
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

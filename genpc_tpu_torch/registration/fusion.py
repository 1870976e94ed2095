"""Cloud fusion: dedup, concat, FPS, denoise (counterpart of
genpc_tpu/registration/fusion.py; reference: reg_xyz.py:210-223).

  1. drop generated points whose squared NN distance to an input point is
     below the threshold (one launch of kernel K1),
  2. concatenate input + surviving generated points,
  3. FPS-downsample (kernel K2),
  4. statistical outlier removal (std_ratio 2.5).

Inputs and outputs are numpy; ``device`` is where the work runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from genpc_tpu_torch.ops.chamfer import nearest_neighbor
from genpc_tpu_torch.ops.fps import farthest_point_sample
from genpc_tpu_torch.ops.outliers import statistical_outlier_mask


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def remove_close_points(source_pts: np.ndarray, target_pts: np.ndarray,
                        target_colors: Optional[np.ndarray] = None,
                        distance_threshold: float = 1e-4,
                        device: torch.device | str = "cpu"
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Keep target points whose squared NN distance to source >= threshold."""
    d2, _ = nearest_neighbor(_t(target_pts, device), _t(source_pts, device))
    mask = d2.cpu().numpy() >= distance_threshold
    kept = np.asarray(target_pts)[mask]
    cols = None if target_colors is None else np.asarray(target_colors)[mask]
    return kept, cols


def fuse_clouds(source_pts: np.ndarray, target_pts: np.ndarray,
                source_colors: Optional[np.ndarray] = None,
                target_colors: Optional[np.ndarray] = None,
                num_points: int = 20000,
                distance_threshold: float = 1e-4,
                denoise_std_ratio: float = 2.5,
                device: torch.device | str = "cpu"
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Full fusion tail; returns (points, colors)."""
    kept, kept_cols = remove_close_points(source_pts, target_pts,
                                          target_colors, distance_threshold,
                                          device=device)
    pts = np.concatenate([np.asarray(source_pts), kept], axis=0)
    cols = None
    if source_colors is not None and kept_cols is not None:
        cols = np.concatenate([np.asarray(source_colors), kept_cols], axis=0)
    if len(pts) > num_points:
        _, idx = farthest_point_sample(_t(pts, device), num_points)
        idx = idx.cpu().numpy()
        pts = pts[idx]
        cols = None if cols is None else cols[idx]
    mask = statistical_outlier_mask(_t(pts, device), nb_neighbors=20,
                                    std_ratio=denoise_std_ratio)
    mask = mask.cpu().numpy()
    return pts[mask], None if cols is None else cols[mask]

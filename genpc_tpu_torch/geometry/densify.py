"""Point-cloud densification (counterpart of genpc_tpu/geometry/densify.py;
reference: utils/dataUtils.py:99-134).

``linear_interpolation`` adds the midpoint between each point and its
nearest neighbour (``ops/knn.knn`` on ``device``); ``random_add_points``
repeats it until a target count, then draws the target count.  Inputs
and outputs are numpy, and the draws are the reference's (numpy seed).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from genpc_tpu_torch.ops.knn import knn


def linear_interpolation(points: np.ndarray,
                         colors: Optional[np.ndarray] = None,
                         frac: float = 1.0, seed: int = 0,
                         device: torch.device | str = "cuda"
                         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Add midpoints toward nearest neighbours for a fraction of points."""
    pts = np.asarray(points, np.float32)
    p = torch.as_tensor(pts, device=device)
    nn = knn(p, p, 2)[1][:, 1].cpu().numpy()
    mid = (pts + pts[nn]) / 2.0
    mid_cols = None if colors is None else (
        np.asarray(colors) + np.asarray(colors)[nn]) / 2.0
    if frac < 1.0:
        rng = np.random.default_rng(seed)
        sel = rng.choice(len(pts), int(len(pts) * frac), replace=False)
        mid = mid[sel]
        mid_cols = None if mid_cols is None else mid_cols[sel]
    out = np.concatenate([pts, mid], axis=0)
    out_cols = None
    if colors is not None:
        out_cols = np.concatenate([np.asarray(colors), mid_cols], axis=0)
    return out, out_cols


def random_add_points(points: np.ndarray, target: int,
                      colors: Optional[np.ndarray] = None, seed: int = 0,
                      device: torch.device | str = "cuda"
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Densify by repeated interpolation until >= target, then trim."""
    pts, cols = np.asarray(points, np.float32), colors
    while len(pts) < target:
        pts, cols = linear_interpolation(pts, cols, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    if len(pts) > target:
        sel = rng.choice(len(pts), target, replace=False)
        pts = pts[sel]
        cols = None if cols is None else np.asarray(cols)[sel]
    return pts, cols

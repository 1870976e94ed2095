"""Voxel-grid downsampling (open3d ``voxel_down_sample`` equivalent;
counterpart of genpc_tpu/ops/voxel.py).

Points falling in the same voxel are averaged (coordinates and colours).
Host numpy: the output size depends on the data.  This is the
reference's portable numpy algorithm only: voxel indices binned in the
input's float type, voxels emitted in sorted-key order, sums in float64.
The reference's native C++ helper emits another order and bins in float64
(ROADMAP queue 3), so parity tests pin the reference to this algorithm.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def voxel_down_sample(points: np.ndarray, voxel_size: float,
                      colors: Optional[np.ndarray] = None,
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Average points (and colours) per occupied voxel; returns
    (points, colours), colours None when none were given."""
    points = np.asarray(points)
    if len(points) == 0:
        return points, colors
    min_bound = points.min(axis=0)
    idx = np.floor((points - min_bound) / voxel_size).astype(np.int64)
    # pack 3 voxel coords into one key (21 bits each covers 2M voxels/axis)
    key = (idx[:, 0] << 42) | (idx[:, 1] << 21) | idx[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    out = np.zeros((len(uniq), 3), dtype=np.float64)
    np.add.at(out, inv, points.astype(np.float64))
    out /= counts[:, None]
    out = out.astype(points.dtype)
    out_colors = None
    if colors is not None:
        out_colors = np.zeros((len(uniq), colors.shape[1]), dtype=np.float64)
        np.add.at(out_colors, inv, np.asarray(colors, np.float64))
        out_colors = (out_colors / counts[:, None]).astype(
            np.asarray(colors).dtype)
    return out, out_colors

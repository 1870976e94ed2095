"""Bounding-box normalisation (counterpart of genpc_tpu/geometry/normalize.py;
reference: utils/dataUtils.py:514-581).

``normalize_points(x, range=0.5)`` recentres to the bbox midpoint and
scales by the largest bbox extent, then multiplies by range/0.5: range=0.5
maps the largest extent to exactly 1.0 centred at 0 (reference:
reg_xyz.py:131).  Host numpy in float32, as the reference's result is.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def normalize_points(xyz, range: float = 1.0
                     ) -> Tuple[np.ndarray, np.ndarray, np.float32]:
    """Returns (normalized, center, scale_factor)."""
    pts = np.asarray(xyz, np.float32)
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    center = (hi + lo) / np.float32(2.0)
    scale_factor = (hi - lo).max()
    out = (pts - center) / np.maximum(scale_factor, np.float32(1e-12))
    out = out * np.float32(range / 0.5)
    return out, center, scale_factor

"""Typed in-memory stage artifacts (counterpart of
genpc_tpu/pipeline/artifacts.py).

Stages exchange one ``ObjectArtifacts`` record of host (numpy) arrays.
The reference's ``Workspace`` persistence (PNG/NPY/PLY/GLB per stage) is
not ported yet: the ported slice runs with ``save=False``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np


@dataclass
class ObjectArtifacts:
    flag: str
    xyz: Optional[np.ndarray] = None            # [N,3] partial input
    rgb: Optional[np.ndarray] = None            # [N,3]
    # Stage 1 (depth prompting)
    point_uv: Optional[np.ndarray] = None       # [N,2] in [0,1]
    viewpoint: Optional[np.ndarray] = None      # [3] selected eye
    raw_depth: Optional[np.ndarray] = None      # [3,res,res]
    depth: Optional[np.ndarray] = None          # [3,res,res] inpainted
    mask: Optional[np.ndarray] = None           # [3,res,res]
    image: Optional[np.ndarray] = None          # [H,W,3] generated RGB
    # Stage 2 (scale adapter)
    image_nobg: Optional[np.ndarray] = None     # [H,W,4] RGBA
    color_xyz: Optional[np.ndarray] = None      # colored partial cloud
    color_rgb: Optional[np.ndarray] = None
    complete_mesh: Optional[Any] = None         # image-to-3D mesh output
    complete_xyz: Optional[np.ndarray] = None   # or a raw complete cloud
    complete_rgb: Optional[np.ndarray] = None
    complete_aligned: bool = False   # backend declared input-frame output
    # Stage 3 (registration & fusion)
    fused_xyz: Optional[np.ndarray] = None
    fused_rgb: Optional[np.ndarray] = None

"""Per-object GT world-frame corrections.

The redwood GT plys ship pre-aligned to their partials — except 06830,
whose GT scores raw CD*100 ~292.  Round 3 investigated recovering the
presumed frame offset (VERDICT r2 #7) with multi-start global
registration; the conclusion (docs/06830_investigation.md, with the
evidence render) is that GT/06830.ply is a DIFFERENT OBJECT than the
tricycle partial — a dataset labeling error no transform can fix.  The
reference averages the garbage number anyway (main.py:63-78).

This module stays as the wiring for per-object GT fixes:
``configs/frame_fixes.json`` maps flag -> {"transform": 4x4 row-major}
and ``apply_frame_fix(flag, gt)`` applies it at GT load time (no-op for
flags without a transform, including 06830's documentation-only entry).
If a corrected GT ever ships, one JSON entry re-enables 13/13 quality
averaging with no code change.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional

import numpy as np

_FIXES_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "configs",
    "frame_fixes.json")


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    if not os.path.exists(_FIXES_PATH):
        return {}
    with open(_FIXES_PATH) as f:
        data = json.load(f)
    return {flag: np.asarray(entry["transform"], np.float64)
            for flag, entry in data.items() if "transform" in entry}


def get_frame_fix(flag: str) -> Optional[np.ndarray]:
    return _load().get(flag)


def apply_frame_fix(flag: str, gt: np.ndarray) -> np.ndarray:
    """Map a GT cloud into its partial's frame when a fix is recorded."""
    T = get_frame_fix(flag)
    if T is None:
        return gt
    return (np.asarray(gt, np.float64) @ T[:3, :3].T
            + T[:3, 3]).astype(np.float32)

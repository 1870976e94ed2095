"""Stage-3 helpers (counterpart of genpc_tpu/pipeline/registration.py).

Only ``resample_fixed`` is ported: the batched runner's stage 3 needs
it.  The per-object registration stage ``reg`` is not on
``run_batched``'s path and waits for ROADMAP queue 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resample_fixed(pts: np.ndarray, n: int,
                   cols: Optional[np.ndarray] = None, seed: int = 0
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Exact-size resampling.

    Growing keeps EVERY original point and pads with resampled duplicates
    (plain choice-with-replacement silently drops ~1/e of the unique
    points); shrinking is choice without replacement.
    """
    pts = np.asarray(pts)
    rng = np.random.default_rng(seed)
    if len(pts) == n:
        return pts, cols
    if len(pts) < n:
        idx = np.concatenate([np.arange(len(pts)),
                              rng.integers(0, len(pts), n - len(pts))])
    else:
        idx = rng.choice(len(pts), n, replace=False)
    return pts[idx], (None if cols is None else np.asarray(cols)[idx])

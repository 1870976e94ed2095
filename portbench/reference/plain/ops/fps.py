"""Farthest-point sampling (counterpart of genpc_tpu/ops/fps.py).

Deterministic start at point 0, as in the reference.  The work is done
by ``ops/fps_kernel.fps_batched`` (kernel K2 on CUDA, the plain loop on
the CPU).  ``pad_repeat`` lets clouds of different sizes share one
batched launch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from portbench.reference.plain.ops.fps_kernel import fps_batched


def fps_indices(points: torch.Tensor, k: int, start: int = 0) -> torch.Tensor:
    """Indices [k] int32 of k farthest points of points [N,3]."""
    return fps_batched(points[None], k, start=start)[0]


def farthest_point_sample(points: torch.Tensor, k: int, start: int = 0):
    """(sampled points [k,3], indices [k]); all points when k >= N."""
    n = points.shape[0]
    if k >= n:
        return points, torch.arange(n, dtype=torch.int32,
                                    device=points.device)
    idx = fps_indices(points, k, start)
    return points[idx.long()], idx


def pad_repeat(clouds: Sequence[np.ndarray]) -> np.ndarray:
    """Stack clouds [n_i,3] into [B,max n_i,3], each padded by repeating
    its own points from the start.

    FPS picks the same sequence from a padded cloud as from the cloud
    alone: a copy sits at a higher index than its original, so the
    lowest-index tie-break takes the original first, and once the
    original is chosen the copy's distance is 0, which wins only when
    every distance is 0, and then index 0 wins in both."""
    n = max(len(c) for c in clouds)
    return np.stack([np.concatenate(
        [c, np.tile(c, (-(-n // len(c)) - 1, 1))[: n - len(c)]])
        for c in clouds])

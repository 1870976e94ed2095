"""Farthest-point sampling (counterpart of genpc_tpu/ops/fps.py).

Deterministic start at point 0, as in the reference.  The work is done
by ``ops/fps_kernel.fps_batched`` (kernel K2 on CUDA, the plain loop on
the CPU).
"""

from __future__ import annotations

import torch

from genpc_tpu_torch.ops.fps_kernel import fps_batched


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

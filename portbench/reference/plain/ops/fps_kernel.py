"""Batched exact farthest-point sampling: kernel K2 and its plain twin.

Counterpart of genpc_tpu/ops/fps_kernel.py.  ``fps_batched`` dispatches
by device: a CPU tensor takes ``fps_batched_plain`` (the reference's
``_fps_indices_xla`` loop in torch, over the batch at once), a CUDA
tensor launches csrc/fps.cu, which replaces the Pallas ``_kernel``: one
object per thread-block cluster, its points on-chip (see the note there
for what bounds it and why it is shaped as it is).  ``fps_plan`` says how
an object of N points is spread over its cluster.

Both pick the start index first, then k-1 times the point whose minimum
squared distance to the chosen set is largest, lowest index on ties.
Any N is supported; k may exceed N (further picks are index 0).
"""

from __future__ import annotations

import torch


def fps_batched_plain(pts: torch.Tensor, k: int,
                      start: int = 0) -> torch.Tensor:
    """[B,N,3] -> [B,k] int32, the plain version of K2."""
    p = pts.to(torch.float32)
    b, n, _ = p.shape
    rows = torch.arange(b, device=p.device)
    min_d = torch.full((b, n), float("inf"), dtype=torch.float32,
                       device=p.device)
    out = torch.zeros((b, k), dtype=torch.int64, device=p.device)
    out[:, 0] = start
    last = torch.full((b,), start, dtype=torch.int64, device=p.device)
    for i in range(1, k):
        s = p[rows, last]                                   # [B,3]
        d = (p[..., 0] - s[:, None, 0]).square_()
        d += (p[..., 1] - s[:, None, 1]).square_()
        d += (p[..., 2] - s[:, None, 2]).square_()
        torch.minimum(min_d, d, out=min_d)
        last = torch.argmax(min_d, dim=1)
        out[:, i] = last
    return out.to(torch.int32)


def fps_batched(pts: torch.Tensor, k: int, start: int = 0) -> torch.Tensor:
    """Exact FPS indices for a batch: pts [B,N,3] -> [B,k] int32.

    On the card each object runs on a cluster of ``fps_plan(N)`` blocks;
    raises when that cluster cannot be scheduled."""
    pts = pts.to(torch.float32).contiguous()
    b, n, _ = pts.shape
    if n == 0 or k < 1 or not 0 <= start < n or n >= 1 << 27:
        raise ValueError(f"fps: N={n}, k={k}, start={start}")
    return fps_batched_plain(pts, k, start)

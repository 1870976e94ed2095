"""Sums and small matrix products whose order, for each output, does not
depend on how many outputs one call computes.

On the card, torch's reduction kernel picks its block shape, and whether
it splits an output's inputs over several blocks, from the whole
tensor's shape (ATen/native/cuda/Reduce.cuh, ``setReduceConfig``).  A sum
over a leading axis, or over the last axis of fewer than 16 rows, then
adds an output's values in another order when the batch grows.  The
registration steps batch objects, so an object's pose and ICP results
would move with the objects beside it (a dp shard against the whole
batch, ``parallel/mesh.py``), and registration amplifies a rounding
difference through its voxel binning into another result.

On a CUDA tensor every sum here runs over the last, contiguous axis of a
[rows, M] tensor with at least ``ROWS`` rows and M a multiple of 4 (zero
rows and zeros appended; adding zeros changes no sum).  For such a
tensor the kernel's block is 32 × 16 lanes whatever the row count, and it
splits no row over blocks below 2^17 elements a row, so each row is
summed in one order.  ``matmul`` forms the products and sums them the
same way, in place of a batched GEMM whose kernel choice may depend on
the batch.  On the CPU each function is the plain torch call: its
reductions sum each output alone already.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

#: the least row count at which the card's reduction block shape stops
#: depending on the row count
ROWS = 16


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """x [..., M] -> [...]: the sum over the last axis."""
    if not _on_card(x):
        return x.sum(-1)
    lead, m = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, m)
    r = rows.shape[0]
    pad_m, pad_r = (-m) % 4, max(0, ROWS - r)
    if pad_m or pad_r:
        rows = F.pad(rows, (0, pad_m, 0, pad_r))
    return rows.contiguous().sum(1)[:r].reshape(lead)


def _to_last(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """x with ``dims`` moved to the end and flattened into one axis."""
    dims = [d % x.ndim for d in dims]
    moved = x.movedim(dims, list(range(x.ndim - len(dims), x.ndim)))
    return moved.reshape(moved.shape[:x.ndim - len(dims)] + (-1,))


def _keep(y: torch.Tensor, x: torch.Tensor, dims: Sequence[int]
          ) -> torch.Tensor:
    for d in sorted(d % x.ndim for d in dims):
        y = y.unsqueeze(d)
    return y


def sum_dims(x: torch.Tensor, dims: Sequence[int],
             keepdim: bool = False) -> torch.Tensor:
    """``x.sum(dims, keepdim)``."""
    if not _on_card(x):
        return x.sum(tuple(dims), keepdim=keepdim)
    y = sum_last(_to_last(x, dims))
    return _keep(y, x, dims) if keepdim else y


def mean_dims(x: torch.Tensor, dims: Sequence[int],
              keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims, keepdim)``."""
    if not _on_card(x):
        return x.mean(tuple(dims), keepdim=keepdim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return sum_dims(x, dims, keepdim) / n


def std_dims(x: torch.Tensor, dims: Sequence[int],
             keepdim: bool = False) -> torch.Tensor:
    """``x.std(dims, keepdim, correction=0)``; on the card in the two-pass
    form (the mean, then the mean square deviation)."""
    if not _on_card(x):
        return x.std(dim=tuple(dims), keepdim=keepdim, correction=0)
    dev = x - mean_dims(x, dims, keepdim=True)
    return torch.sqrt(mean_dims(dev.square(), dims, keepdim))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., n, k] @ b [..., k, m] -> [..., n, m]; on the card the
    products summed by ``sum_last`` (for the small k, n and m of the
    registration steps)."""
    if not _on_card(a):
        return a @ b
    return sum_last(a[..., :, None, :]
                    * b.transpose(-1, -2)[..., None, :, :])

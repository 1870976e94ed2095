"""Approximate Earth Mover's Distance via the auction algorithm.

Counterpart of genpc_tpu/ops/emd.py (Bertsekas auction, as in the
reference CUDA extension ``emd_cuda.cu``).  Per iteration every source
row bids (``ops/emd_kernel.bid``: kernel K3 on CUDA, its threads taking
the rows in one spatial order computed once), then the assign
phase, in plain torch scatters, lets each target keep its highest bid:
  * GetMax: per-target max increment (``scatter_reduce_`` "amax");
  * winners are the unassigned bidders within 1e-6 of that max, and the
    highest row index among them takes the target;
  * the previous holder is evicted, the price rises by the increment;
  * on the last iteration every remaining bidder is force-assigned.
Index ``n`` of a length-``n+1`` buffer takes the writes that the
reference drops with its pad-and-slice trick.

Inputs [B,N,3] with equal N; returns (squared_dists [B,N], assignment
[B,N] int32).  The gradient flows to xyz1 only (emd_cuda.cu:284-316).
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.plain.ops.emd_kernel import bid as bid_phase
from portbench.reference.plain.ops.emd_kernel import spatial_order

_NEG = -1e30


def _assign_phase(bid, inc, is_last: bool, assignment, assignment_inv,
                  price):
    """GetMax/Assign phases over a batch: every argument [B,n]."""
    b, n = bid.shape
    dev = bid.device
    bid = bid.long()
    rows = torch.arange(n, device=dev).expand(b, n)
    unass = assignment == -1
    inc_masked = torch.where(unass, inc, torch.full_like(inc, _NEG))

    max_inc = torch.full((b, n), _NEG, dtype=torch.float32, device=dev)
    max_inc.scatter_reduce_(1, bid, inc_masked, "amax", include_self=True)
    is_winner = unass & (inc_masked >= max_inc.gather(1, bid) - 1e-6)
    # deterministic tie-break: highest row index wins
    win_row = torch.full((b, n), -1, dtype=torch.int64, device=dev)
    win_row.scatter_reduce_(1, bid, torch.where(is_winner, rows, -1),
                            "amax", include_self=True)
    wins = unass & (win_row.gather(1, bid) == rows) if not is_last else unass

    pad = torch.full((b, 1), -1, dtype=assignment.dtype, device=dev)
    if not is_last:
        # evict the previous holders of the won targets
        evictee = torch.where(wins, assignment_inv.gather(1, bid).long(), -1)
        safe_evictee = torch.where(evictee >= 0, evictee, n)
        assignment = torch.cat([assignment, pad], 1).scatter_(
            1, safe_evictee, -1)[:, :n]
    safe_bid = torch.where(wins, bid, n)
    assignment_inv = torch.cat([assignment_inv, pad], 1).scatter_(
        1, safe_bid, rows.to(assignment_inv.dtype))[:, :n]
    assignment = torch.where(wins, bid.to(assignment.dtype), assignment)
    price = torch.cat([price, torch.zeros_like(price[:, :1])], 1) \
        .scatter_add_(1, safe_bid, torch.where(wins, inc, 0.0))[:, :n]
    return assignment, assignment_inv, price


def _emd_batched(x1: torch.Tensor, x2: torch.Tensor, eps: float,
                 iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, n = x1.shape[0], x1.shape[1]
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    assignment = torch.full((b, n), -1, dtype=torch.int32, device=x1.device)
    assignment_inv = torch.full_like(assignment, -1)
    price = torch.zeros((b, n), dtype=torch.float32, device=x1.device)
    # the sources are the same in every bid: on the card, one spatial
    # order of them serves all (it changes no output)
    order = spatial_order(x1) if x1.is_cuda else None
    for i in range(iters):
        bid, best, better = bid_phase(x1, x2, price, order=order)
        inc = best - better + eps
        assignment, assignment_inv, price = _assign_phase(
            bid, inc, i == iters - 1, assignment, assignment_inv, price)
    matched = torch.gather(x2, 1, assignment.clamp_min(0).long()[..., None]
                           .expand(-1, -1, 3))
    dist = ((x1 - matched) ** 2).sum(-1)
    return dist, assignment


class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, eps, iters):
        dist, assignment = _emd_batched(x1, x2, eps, iters)
        ctx.save_for_backward(x1, x2, assignment)
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g, _ga):
        x1, x2, assignment = ctx.saved_tensors
        matched = torch.gather(x2.to(torch.float32), 1,
                               assignment.clamp_min(0).long()[..., None]
                               .expand(-1, -1, 3))
        # reference emd_cuda.cu:284-300: grad wrt xyz1 only
        gx1 = 2.0 * g[..., None] * (x1.to(torch.float32) - matched)
        return gx1, torch.zeros_like(x2), None, None


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Auction EMD. xyz1/xyz2: [B,N,3] or [N,3]; returns (sq_dists, assignment)."""
    squeeze = xyz1.ndim == 2
    x1, x2 = (xyz1[None], xyz2[None]) if squeeze else (xyz1, xyz2)
    if x1.shape[1] != x2.shape[1]:
        raise ValueError("EMD requires equally sized point clouds")
    dist, assignment = _EMD.apply(x1, x2, float(eps), int(iters))
    if squeeze:
        return dist[0], assignment[0]
    return dist, assignment

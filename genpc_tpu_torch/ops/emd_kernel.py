"""Auction-EMD bid phase: kernel K3 and its plain twin.

Counterpart of genpc_tpu/ops/emd_kernel.py (and of ``_bid_phase`` in
genpc_tpu/ops/emd.py).  ``bid`` dispatches by device: a CPU tensor takes
``bid_plain``, which mirrors the reference's row-tiled ``_bid_phase``
(|x|²+|y|²−2x·y expansion, first-index argmax, second best with only the
argmax column masked); a CUDA tensor launches csrc/emd_bid.cu, which
replaces the Pallas ``_bid_kernel`` (see the note there).

x1 [B,n,3], x2 [B,m,3], price [B,m] -> (bid [B,n] int32, best [B,n],
better [B,n]) with v = 3 − ‖x−y‖ − price.
"""

from __future__ import annotations

import torch

from genpc_tpu_torch import _kernels

_TX = 1024  # source rows per plain-path tile (the reference's tile)


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|² over the last axis rounded as XLA's CPU backend rounds it,
    fma(z, z, fma(y, y, x·x)): float64 holds each product exactly, so each
    emulated FMA rounds once to float32."""
    d = p.double()
    acc = (p[..., 0] * p[..., 0]).double()
    acc = (d[..., 1] * d[..., 1] + acc).float().double()
    return (d[..., 2] * d[..., 2] + acc).float()


def bid_plain(x1: torch.Tensor, x2: torch.Tensor, price: torch.Tensor):
    """Plain version of K3: the reference ``_bid_phase``, batched.

    The squared norms take the reference CPU path's FMA rounding and the
    square root is taken in float64 (torch's vectorised float32 sqrt on
    the CPU is not always correctly rounded), so on the CPU the bids and
    values equal the reference's bit for bit."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    bid = torch.empty((b, n), dtype=torch.int32, device=x1.device)
    best = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    better = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    y2 = _sq_norm(x2)                                        # [B,m]
    for r0 in range(0, n, _TX):
        xt = x1[:, r0:r0 + _TX]
        x2sum = _sq_norm(xt)
        cross = torch.bmm(xt, x2.transpose(1, 2))            # [B,T,m]
        d2 = x2sum[..., None] + y2[:, None, :] - 2.0 * cross
        dist = torch.sqrt(torch.clamp_min(d2, 0.0).double()).float()
        v = 3.0 - dist - price[:, None, :]
        bv, bj = v.max(dim=2)
        v.scatter_(2, bj[..., None], float("-inf"))
        bid[:, r0:r0 + _TX] = bj.to(torch.int32)
        best[:, r0:r0 + _TX] = bv
        better[:, r0:r0 + _TX] = v.amax(dim=2)
    return bid, best, better


def bid(x1: torch.Tensor, x2: torch.Tensor, price: torch.Tensor):
    """Batched bid phase (CPU: plain version; CUDA: kernel K3)."""
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    price = price.to(torch.float32).contiguous()
    if x2.shape[1] == 0:
        raise ValueError("bid phase over zero targets")
    if x1.device.type == "cpu":
        return bid_plain(x1, x2, price)
    _kernels.require_cuda("emd_bid", x1, x2, price)
    b, n, _ = x1.shape
    m = x2.shape[1]
    if b > 65535:
        raise ValueError(f"emd_bid: batch {b} > 65535")
    out_bid = torch.empty((b, n), dtype=torch.int32, device=x1.device)
    best = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    better = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        rc = _kernels.lib().genpc_emd_bid(
            x1.data_ptr(), x2.data_ptr(), price.data_ptr(),
            out_bid.data_ptr(), best.data_ptr(), better.data_ptr(),
            b, n, m, _kernels.stream(x1))
    _kernels.check(rc, "genpc_emd_bid")
    bid.launches += 1
    return out_bid, best, better


bid.launches = 0

"""Auction-EMD bid phase: kernel K3 and its plain twin.

Counterpart of genpc_tpu/ops/emd_kernel.py (and of ``_bid_phase`` in
genpc_tpu/ops/emd.py).  ``bid`` dispatches by device: a CPU tensor takes
``bid_plain``, which mirrors the reference's row-tiled ``_bid_phase``
(|x|²+|y|²−2x·y expansion, first-index argmax, second best with only the
argmax column masked); a CUDA tensor launches csrc/emd_bid.cu, which
replaces the Pallas ``_bid_kernel`` (see the note there) with the plan
``bid_plan``.  ``bid_plain_direct`` is the plain form of the function the
kernel computes (the Pallas kernel's direct distance, fp32 in the
kernel's order): the kernel is bitwise equal to it, and held to
``bid_plain`` by the reference's contract (>= 99.5 % identical bids,
values within 2e-4).

x1 [B,n,3], x2 [B,m,3], price [B,m] -> (bid [B,n] int32, best [B,n],
better [B,n]) with v = 3 − ‖x−y‖ − price.
"""

from __future__ import annotations

import torch

from genpc_tpu_torch import _kernels
from genpc_tpu_torch.ops.chamfer import SMS, THREADS, _GRID_X, _sq_dist

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


def bid_plain_direct(x1: torch.Tensor, x2: torch.Tensor,
                     price: torch.Tensor):
    """Plain form of the function K3 computes: v = (3 − sqrt(max(d2, 0)))
    − price with d2 = (dx² + dy²) + dz² in fp32, the first-index argmax,
    and the second best with only the argmax column excluded.  The root
    is taken in float64 and rounded to float32, which is the correctly
    rounded float32 root on every device; every other step is one fp32
    operation, as in the kernel."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    bid = torch.empty((b, n), dtype=torch.int32, device=x1.device)
    best = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    better = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    cols = torch.arange(m, device=x1.device)
    for r0 in range(0, n, _TX):
        d2 = _sq_dist(x1[:, r0:r0 + _TX], x2)                 # [B,T,m]
        dist = torch.sqrt(torch.clamp_min(d2, 0.0).double()).float()
        v = (3.0 - dist) - price[:, None, :]
        bv = v.amax(dim=2)
        bj = torch.where(v == bv[..., None], cols, m).amin(dim=2)
        v.scatter_(2, bj[..., None], float("-inf"))
        bid[:, r0:r0 + _TX] = bj.to(torch.int32)
        best[:, r0:r0 + _TX] = bv
        better[:, r0:r0 + _TX] = v.amax(dim=2)
    return bid, best, better


#: rows a thread and columns a scan step of csrc/emd_bid.cu, the one shape
#: it is built for (4 rows and 8-column groups, with more registers and
#: so fewer warps an SM, measured slower: PERF.md)
BID_ROWS, BID_GROUP = 2, 4


def bid_plan(b: int, n: int, m: int, threads: int | None = None) -> dict:
    """How K3 covers x1 [b,n,3] on the card: a block of ``threads``
    threads owns BID_ROWS * threads consecutive source rows of one batch
    (thread t the rows t + r * threads) and scans all m targets, BID_GROUP
    columns a step; the grid is linear, blocks = b * tiles.  Unless
    given, threads starts at THREADS and halves (down to one warp) while
    the launch has fewer blocks than the card has SMs."""
    if b < 1 or n < 1 or m < 1:
        raise ValueError(f"bid_plan: B={b}, n={n}, m={m}")

    def tiles(t):
        return -(-n // (t * BID_ROWS))

    t = threads or THREADS
    while threads is None and t > 32 and b * tiles(t) < SMS:
        t //= 2
    if t % 32 or not 32 <= t <= 256:
        raise ValueError(f"bid_plan: threads {t}")
    blocks = b * tiles(t)
    if blocks > _GRID_X:
        raise ValueError(f"bid_plan: {blocks} blocks exceed grid.x")
    return {"rows": BID_ROWS, "group": BID_GROUP, "threads": t,
            "tiles": tiles(t), "blocks": blocks}


def spatial_order(x: torch.Tensor) -> torch.Tensor:
    """[B,n,3] -> [B,n] int32: each batch's rows sorted along a Morton
    (Z-order) curve of 10 bits an axis over the batch's bounding box, so
    that rows close in the order are close in space."""
    lo = x.amin(1, keepdim=True)
    span = (x.amax(1, keepdim=True) - lo).clamp_min(1e-12)
    q = ((x - lo) / span * 1023).long().clamp_(0, 1023)
    code = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    for axis in range(3):
        v = q[..., axis]
        for bit in range(10):
            code |= ((v >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code, dim=1).to(torch.int32)


def bid(x1: torch.Tensor, x2: torch.Tensor, price: torch.Tensor,
        order: torch.Tensor | None = None):
    """Batched bid phase (CPU: ``bid_plain``; CUDA: kernel K3 with
    ``bid_plan(B, n, m)``).  ``order`` (int32 [B,n], a permutation of each
    batch's rows, e.g. ``spatial_order(x1)``) is the order in which the
    kernel's threads take the rows; it changes no output, only how alike
    the rows of a warp are."""
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    price = price.to(torch.float32).contiguous()
    if x2.shape[1] == 0:
        raise ValueError("bid phase over zero targets")
    if x1.device.type == "cpu":
        return bid_plain(x1, x2, price)
    _kernels.require_cuda("emd_bid", x1, x2, price,
                          *(() if order is None else (order,)))
    b, n, _ = x1.shape
    if order is not None and order.shape != (b, n):
        raise ValueError(f"emd_bid: order {tuple(order.shape)} for rows "
                         f"{(b, n)}")
    return _launch(x1, x2, price, order, bid_plan(b, n, x2.shape[1]))


def _launch(x1: torch.Tensor, x2: torch.Tensor, price: torch.Tensor,
            order: torch.Tensor | None, plan: dict):
    """Launch K3 on contiguous CUDA tensors with the given plan (``bid``
    passes ``bid_plan``; tests and the smoke run force other block
    sizes)."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    out_bid = torch.empty((b, n), dtype=torch.int32, device=x1.device)
    best = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    better = torch.empty((b, n), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device), _kernels.traced(bid, (b, n, m)):
        rc = _kernels.lib().genpc_emd_bid(
            x1.data_ptr(), x2.data_ptr(), price.data_ptr(),
            _kernels.ptr(order), out_bid.data_ptr(), best.data_ptr(),
            better.data_ptr(), b, n, m, plan["rows"], plan["group"],
            plan["threads"], _kernels.stream(x1))
    _kernels.check(rc, "genpc_emd_bid")
    return out_bid, best, better


bid.launches = 0
bid.trace = None

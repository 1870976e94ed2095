"""Bidirectional nearest-neighbour (Chamfer) search.

Counterpart of genpc_tpu/ops/chamfer.py.  ``_nn`` dispatches by device:
a CPU tensor takes ``_nn_plain`` (row-tiled torch), a CUDA tensor
launches the hand-written kernel K1 (csrc/chamfer_nn.cu, which replaces
the Pallas ``_nn_kernel``; see the note there).  Both compute the direct
fp32 form (dx*dx + dy*dy) + dz*dz, as the reference's CPU path
``_nn_xla`` does, with the first index winning ties.  ``nn_plan`` says
how a launch covers x and y on the card (rows a thread, block size, M
splits merged by a second small kernel).

``chamfer_nn`` is a ``torch.autograd.Function`` (the reference's
``custom_vjp``); its backward is the reference's gather + scatter-add
gradient in plain torch, with the scatter-add done by ``segment_sum``: a
stable sort by target and a segmented scan, so the sum is taken in a
fixed order without float atomics and the gradient repeats bitwise on
the card.  ``nn_one_sided`` is the one-direction variant (only d1 is
computed) with the same gradient; the pose loss uses it.

Shapes: x [B,N,3], y [B,M,3] -> (d1 [B,N], d2 [B,M], idx1 [B,N] int32,
idx2 [B,M] int32), d = squared L2.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from genpc_tpu_torch import _kernels

_TILE_ELEMS = 1 << 22   # pair distances per plain-path tile

#: launch plans of csrc/chamfer_nn.cu (K1) and csrc/emd_bid.cu (K3):
#: threads a block; K1's rows a thread (the kernel takes 2 or 4): 2 below
#: SMALL_ROWS x rows a launch (the pose loss's), else 4; the SMs of an
#: H100; the blocks a K1 launch should reach before it stops splitting M
#: (eight 4-warp blocks a SM); the fewest columns an M split keeps; the
#: fewest pairs a launch must hold to be split at all (below, the merge's
#: second launch costs more than the split gains)
THREADS = 128
SMALL_ROWS = 1 << 17
SMS = 132
TARGET_BLOCKS = 8 * SMS
MIN_SPLIT_COLS = 512
MIN_SPLIT_PAIRS = 1 << 28
_GRID_X = (1 << 31) - 1  # CUDA grid.x limit


def _sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [..., T, 3], y [..., M, 3] -> [..., T, M], (dx²+dy²)+dz²."""
    d = (x[..., :, None, 0] - y[..., None, :, 0]).square_()
    d += (x[..., :, None, 1] - y[..., None, :, 1]).square_()
    d += (x[..., :, None, 2] - y[..., None, :, 2]).square_()
    return d


def _nn_plain(x: torch.Tensor, y: torch.Tensor,
              y_index: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-tiled plain version of K1 (same arguments as ``_nn``)."""
    b, n, _ = x.shape
    m = y.shape[1]
    dist = torch.empty((b, n), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    rows = max(1, min(n, _TILE_ELEMS // max(m, 1)))
    objs = max(1, min(b, _TILE_ELEMS // max(m * rows, 1)))
    for b0 in range(0, b, objs):
        b1 = min(b, b0 + objs)
        yb = y[b0:b1] if y_index is None else y[y_index[b0:b1].long()]
        for r0 in range(0, n, rows):
            d = _sq_dist(x[b0:b1, r0:r0 + rows], yb)
            v, i = d.min(dim=2)
            dist[b0:b1, r0:r0 + rows] = v
            idx[b0:b1, r0:r0 + rows] = i.to(torch.int32)
    return dist, idx


def nn_plan(b: int, n: int, m: int, rows: int | None = None,
            threads: int | None = None, splits: int | None = None) -> dict:
    """How K1 covers x [b,n,3] against y [.,m,3] on the card.

    A block of ``threads`` threads owns ``rows * threads`` consecutive x
    rows of one batch (thread t the rows t + r * threads, r < rows) and
    the y columns of one split: split s covers [s * chunk, min(m, (s + 1)
    * chunk)).  The grid is linear, blocks = b * splits * tiles with the
    row tile fastest.  Unless given, rows is 2 for launches of fewer than
    SMALL_ROWS x rows and 4 otherwise; threads is THREADS, halved (down to
    64) while the launch has fewer blocks than the card has SMs; and a
    launch of at least MIN_SPLIT_PAIRS pairs has M split in halves (each
    split at least MIN_SPLIT_COLS columns) until it reaches
    TARGET_BLOCKS.  Launches of few rows (a one-cloud dedup, the metric's
    13 x 16,384, the coarse ICP) then still fill the 132 SMs with enough
    warps to hide the scan's latencies."""
    if b < 1 or n < 1 or m < 1:
        raise ValueError(f"nn_plan: B={b}, N={n}, M={m}")
    rows = rows or (2 if b * n < SMALL_ROWS else 4)
    t = threads or THREADS
    while threads is None and t > 64 and b * -(-n // (t * rows)) < SMS:
        t //= 2
    threads = t
    if rows not in (2, 4) or threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"nn_plan: rows {rows}, threads {threads}")
    tiles = -(-n // (threads * rows))
    s = splits or 1
    while splits is None and b * n * m >= MIN_SPLIT_PAIRS and \
            b * tiles * s < TARGET_BLOCKS and m // (2 * s) >= MIN_SPLIT_COLS:
        s *= 2
    tile_pts = 2 * threads                # y points a shared tile holds
    chunk = -(-(-(-m // s)) // tile_pts) * tile_pts
    s = -(-m // chunk)                    # no empty split
    blocks = b * s * tiles
    if blocks > _GRID_X:
        raise ValueError(f"nn_plan: {blocks} blocks exceed grid.x")
    return {"rows": rows, "threads": threads, "tiles": tiles, "splits": s,
            "chunk": chunk, "blocks": blocks}


def _nn(x: torch.Tensor, y: torch.Tensor,
        y_index: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each x row, (min squared distance, argmin) into y.

    x [B,N,3] fp32; y [By,M,3] fp32; y_index (optional int32 [B]) names
    the y batch each x batch searches (default: the same batch).  CPU
    tensors take the plain version; CUDA tensors launch K1 with
    ``nn_plan(B, N, M)``: one launch per call, plus the merge of the M
    splits when the plan splits (counted once, in ``_nn.launches``)."""
    x = x.to(torch.float32).contiguous()
    y = y.to(torch.float32).contiguous()
    if y.shape[1] == 0:
        raise ValueError("nearest neighbour into an empty cloud")
    if x.device.type == "cpu":
        return _nn_plain(x, y, y_index)
    if y_index is not None:
        y_index = y_index.to(device=x.device, dtype=torch.int32).contiguous()
    _kernels.require_cuda("nn", x, y, *(() if y_index is None
                                         else (y_index,)))
    return _launch(x, y, y_index, nn_plan(x.shape[0], x.shape[1],
                                          y.shape[1]))


def _launch(x: torch.Tensor, y: torch.Tensor, y_index: Optional[torch.Tensor],
            plan: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on contiguous fp32 CUDA tensors with the given plan
    (``_nn`` passes ``nn_plan``; tests and the smoke run force others)."""
    b, n, _ = x.shape
    m = y.shape[1]
    if y_index is None and y.shape[0] != b:
        raise ValueError(f"nn: {b} x batches against {y.shape[0]} y batches")
    dist = torch.empty((b, n), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=x.device)
    part = plan["splits"] > 1
    dpart = (torch.empty((plan["splits"], b, n), dtype=torch.float32,
                         device=x.device) if part else None)
    ipart = (torch.empty((plan["splits"], b, n), dtype=torch.int32,
                         device=x.device) if part else None)
    with torch.cuda.device(x.device), _kernels.traced(_nn, (b, n, m)):
        rc = _kernels.lib().genpc_nn(
            x.data_ptr(), y.data_ptr(), _kernels.ptr(y_index),
            dist.data_ptr(), idx.data_ptr(), _kernels.ptr(dpart),
            _kernels.ptr(ipart), b, n, m, plan["rows"], plan["threads"],
            plan["splits"], plan["chunk"], _kernels.stream(x))
    _kernels.check(rc, "genpc_nn")
    return dist, idx


_nn.launches = 0
_nn.trace = None


# ------------------------------------------------------------ public API ---

def segment_sum(idx: torch.Tensor, vals: torch.Tensor, m: int) -> torch.Tensor:
    """out[b, t] = sum of vals[b, s] over the s with idx[b, s] == t.

    idx [B,N] (values in [0, m)), vals [B,N,C] -> [B,m,C].  Deterministic
    on every device: a stable sort by target, then a segmented
    Hillis-Steele scan (log2 N steps of adds between equal keys) whose
    last element per segment is that target's sum; no atomics and no
    host synchronisation."""
    b, n = idx.shape
    c = vals.shape[-1]
    order = torch.argsort(idx, dim=1, stable=True)
    key = torch.gather(idx, 1, order)
    v = torch.gather(vals, 1, order[..., None].expand(-1, -1, c))
    step = 1
    while step < n:
        same = (key[:, step:] == key[:, :-step])[..., None]
        v = torch.cat([v[:, :step],
                       v[:, step:] + torch.where(same, v[:, :-step], 0.0)],
                      dim=1)
        step *= 2
    targets = torch.arange(m, device=idx.device).expand(b, m).contiguous()
    end = torch.searchsorted(key, targets, right=True)        # [B,m]
    start = torch.searchsorted(key, targets)
    last = torch.gather(v, 1, (end - 1).clamp_min(0)[..., None]
                        .expand(-1, -1, c))
    return torch.where((end > start)[..., None], last, 0.0)


class _ChamferNN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        d1, i1 = _nn(x, y)
        d2, i2 = _nn(y, x)
        ctx.save_for_backward(x, y, i1, i2)
        ctx.mark_non_differentiable(i1, i2)
        return d1, d2, i1, i2

    @staticmethod
    def backward(ctx, gd1, gd2, _gi1, _gi2):
        x, y, i1, i2 = ctx.saved_tensors
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        if gd1 is None:
            gd1 = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
        if gd2 is None:
            gd2 = torch.zeros(y.shape[:2], dtype=y.dtype, device=y.device)
        y_at_i1 = torch.gather(y, 1, i1.long()[..., None].expand(-1, -1, 3))
        x_at_i2 = torch.gather(x, 1, i2.long()[..., None].expand(-1, -1, 3))
        # reference chamfer3D.cu backward: +-2 g (x - y)
        g1 = 2.0 * gd1[..., None] * (x - y_at_i1)
        g2 = 2.0 * gd2[..., None] * (y - x_at_i2)
        gx = g1 + segment_sum(i2.long(), -g2, x.shape[1])
        gy = segment_sum(i1.long(), -g1, y.shape[1]) + g2
        return gx, gy


class _NNOneSided(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, y_index):
        d1, i1 = _nn(x, y, y_index)
        ctx.save_for_backward(x, y, i1, y_index)
        ctx.mark_non_differentiable(i1)
        return d1, i1

    @staticmethod
    def backward(ctx, gd1, _gi1):
        x, y, i1, y_index = ctx.saved_tensors
        ys = y.to(torch.float32)
        if y_index is not None:
            ys = ys[y_index.long()]
        y_at_i1 = torch.gather(ys, 1, i1.long()[..., None].expand(-1, -1, 3))
        g1 = 2.0 * gd1[..., None] * (x.to(torch.float32) - y_at_i1)
        gy = None
        if ctx.needs_input_grad[1]:
            if y_index is not None:
                raise ValueError("nn_one_sided: no gradient into a y "
                                 "shared through y_index")
            gy = segment_sum(i1.long(), -g1, y.shape[1])
        return g1, gy, None


def nn_one_sided(x: torch.Tensor, y: torch.Tensor,
                 y_index: Optional[torch.Tensor] = None):
    """(d1 [B,N], idx1 [B,N]) for x [B,N,3] into y, differentiable with
    the gradient of ``chamfer_nn``'s d1 (d2 carries no cotangent).
    y_index (int32 [B]) shares a y batch between x batches; y then gets
    no gradient."""
    return _NNOneSided.apply(x, y, y_index)


def chamfer_nn(x: torch.Tensor, y: torch.Tensor):
    """Bidirectional NN: (d1, d2, idx1, idx2); d squared, like the reference."""
    return _ChamferNN.apply(x, y)


def _ensure_batched(p: torch.Tensor):
    return (p[None], True) if p.ndim == 2 else (p, False)


def chamfer_distances(x: torch.Tensor, y: torch.Tensor):
    """(d1, d2, idx1, idx2) accepting [N,3] or [B,N,3] inputs."""
    xb, squeeze_x = _ensure_batched(x)
    yb, _ = _ensure_batched(y)
    d1, d2, i1, i2 = chamfer_nn(xb, yb)
    if squeeze_x:
        return d1[0], d2[0], i1[0], i2[0]
    return d1, d2, i1, i2


def nearest_neighbor(x: torch.Tensor, y: torch.Tensor):
    """One-directional NN (squared dist, index) — used by dedup."""
    xb, squeeze = _ensure_batched(x)
    yb, _ = _ensure_batched(y)
    d, i = _nn(xb, yb)
    return (d[0], i[0]) if squeeze else (d, i)

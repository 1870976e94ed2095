"""Slot-splat assembly of the pose renderer: kernels K4 and K5 and their
plain twins (counterpart of genpc_tpu/render/splat_kernel.py).

``assemble`` (K4, csrc/splat.cu ``splat_fwd_kernel``, replacing the
Pallas ``_fwd_kernel``) turns a padded slot table into the accumulated
image: per pixel, dmax over the (2f+1)² window offsets × S slots, then
Σ w·rgb and Σ w; its launch plan is ``splat_plan``.
``assemble_bwd_points`` (K5, ``splat_bwd_points_kernel``, replacing the
Pallas ``_bwd_kernel``) is its transpose as a gather, for what the
renderer's backward keeps: the 7 gradients of each point's own table
entry.  Both dispatch by device: a CPU tensor takes the plain twin, a
CUDA tensor launches the kernel.  ``assemble_bwd`` is the dense gradient
table of every entry, the reference's ``assemble_bwd``; it has no kernel
and serves CPU tensors only (the parity tests).

The twins sum in the kernels' order, which is the Pallas kernels' order
(forward: slot-outer, the offsets inner in raster order from -f to f;
backward: the offsets in raster order), with one rounding per operation,
so on the card a kernel and its twin agree bitwise.  Against the
reference's CPU path (the dense XLA ``_render_slots``, which sums
offset-outer) they agree to rounding.

Table layout [B,S,CH,H,W], H = W = res + 2f, channels px py dn sigma2 r
g b; sigma2 > 0 marks a present entry.  The kernels take the table with
any render stride (dim 0) as long as each render's [S,CH,H,W] block is
contiguous, so ``point_renderer._build_table``'s view of its buffer with
one trailing sentinel element reaches them without a copy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from genpc_tpu_torch import _kernels

CH = 7          # px py dn sigma2 r g b
_MAX_GRID_Y = 65535
TILE_W, TILE_H = 32, 8  # K4 tile: one warp a row of 32 pixels, 8 rows
_SMEM_MAX = 232448      # shared memory a block can use on an H100


def splat_plan(res: int, f: int, slots: int = 6) -> dict:
    """K4's launch plan at one resolution: a block a tile of TILE_W ×
    TILE_H pixels of one render, grid (blocks, renders).  The block's
    shared memory holds the sigma2 planes of the tile and its f-wide halo
    (halo_h × halo_w floats a slot) and one 64-bit presence word a slot and
    halo row, so halo_w = TILE_W + 2f must fit in 64 bits; a warp keeps
    one bit a slot, so at most 32 slots."""
    halo_w, halo_h = TILE_W + 2 * f, TILE_H + 2 * f
    if f < 0 or halo_w > 64:
        raise ValueError(f"splat_plan: footprint f = {f} needs halo rows of "
                         f"{halo_w} columns (one 64-bit word holds 64)")
    smem = slots * halo_h * (8 + 4 * halo_w)
    if smem > _SMEM_MAX or slots > 32:
        raise ValueError(f"splat_plan: {slots} slots (at most 32), f = {f} "
                         f"need {smem} bytes of shared memory")
    tiles_x, tiles_y = -(-res // TILE_W), -(-res // TILE_H)
    return {"tile_w": TILE_W, "tile_h": TILE_H, "halo_w": halo_w,
            "halo_h": halo_h, "tiles_x": tiles_x, "tiles_y": tiles_y,
            "blocks": tiles_x * tiles_y, "threads": TILE_W * TILE_H,
            "smem": smem}


def _offsets(f: int):
    return [(oy, ox) for oy in range(-f, f + 1) for ox in range(-f, f + 1)]


def _iota(res: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    q = torch.arange(res, dtype=torch.float32, device=device)
    return q[None, None, :], q[None, :, None]       # qx, qy as [1,1,r],[1,r,1]


def _window(px, py, qx, qy, f: int):
    return ((qx - torch.floor(px)).abs() <= f) & \
        ((qy - torch.floor(py)).abs() <= f)


def assemble_plain(table: torch.Tensor, res: int, f: int, gamma: float):
    """Plain version of K4: [B,S,CH,H,W] -> ((acc [B,3,r,r], wacc [B,r,r]),
    dmax [B,r,r])."""
    b, s_count = table.shape[:2]
    dev = table.device
    qx, qy = _iota(res, dev)
    g = table.new_full((), gamma)

    def slab(s, c, oy, ox):
        return table[:, s, c, f - oy:f - oy + res, f - ox:f - ox + res]

    dmax = torch.full((b, res, res), -1.0, dtype=torch.float32, device=dev)
    for s in range(s_count):
        for oy, ox in _offsets(f):
            px, py = slab(s, 0, oy, ox), slab(s, 1, oy, ox)
            ixf, iyf = torch.floor(px), torch.floor(py)
            center_in = ((ixf >= 0) & (ixf <= res - 1)
                         & (iyf >= 0) & (iyf <= res - 1))
            ok = (slab(s, 3, oy, ox) > 0) & center_in & \
                _window(px, py, qx, qy, f)
            dmax = torch.maximum(dmax, torch.where(ok, slab(s, 2, oy, ox),
                                                   -1.0))
    acc = [torch.zeros((b, res, res), dtype=torch.float32, device=dev)
           for _ in range(3)]
    wacc = torch.zeros((b, res, res), dtype=torch.float32, device=dev)
    for s in range(s_count):
        for oy, ox in _offsets(f):
            px, py = slab(s, 0, oy, ox), slab(s, 1, oy, ox)
            s2 = slab(s, 3, oy, ox)
            d2 = (px - qx).square() + (py - qy).square()
            w_s = torch.exp(-d2 / torch.clamp_min(2.0 * s2, 1e-12))
            ok = (s2 > 0) & _window(px, py, qx, qy, f) & (w_s > 1e-4)
            expo = torch.clamp_max((slab(s, 2, oy, ox) - dmax) / g, 0.0)
            w = torch.where(ok, w_s * torch.exp(expo), 0.0)
            for c in range(3):
                acc[c] = acc[c] + w * slab(s, 4 + c, oy, ox)
            wacc = wacc + w
    return (torch.stack(acc, dim=1), wacc), dmax


def _check_table(name: str, table: torch.Tensor, res: int, f: int) -> None:
    if table.ndim != 5 or table.shape[2] != CH or \
            table.shape[3] != res + 2 * f or table.shape[4] != res + 2 * f:
        raise ValueError(f"{name}: table of shape {tuple(table.shape)} for "
                         f"res {res}, f {f}")


def _render_stride(name: str, table: torch.Tensor) -> int:
    """The table's render stride in floats, once it is fp32 on a CUDA
    device with each render's [S,CH,H,W] block contiguous."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"{name}: table of dtype {table.dtype} (fp32 only)")
    if table.shape[0] and not table[0].is_contiguous():
        raise ValueError(f"{name}: each render's [S,CH,H,W] block must be "
                         f"contiguous (strides {table.stride()})")
    return table.stride(0)


def assemble(table: torch.Tensor, res: int, f: int, gamma: float):
    """Slot-table assembly: [B,S,CH,res+2f,res+2f] -> ((acc [B,3,r,r],
    wacc [B,r,r]), dmax [B,r,r]).  CPU tensors take the plain version;
    CUDA tensors launch K4, reading the table in place (any render
    stride).  Not differentiable by itself: point_renderer wraps it in an
    autograd Function whose backward is ``assemble_bwd_points``."""
    table = table.to(torch.float32)
    _check_table("assemble", table, res, f)
    if table.device.type == "cpu":
        return assemble_plain(table, res, f, gamma)
    rstride = _render_stride("splat_fwd", table)
    b, s_count = table.shape[:2]
    if b > _MAX_GRID_Y:
        raise ValueError(f"assemble: {b} renders per launch (max "
                         f"{_MAX_GRID_Y})")
    plan = splat_plan(res, f, s_count)
    acc = torch.empty((b, 3, res, res), dtype=torch.float32,
                      device=table.device)
    wacc = torch.empty((b, res, res), dtype=torch.float32,
                       device=table.device)
    dmax = torch.empty_like(wacc)
    with torch.cuda.device(table.device), \
            _kernels.traced(assemble, (b, s_count, res)):
        rc = _kernels.lib().genpc_splat_fwd(
            table.data_ptr(), rstride, acc.data_ptr(), wacc.data_ptr(),
            dmax.data_ptr(), b, s_count, res, f, float(gamma),
            plan["tiles_x"], plan["blocks"], plan["smem"],
            _kernels.stream(table))
    _kernels.check(rc, "genpc_splat_fwd")
    return (acc, wacc), dmax


assemble.launches = 0
assemble.trace = None


def _cotangent_buffer(cots, dmax, f: int) -> torch.Tensor:
    """(g_acc [B,3,r,r], g_wacc [B,r,r]), dmax -> padded [B,5,r+2f,r+2f]."""
    g_acc, g_wacc = cots
    c = torch.cat([g_acc.to(torch.float32), g_wacc.to(torch.float32)[:, None],
                   dmax.to(torch.float32)[:, None]], dim=1)
    return F.pad(c, (f, f, f, f)).contiguous()


def assemble_bwd_plain(table: torch.Tensor, cots, dmax: torch.Tensor,
                       res: int, f: int, gamma: float) -> torch.Tensor:
    """Plain version of K5: the gradient table [B,S,7,res,res]."""
    dev = table.device
    c = _cotangent_buffer(cots, dmax, f)
    t = table[:, :, :, f:f + res, f:f + res]
    px, py, dn, s2, cr, cg, cb = t.unbind(2)          # [B,S,r,r] each
    pres = s2 > 0
    ixf, iyf = torch.floor(px), torch.floor(py)
    s2c = torch.clamp_min(2.0 * s2, 1e-12)
    qx, qy = _iota(res, dev)
    g = table.new_full((), gamma)
    z = torch.zeros_like(px)
    d_px, d_py, d_dn, d_s2, d_r, d_g, d_b = (z,) * 7
    for oy, ox in _offsets(f):
        gr, gg, gb, gwa, dm = (
            c[:, None, k, f + oy:f + oy + res, f + ox:f + ox + res]
            for k in range(5))
        qx2, qy2 = qx + ox, qy + oy
        inb = (qx2 >= 0) & (qx2 <= res - 1) & (qy2 >= 0) & (qy2 <= res - 1)
        win = ((qx2 - ixf).abs() <= f) & ((qy2 - iyf).abs() <= f)
        d2 = (px - qx2).square() + (py - qy2).square()
        w_s = torch.exp(-d2 / s2c)
        ok = pres & inb & win & (w_s > 1e-4)
        expo_raw = (dn - dm) / g
        e = torch.exp(torch.clamp_max(expo_raw, 0.0))
        w = torch.where(ok, w_s * e, 0.0)
        gw = torch.where(ok, gr * cr + gg * cg + gb * cb + gwa, 0.0)
        dw_s = gw * e
        dd2 = dw_s * w_s * (-1.0 / s2c)
        d_px = d_px + dd2 * 2.0 * (px - qx2)
        d_py = d_py + dd2 * 2.0 * (py - qy2)
        tie_w = torch.where(expo_raw < 0.0, 1.0,
                            torch.where(expo_raw == 0.0, 0.5, 0.0))
        d_dn = d_dn + tie_w * gw * w_s * e / g
        d_s2 = d_s2 + dw_s * w_s * (d2 / (s2c * s2c)) * 2.0
        d_r = d_r + w * gr
        d_g = d_g + w * gg
        d_b = d_b + w * gb
    out = torch.stack([d_px, d_py, d_dn, d_s2, d_r, d_g, d_b], dim=2)
    return torch.where(pres[:, :, None], out, 0.0)


def assemble_bwd(table: torch.Tensor, cots, dmax: torch.Tensor, res: int,
                 f: int, gamma: float) -> torch.Tensor:
    """Dense gradient table d L / d(table entries), the reference's
    ``assemble_bwd``.

    table: padded [B,S,CH,res+2f,res+2f] (``_build_table``); cots:
    (g_acc [B,3,r,r], g_wacc [B,r,r]); dmax [B,r,r] from the forward.
    Returns [B,S,7,r,r] in interior pixel layout (d_px, d_py, d_dn,
    d_sigma2, d_r, d_g, d_b).  Only a CPU tensor is served (the plain
    version): the renderer's backward needs the entries of its points
    only, which ``assemble_bwd_points`` computes (K5 on the card); any
    other device raises."""
    table = table.to(torch.float32)
    _check_table("assemble_bwd", table, res, f)
    if table.device.type != "cpu":
        raise ValueError(f"assemble_bwd: no kernel for device "
                         f"{table.device}; use assemble_bwd_points")
    return assemble_bwd_plain(table, cots, dmax, res, f, gamma)


def assemble_bwd_points_plain(table: torch.Tensor, slot_orig: torch.Tensor,
                              cots, dmax: torch.Tensor, res: int, f: int,
                              slots: int, gamma: float) -> torch.Tensor:
    """Plain version of K5: the dense gradient table, then each point's 7
    gradients gathered at its entry -> [B,7,N], zeros for dropped points
    (slot_orig == slots·res²)."""
    d_t = assemble_bwd_plain(table, cots, dmax, res, f, gamma)
    npix = res * res
    # entry (rank, pix) of channel c sits at (rank·CH + c)·npix + pix
    valid = slot_orig < slots * npix
    rank = torch.div(slot_orig, npix, rounding_mode="floor")
    pos = torch.where(valid, rank * (CH * npix) + slot_orig % npix, 0)
    flat = d_t.reshape(d_t.shape[0], -1)
    return torch.stack([torch.where(valid, torch.gather(flat, 1,
                                                        pos + c * npix), 0.0)
                        for c in range(CH)], dim=1)


def assemble_bwd_points(table: torch.Tensor, slot_orig: torch.Tensor, cots,
                        dmax: torch.Tensor, res: int, f: int, slots: int,
                        gamma: float,
                        order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradients of each point's own table entry, [B,7,N] (d_px, d_py,
    d_dn, d_sigma2, d_r, d_g, d_b), zeros for dropped points.

    table: padded [B,S,CH,res+2f,res+2f] (``_build_table``, any render
    stride); slot_orig [B,N]: each point's slot-major position rank·res² +
    pixel, slots·res² when dropped; cots: (g_acc [B,3,r,r], g_wacc
    [B,r,r]); dmax [B,r,r] from the forward; order [B,N]: a permutation
    of each render's points, the order in which K5's threads take them
    (``_build_table``'s, sorted by pixel, lets a warp's windows share
    cache lines; None: the caller's order).  The result does not depend on
    it; a thread given an index outside [0, N) does nothing.  CPU tensors
    take the plain version; CUDA tensors launch K5, which reads the
    cotangents unpadded and g_acc at its own strides."""
    table = table.to(torch.float32)
    _check_table("assemble_bwd_points", table, res, f)
    b, s_count = table.shape[:2]
    if s_count != slots or slot_orig.shape[0] != b:
        raise ValueError(f"assemble_bwd_points: table of shape "
                         f"{tuple(table.shape)}, {slots} slots, slot_orig "
                         f"of shape {tuple(slot_orig.shape)}")
    if table.device.type == "cpu":
        return assemble_bwd_points_plain(table, slot_orig, cots, dmax, res,
                                         f, slots, gamma)
    rstride = _render_stride("splat_bwd", table)
    g_acc = cots[0].to(torch.float32)
    g_wacc = cots[1].to(torch.float32).contiguous()
    dmax = dmax.to(torch.float32).contiguous()
    slot_orig = slot_orig.to(torch.int64).contiguous()
    if order is not None:
        order = order.to(torch.int64).contiguous()
        if order.shape != slot_orig.shape:
            raise ValueError(f"splat_bwd: order of shape "
                             f"{tuple(order.shape)}")
    for t in (slot_orig, order, g_acc, g_wacc, dmax):
        if t is not None and t.device != table.device:
            raise ValueError(f"splat_bwd: tensors on {t.device} and "
                             f"{table.device}")
    if g_acc.shape != (b, 3, res, res) or g_wacc.shape != (b, res, res) \
            or dmax.shape != (b, res, res):
        raise ValueError("splat_bwd: cotangents or dmax of the wrong shape")
    n = slot_orig.shape[1]
    out = torch.empty((b, CH, n), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device), \
            _kernels.traced(assemble_bwd_points, (b, n, res)):
        rc = _kernels.lib().genpc_splat_bwd_points(
            table.data_ptr(), rstride, slot_orig.data_ptr(),
            _kernels.ptr(order), g_acc.data_ptr(), *g_acc.stride(),
            g_wacc.data_ptr(), dmax.data_ptr(), out.data_ptr(), b, n,
            s_count, res, f, float(gamma), _kernels.stream(table))
    _kernels.check(rc, "genpc_splat_bwd_points")
    return out


assemble_bwd_points.launches = 0
assemble_bwd_points.trace = None

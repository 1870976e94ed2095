"""Slot-splat assembly of the pose renderer: kernels K4 and K5 and their
plain twins (counterpart of genpc_tpu/render/splat_kernel.py).

``assemble`` (K4, csrc/splat.cu ``splat_fwd_kernel``, replacing the
Pallas ``_fwd_kernel``) turns a padded slot table into the accumulated
image: per pixel, dmax over the (2f+1)² window offsets × S slots, then
Σ w·rgb and Σ w.  ``assemble_bwd`` (K5, ``splat_bwd_kernel``, replacing
the Pallas ``_bwd_kernel``) is its transpose as a gather: the gradient of
every table entry.  Both dispatch by device: a CPU tensor takes the plain
twin, a CUDA tensor launches the kernel.  Any resolution works (no
tiling constraint, so no fallback path).

The twins sum in the kernels' order, which is the Pallas kernels' order
(forward: slot-outer, the offsets inner in raster order from -f to f;
backward: the offsets in raster order), with one rounding per operation,
so on the card a kernel and its twin agree bitwise.  Against the
reference's CPU path (the dense XLA ``_render_slots``, which sums
offset-outer) they agree to rounding.

Table layout [B,S,CH,H,W], H = W = res + 2f, channels px py dn sigma2 r
g b; sigma2 > 0 marks a present entry.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from genpc_tpu_torch import _kernels

CH = 7          # px py dn sigma2 r g b
_MAX_GRID_Y = 65535


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
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)

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


def assemble(table: torch.Tensor, res: int, f: int, gamma: float):
    """Slot-table assembly: [B,S,CH,res+2f,res+2f] -> ((acc [B,3,r,r],
    wacc [B,r,r]), dmax [B,r,r]).  CPU tensors take the plain version;
    CUDA tensors launch K4.  Not differentiable by itself:
    point_renderer wraps it in an autograd Function whose backward is
    ``assemble_bwd``."""
    table = table.to(torch.float32).contiguous()
    _check_table("assemble", table, res, f)
    if table.device.type == "cpu":
        return assemble_plain(table, res, f, gamma)
    _kernels.require_cuda("splat_fwd", table)
    b, s_count = table.shape[:2]
    if b > _MAX_GRID_Y:
        raise ValueError(f"assemble: {b} renders per launch (max "
                         f"{_MAX_GRID_Y})")
    acc = torch.empty((b, 3, res, res), dtype=torch.float32,
                      device=table.device)
    wacc = torch.empty((b, res, res), dtype=torch.float32,
                       device=table.device)
    dmax = torch.empty_like(wacc)
    with torch.cuda.device(table.device):
        rc = _kernels.lib().genpc_splat_fwd(
            table.data_ptr(), acc.data_ptr(), wacc.data_ptr(),
            dmax.data_ptr(), b, s_count, res, f, float(gamma),
            _kernels.stream(table))
    _kernels.check(rc, "genpc_splat_fwd")
    assemble.launches += 1
    return (acc, wacc), dmax


assemble.launches = 0


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
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
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
    """Gradient table d L / d(table entries).

    table: padded [B,S,CH,res+2f,res+2f] (``_build_table``); cots:
    (g_acc [B,3,r,r], g_wacc [B,r,r]); dmax [B,r,r] from the forward.
    Returns [B,S,7,r,r] in interior pixel layout (d_px, d_py, d_dn,
    d_sigma2, d_r, d_g, d_b).  CPU tensors take the plain version; CUDA
    tensors launch K5."""
    table = table.to(torch.float32).contiguous()
    _check_table("assemble_bwd", table, res, f)
    if table.device.type == "cpu":
        return assemble_bwd_plain(table, cots, dmax, res, f, gamma)
    b, s_count = table.shape[:2]
    if b * s_count > _MAX_GRID_Y:
        raise ValueError(f"assemble_bwd: {b} x {s_count} render slots per "
                         f"launch (max {_MAX_GRID_Y})")
    cot = _cotangent_buffer(cots, dmax, f)
    _kernels.require_cuda("splat_bwd", table, cot)
    out = torch.empty((b, s_count, CH, res, res), dtype=torch.float32,
                      device=table.device)
    with torch.cuda.device(table.device):
        rc = _kernels.lib().genpc_splat_bwd(
            table.data_ptr(), cot.data_ptr(), out.data_ptr(), b, s_count,
            res, f, float(gamma), _kernels.stream(table))
    _kernels.check(rc, "genpc_splat_bwd")
    assemble_bwd.launches += 1
    return out


assemble_bwd.launches = 0

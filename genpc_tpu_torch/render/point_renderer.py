"""Differentiable soft point-splat renderers (counterpart of
genpc_tpu/render/point_renderer.py; the reference's Pulsar setup: eye
(0,0,3), focal 4.0, 224², gamma 1e-2, world-space radii, black
background, diff_obj_pose.py:108-134).

``method="slots"`` is the pose optimiser's renderer.  Each point projects to a continuous pixel position and writes ONE
attribute record into the next free slot of its centre pixel
(``_build_table``: a stable sort by pixel, ranks by ``cummax``, a
scatter whose real targets are unique).  The image is then assembled
from the table by kernel K4 (``splat_kernel.assemble``); the gradient
runs through kernel K5 (``splat_kernel.assemble_bwd_points``), which
gives each point the gradients of its own entry (``_SlotsRender``).
Every sum has a fixed order, so a render and its gradient repeat
bitwise.

``method="scatter"`` (the default, as in the reference) is the
footprint-scatter formulation in plain torch (``_render_scatter``): a
centre-pixel ``scatter_reduce(amax)`` dilated by a (2f+1)² max pool
gives each pixel's depth maximum, then one ``index_add_`` over all K²
offsets of every point sums the weights.  Its float sums are taken in
the order the device's atomics take them; ``deterministic=True`` sums
the reference's two-word fixed-point integers instead (``_QuantizedSums``,
int64 ``index_add_``), which gives the same bits in any order.  Its
gradient is autograd's.

Renders are batched: points [R,N,3] (or [N,3]) -> images [R,res,res,3].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from genpc_tpu_torch.render.splat_kernel import (CH, assemble,
                                                 assemble_bwd_points)


@dataclass
class RenderCamera:
    """Fixed pinhole camera: eye on +z looking at the origin with +y up,
    focal length in NDC units, square image (reference: pytorch3d
    look_at_view_transform(eye=(0,0,3)), focal 4.0)."""
    eye: Tuple[float, float, float]
    focal: float
    res: int
    znear: float = 1e-4
    zfar: float = 5.0

    @classmethod
    def default(cls, render_size: int = 224, eye=(0.0, 0.0, 3.0),
                focal: float = 4.0) -> "RenderCamera":
        return cls(tuple(float(e) for e in eye), focal, render_size)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi) with the reference's gradient: jnp.clip is a
    maximum then a minimum, whose gradient splits 50/50 where x equals a
    bound (torch.clamp passes it whole).  Pose-loss values sit exactly on
    a bound often enough (a saturated sigmoid under the BCE clip) for the
    difference to show.  The bounds are filled on x's device, with no
    host-to-device copy."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _project_attrs(points: torch.Tensor, radius, camera: RenderCamera,
                   footprint: int):
    """Continuous pixel centres and splat parameters of points [...,N,3]:
    (px, py, dn, sigma2, in_front), each [...,N].  Its constants are
    filled on the points' device: it copies nothing from the host."""
    res = camera.res
    pts = points.to(torch.float32)
    rad = radius.to(device=pts.device, dtype=torch.float32) \
        if torch.is_tensor(radius) else pts.new_full((), float(radius))
    depth = torch.maximum(pts.new_full((), camera.eye[2]) - pts[..., 2],
                          pts.new_full((), camera.znear))
    half = res / 2.0
    px = (pts[..., 0] * camera.focal / depth) * half + half - 0.5
    py = (-pts[..., 1] * camera.focal / depth) * half + half - 0.5
    # pixel-space splat radius, clamped into [0.3, footprint]
    rad_pix = clip(rad * camera.focal / depth * half, 0.3, float(footprint))
    sigma2 = (rad_pix * 0.6).square()
    # Pulsar-style depth weight normalised to [0,1] (1 = closest)
    dn = clip((camera.zfar - depth) / (camera.zfar - camera.znear), 0.0, 1.0)
    in_front = depth > camera.znear
    return px, py, dn, sigma2, in_front


def _build_table(px, py, dn, sigma2, cols, in_front, res: int, f: int,
                 slots: int):
    """Per-pixel slot tables of R renders.

    px, py, dn, sigma2, in_front [R,N]; cols [R,N,3].  Returns (table
    [R,S,CH,res+2f,res+2f], keep [R,N] bool, slot_orig [R,N] int64, order
    [R,N] int64): a point's record sits in its centre pixel's next free
    slot (stable-sort rank), out-of-image centres clamped for storage;
    keep marks points in the table (in front, rank < slots); slot_orig is
    each point's flat slot-major position rank·res² + pixel in the
    original point order, slots·res² for dropped points; order is the
    points sorted by pixel (the stable sort).  The first three are the
    reference's outputs."""
    r, n = px.shape
    dev = px.device
    npix = res * res
    hp = res + 2 * f
    ixc = torch.floor(px).to(torch.int64).clamp(0, res - 1)
    iyc = torch.floor(py).to(torch.int64).clamp(0, res - 1)
    cpix = torch.where(in_front, iyc * res + ixc, npix)
    order = torch.argsort(cpix, dim=1, stable=True)
    cs = torch.gather(cpix, 1, order)
    ar = torch.arange(n, device=dev).expand(r, n)
    first = torch.ones_like(cs, dtype=torch.bool)
    first[:, 1:] = cs[:, 1:] != cs[:, :-1]
    rank = ar - torch.cummax(torch.where(first, ar, 0), dim=1).values
    valid = (cs < npix) & (rank < slots)
    slot = torch.where(valid, rank * npix + cs, slots * npix)
    # scatter straight into the padded [S,CH,H,W] layout; dropped points
    # all write zeros into one trailing sentinel entry.  The table is the
    # view of the buffer without it (render stride size + 1), which the
    # kernels read in place; a sentinel in the zero border instead would
    # need f > 0
    sy, sx = torch.div(cs, res, rounding_mode="floor"), cs % res
    base = rank * (CH * hp * hp) + (sy + f) * hp + (sx + f)     # [R,N]
    chan = torch.arange(CH, device=dev)[None, :, None] * (hp * hp)
    size = slots * CH * hp * hp
    dest = torch.where(valid[:, None], base[:, None] + chan, size)
    attrs = torch.stack([px, py, dn, sigma2, cols[..., 0], cols[..., 1],
                         cols[..., 2]], dim=1).to(torch.float32)  # [R,CH,N]
    attrs = torch.gather(attrs, 2, order[:, None].expand(-1, CH, -1))
    table = torch.zeros((r, size + 1), dtype=torch.float32, device=dev)
    table.scatter_(1, dest.reshape(r, -1),
                   torch.where(valid[:, None], attrs, 0.0).reshape(r, -1))
    table = table[:, :size].reshape(r, slots, CH, hp, hp)
    keep = torch.zeros_like(valid).scatter(1, order, valid)
    slot_orig = torch.zeros_like(slot).scatter(1, order, slot)
    return table, keep, slot_orig, order


class _SlotsRender(torch.autograd.Function):
    """attrs [R,N] (+ cols [R,N,3]) -> (acc [R,3,r,r], wacc [R,r,r]).

    Forward: ``_build_table`` then K4, on the table as the view it is.
    Backward: K5 gives each point the 7 gradients of its own entry, found
    at ``slot_orig`` (zeros for dropped points), taking the points in the
    table's build order.  ``in_front`` gets no gradient."""

    @staticmethod
    def forward(ctx, px, py, dn, sigma2, cols, in_front, res, f, slots,
                gamma):
        table, _, slot_orig, order = _build_table(px, py, dn, sigma2, cols,
                                                  in_front, res, f, slots)
        (acc, wacc), dmax = assemble(table, res, f, gamma)
        ctx.save_for_backward(table, slot_orig, order, dmax)
        ctx.consts = (res, f, slots, gamma)
        return acc, wacc

    @staticmethod
    def backward(ctx, g_acc, g_wacc):
        table, slot_orig, order, dmax = ctx.saved_tensors
        res, f, slots, gamma = ctx.consts
        r = table.shape[0]
        if g_acc is None:
            g_acc = torch.zeros((r, 3, res, res), device=table.device)
        if g_wacc is None:
            g_wacc = torch.zeros((r, res, res), device=table.device)
        g = assemble_bwd_points(table, slot_orig, (g_acc, g_wacc), dmax,
                                res, f, slots, gamma, order)   # [R,7,N]
        return (g[:, 0], g[:, 1], g[:, 2], g[:, 3], g[:, 4:].transpose(1, 2),
                None, None, None, None, None)


class _QuantizedSums(torch.autograd.Function):
    """Per-index sums of vals [E,C] at idx [E] into [n,C], bitwise the
    same in any summation order (the reference's ``_quantized_sums`` and
    ``_segment_accumulate``, point_renderer.py:55-110): each element is
    scaled by its index's largest last-channel value (a scatter-max,
    order-free), written as two fixed-point words (2^15 and a 2^12
    residual) and summed as int64, then scaled back.  Envelope: vals >= 0,
    each row bounded by its last channel.  The gradient is the float
    sum's: the output cotangent gathered at each element's index."""

    @staticmethod
    def forward(ctx, idx, vals, n: int):
        s1, s2 = 32768.0, 4096.0
        w = vals[:, -1]
        pmax = torch.zeros(n, dtype=torch.float32, device=vals.device) \
            .scatter_reduce(0, idx, w, "amax", include_self=True)
        u = vals / torch.clamp_min(pmax[idx], 1e-30)[:, None]
        q1 = torch.round(u * s1)
        q2 = torch.round((u * s1 - q1) * s2)
        c = vals.shape[1]
        acc = torch.zeros((n, 2 * c), dtype=torch.int64,
                          device=vals.device).index_add_(
            0, idx, torch.cat([q1, q2], 1).to(torch.int64))
        a1, a2 = acc[:, :c], acc[:, c:]
        sums = (a1.to(torch.float32) + a2.to(torch.float32) / s2) / s1
        ctx.save_for_backward(idx)
        return sums * pmax[:, None]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return None, g[idx], None


def _render_scatter(points: torch.Tensor, cols: torch.Tensor, radius,
                    camera: RenderCamera, gamma: float, footprint: int,
                    deterministic: bool) -> torch.Tensor:
    """Footprint scatter renderer (reference: point_renderer.py:343-410)
    of R renders: points, cols [R,N,3] -> images [R,res,res,3].  Each
    render's pixels, plus one dummy entry for dropped contributions,
    take the rows r·(res²+1) + pixel of one flat accumulator."""
    res, f = camera.res, footprint
    k = 2 * f + 1
    r, n = points.shape[:2]
    npix = res * res
    dev = points.device
    px, py, dn, sigma2, in_front = _project_attrs(points, radius, camera,
                                                  footprint)
    ix = torch.floor(px).to(torch.int64)
    iy = torch.floor(py).to(torch.int64)
    base = (torch.arange(r, device=dev) * (npix + 1))[:, None]

    # pass 1: each pixel's depth maximum = one centre-pixel scatter-max
    # dilated by a (2f+1)² max pool (a footprint reaches f pixels from
    # its centre); it only normalises the weights and carries no gradient
    with torch.no_grad():
        center_ok = in_front & (ix >= 0) & (ix < res) & (iy >= 0) & \
            (iy < res)
        cpix = torch.where(center_ok, iy * res + ix, npix) + base
        d0 = torch.full((r * (npix + 1),), -1.0, dtype=torch.float32,
                        device=dev).scatter_reduce(
            0, cpix.reshape(-1),
            torch.where(center_ok, dn, -1.0).reshape(-1), "amax",
            include_self=True).reshape(r, npix + 1)
        img = F.max_pool2d(d0[:, :npix].reshape(r, 1, res, res), k, 1, f)
        dmax = torch.cat([img.reshape(r, npix), d0[:, npix:]], 1)

    # pass 2: one fused scatter over all K² offsets [R,K²,N]
    dys = torch.arange(-f, f + 1, device=dev)
    cy = iy[:, None] + dys.repeat_interleave(k)[None, :, None]
    cx = ix[:, None] + dys.repeat(k)[None, :, None]
    d2 = ((px[:, None] - cx.to(torch.float32)).square()
          + (py[:, None] - cy.to(torch.float32)).square())
    w_s = torch.exp(-d2 / (2.0 * sigma2)[:, None])
    ok = ((cx >= 0) & (cx < res) & (cy >= 0) & (cy < res)
          & in_front[:, None] & (w_s > 1e-4))
    idx = torch.where(ok, cy * res + cx, npix)
    # dn <= dmax wherever a centre covers the pixel, so the clamp at 0 is
    # exact there (jnp.minimum's gradient, split at the tie); it keeps the
    # dropped offsets (dummy entry, dmax -1) finite
    expo = torch.minimum(
        (dn[:, None] - torch.gather(dmax, 1, idx.reshape(r, -1))
         .reshape(idx.shape)) / gamma,
        torch.zeros((), dtype=torch.float32, device=dev))
    w = torch.where(ok, w_s * torch.exp(expo), 0.0).reshape(-1)
    flat = (idx + base[..., None]).reshape(-1)
    cols_t = cols[:, None].expand(r, k * k, n, 3).reshape(-1, 3)
    size = r * (npix + 1)
    if deterministic:
        seg = _QuantizedSums.apply(
            flat, torch.cat([w[:, None] * cols_t, w[:, None]], 1), size)
        acc, wacc = seg[:, :3], seg[:, 3]
    else:
        acc = torch.zeros((size, 3), dtype=torch.float32,
                          device=dev).index_add(0, flat, w[:, None] * cols_t)
        wacc = torch.zeros(size, dtype=torch.float32,
                           device=dev).index_add(0, flat, w)
    # background: a fixed unit weight at dn=0 (point_renderer.py:408)
    bg_w = torch.exp(points.new_full((), -1.0) / gamma) + 1e-8
    acc = acc.reshape(r, npix + 1, 3)[:, :npix]
    wacc = wacc.reshape(r, npix + 1)[:, :npix]
    return (acc / (wacc + bg_w)[..., None]).reshape(r, res, res, 3)


def render_points(points: torch.Tensor, colors: torch.Tensor, radius,
                  camera: RenderCamera, gamma: float = 1e-2,
                  footprint: int = 3, deterministic: bool = False,
                  method: str = "scatter", slots: int = 6) -> torch.Tensor:
    """Render points [R,N,3] (or [N,3]) with colours of the same shape ->
    images [R,res,res,3] (or [res,res,3]).

    radius: world-space splat radius (scalar or [...,N]); footprint: the
    splat window's half-width in pixels (K = 2f+1).  method: 'scatter'
    (the default, the reference's formulation; ``deterministic`` sums in
    fixed point) or 'slots' (the slot table and kernels K4/K5, bitwise
    repeatable by construction; the pose path's renderer)."""
    if method not in ("scatter", "slots"):
        raise ValueError(f"render method {method!r}: use 'scatter' or "
                         f"'slots'")
    single = points.ndim == 2
    pts = (points[None] if single else points).to(torch.float32)
    cols = colors.to(torch.float32)
    cols = (cols[None] if cols.ndim == 2 else cols).expand(pts.shape)
    if method == "scatter":
        img = _render_scatter(pts, cols, radius, camera, gamma, footprint,
                              deterministic)
        return img[0] if single else img
    res = camera.res
    px, py, dn, sigma2, in_front = _project_attrs(pts, radius, camera,
                                                  footprint)
    acc, wacc = _SlotsRender.apply(px, py, dn, sigma2, cols, in_front, res,
                                   footprint, slots, float(gamma))
    bg_w = torch.exp(pts.new_full((), -1.0) / gamma) + 1e-8
    img = (acc / (wacc + bg_w)[:, None]).permute(0, 2, 3, 1)
    return img[0] if single else img


def luminance(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luminance (reference: diff_obj_pose.py:177)."""
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def soft_mask(img: torch.Tensor, threshold: float = 0.1,
              tau: float = 0.05) -> torch.Tensor:
    """Differentiable occupancy mask (reference: diff_obj_pose.py:258-275)."""
    return torch.sigmoid((luminance(img) - threshold) / tau)


def hard_mask(img: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """Hard-threshold mask (reference: diff_obj_pose.py:166-178)."""
    return (luminance(img) > threshold).to(torch.float32)

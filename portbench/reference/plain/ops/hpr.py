"""Point-cloud visibility (counterpart of genpc_tpu/ops/hpr.py).

  * ``hidden_point_removal`` — exact Katz HPR (open3d semantics):
    spherical flip in float64 numpy plus a scipy convex hull, on the
    host (``visibility='hpr'``).
  * ``visible_points_zbuffer`` projects the cloud toward each viewpoint,
    takes the per-pixel nearest depth with a ``scatter_reduce_("amin")``
    over a (2·splat+1)² footprint, and calls a point visible when its
    depth is within ``tol``·depth-range of its own pixel's nearest depth
    (``visibility='zbuffer'``, the default).
  * ``select_best_view`` is the reference's coarse-to-exact selector;
    ``visible_points`` dispatches between the two tests.
"""

from __future__ import annotations

import numpy as np
import torch


def hidden_point_removal(points: np.ndarray, viewpoint: np.ndarray,
                         radius_param: float) -> np.ndarray:
    """Exact Katz spherical-flip HPR; returns a boolean visibility mask.

    Coordinates are flipped about a sphere of radius ``radius_param``
    centred at the viewpoint; visible points are hull vertices of the
    flipped set plus the camera."""
    from scipy.spatial import ConvexHull

    pts = np.asarray(points, np.float64) - np.asarray(viewpoint, np.float64)
    norms = np.linalg.norm(pts, axis=1, keepdims=True)
    norms = np.maximum(norms, 1e-12)
    flipped = pts + 2.0 * (radius_param - norms) * (pts / norms)
    cloud = np.concatenate([flipped, np.zeros((1, 3))], axis=0)
    hull = ConvexHull(cloud)
    mask = np.zeros(len(points), bool)
    vis = hull.vertices
    mask[vis[vis < len(points)]] = True
    return mask


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [V,N,3] · b [V,3] -> [V,N], summed in the order x, y, z."""
    return (a[..., 0] * b[:, None, 0] + a[..., 1] * b[:, None, 1]
            + a[..., 2] * b[:, None, 2])


def visible_points_zbuffer(points: torch.Tensor, viewpoints: torch.Tensor,
                           res: int = 96, tol: float = 0.05,
                           splat: int = 1) -> torch.Tensor:
    """points [N,3]; viewpoints [V,3] (cameras looking at the origin).
    Returns bool [V,N]."""
    pts = points.to(torch.float32)
    eye = viewpoints.to(torch.float32)
    dev = pts.device
    fwd = -eye / (torch.linalg.vector_norm(eye, dim=-1, keepdim=True) + 1e-9)
    world_up = torch.where(
        (fwd[:, 1:2].abs() > 0.99),
        torch.tensor([0.0, 0.0, 1.0], device=dev),
        torch.tensor([0.0, 1.0, 0.0], device=dev))
    right = torch.linalg.cross(fwd, world_up, dim=-1)
    right = right / (torch.linalg.vector_norm(right, dim=-1, keepdim=True)
                     + 1e-9)
    up = torch.linalg.cross(right, fwd, dim=-1)
    rel = pts[None] - eye[:, None]                   # [V,N,3]
    z = _dot3(rel, fwd)                              # depth along view axis
    z_safe = torch.clamp_min(z, 1e-6)
    u = _dot3(rel, right) / z_safe                   # perspective
    v = _dot3(rel, up) / z_safe
    umin, umax = u.amin(1, keepdim=True), u.amax(1, keepdim=True)
    vmin, vmax = v.amin(1, keepdim=True), v.amax(1, keepdim=True)
    span = torch.clamp_min(torch.maximum(umax - umin, vmax - vmin), 1e-9)
    px = ((u - umin) / span * (res - 1)).to(torch.int32).clamp(0, res - 1)
    py = ((v - vmin) / span * (res - 1)).to(torch.int32).clamp(0, res - 1)
    # one scatter-min over all splat offsets
    offs = torch.arange(-splat, splat + 1, dtype=torch.int32, device=dev)
    oy = offs.repeat_interleave(2 * splat + 1)[:, None]
    ox = offs.repeat(2 * splat + 1)[:, None]
    qx = (px[:, None, :] + ox).clamp(0, res - 1)     # [V,F,N]
    qy = (py[:, None, :] + oy).clamp(0, res - 1)
    idx = (qy * res + qx).reshape(len(eye), -1).long()
    zrep = z[:, None, :].expand(qx.shape).reshape(len(eye), -1)
    zbuf = torch.full((len(eye), res * res), float("inf"), device=dev)
    zbuf.scatter_reduce_(1, idx, zrep, "amin", include_self=True)
    slack = tol * (z.amax(1, keepdim=True) - z.amin(1, keepdim=True) + 1e-9)
    own = torch.gather(zbuf, 1, (py * res + px).long())
    return z <= own + slack


def auto_zbuffer_res(n_points: int) -> int:
    """Pick a grid resolution matched to cloud density (≈0.8·sqrt(N))."""
    return int(np.clip(0.8 * np.sqrt(n_points), 32, 160))


def select_best_view(points: torch.Tensor, viewpoints: torch.Tensor,
                     n_coarse: int = 2500, topk: int = 48) -> torch.Tensor:
    """Coarse-to-exact viewpoint selection: argmax visible count over views.

    A coarse pass on an FPS prefix (``points`` must be FPS-ordered) with no
    splat footprint ranks all views; the full-density z-buffer re-scores
    the ``topk`` best.  The candidate order is a stable descending sort,
    which puts the lower view index first on equal counts, as
    ``lax.top_k`` does.  Returns the int64 index of the best view."""
    nc = min(n_coarse, points.shape[0])
    k = min(topk, viewpoints.shape[0])
    coarse = visible_points_zbuffer(points[:nc], viewpoints,
                                    res=auto_zbuffer_res(nc), splat=0)
    cand = torch.sort(coarse.sum(-1), descending=True, stable=True)[1][:k]
    exact = visible_points_zbuffer(points, viewpoints[cand],
                                   res=auto_zbuffer_res(points.shape[0]),
                                   splat=1)
    return cand[torch.argmax(exact.sum(-1))]


def visible_points(points, viewpoints, radius_param: float,
                   method: str = "zbuffer", res: int | None = None,
                   device: torch.device | str = "cuda") -> np.ndarray:
    """Dispatch: 'zbuffer' (on ``device``, all views at once) or 'hpr'
    (exact, a host loop over the views).  Returns a bool array [V, N]
    (reference: DepthPrompting.py:273-290)."""
    viewpoints = np.atleast_2d(np.asarray(viewpoints, np.float64))
    if method == "zbuffer":
        if res is None:
            res = auto_zbuffer_res(len(points))
        f32 = dict(dtype=torch.float32, device=device)
        return visible_points_zbuffer(
            torch.as_tensor(np.asarray(points), **f32),
            torch.as_tensor(viewpoints, **f32), res=res).cpu().numpy()
    pts = np.asarray(points)
    out = np.zeros((len(viewpoints), len(pts)), bool)
    for i, vp in enumerate(viewpoints):
        out[i] = hidden_point_removal(pts, vp, radius_param)
    return out

"""Point splatting into depth/colour images + hole masks (counterpart of
genpc_tpu/render/splat.py; reference: DepthPrompting.py:292-391).

Where several points land on one pixel, the reference's scatter-set has
no defined winner.  Here the winner is deterministic: the highest point
index, found with a ``scatter_reduce_("amax")`` of point indices, whose
colour is then gathered.  Brush offsets are painted in the reference's
order, so a later offset overwrites an earlier one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def paint_pixels(img: torch.Tensor, pixel_coords: torch.Tensor,
                 pixel_colors, point_size: int = 1, flip: bool = True,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter colours into an image with a square brush.

    img [C,R,R]; pixel_coords [N,2] as (row, col); pixel_colors [N,C] or a
    scalar.  The brush covers offsets (-point_size+1 .. point_size-1)²;
    out-of-bounds brush pixels are dropped; ``valid`` (bool [N]) masks
    points out.  The result is flipped vertically unless flip=False."""
    C, R, _ = img.shape
    dev = img.device
    coords = pixel_coords.to(torch.int64)
    n = coords.shape[0]
    colors = torch.as_tensor(pixel_colors, dtype=torch.float32, device=dev)
    if colors.ndim == 0 or colors.shape == (1,):
        colors = colors.reshape(()).expand(n, C)
    flat = img.reshape(C, R * R).clone()
    dummy = R * R  # clipped-out writes land here
    point_ids = torch.arange(n, device=dev)
    for dy in range(-point_size + 1, point_size):
        for dx in range(-point_size + 1, point_size):
            r = coords[:, 0] + dy
            c = coords[:, 1] + dx
            ok = (r >= 0) & (r < R) & (c >= 0) & (c < R)
            if valid is not None:
                ok = ok & valid
            idx = torch.where(ok, r * R + c, dummy)
            winner = torch.full((R * R + 1,), -1, dtype=torch.int64,
                                device=dev)
            winner.scatter_reduce_(0, idx, point_ids, "amax",
                                   include_self=True)
            winner = winner[:R * R]
            flat = torch.where(winner >= 0, colors[winner.clamp_min(0)].T,
                               flat)
    out = flat.reshape(C, R, R)
    return out.flip(1) if flip else out


def raw_depth_images(point_pixels: torch.Tensor, point_depth: torch.Tensor,
                     colors: torch.Tensor, res: int = 256,
                     point_size: int = 1, mask_pixel_rate: int = 3,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Sparse colour/depth images + two hole masks.

    point_pixels [N,2] (row,col), point_depth [N], colors [N,3], valid
    optional bool [N] (invisible points are masked out of the images and
    of the depth normalisation).  Returns (sparse_img, raw_depth,
    hole_mask1, hole_mask2), each [3,res,res] float in [0,1]."""
    dev = point_depth.device
    zero = torch.zeros((3, res, res), dtype=torch.float32, device=dev)
    d = point_depth.to(torch.float32)
    if valid is not None:
        dmin = torch.where(valid, d, float("inf")).min()
        dmax = torch.where(valid, d, float("-inf")).max()
    else:
        dmin, dmax = d.min(), d.max()
    dn = (d - dmin) / torch.clamp_min(dmax - dmin, 1e-12)
    depth_col = (0.1 + 0.8 * (1.0 - dn))[:, None].repeat(1, 3)

    sparse_img = paint_pixels(zero, point_pixels, colors, point_size,
                              valid=valid)
    raw_depth = paint_pixels(zero, point_pixels, depth_col, point_size,
                             valid=valid)
    all_front = (paint_pixels(zero, point_pixels, colors,
                              point_size * mask_pixel_rate,
                              valid=valid) != 0).to(torch.float32)
    all_back = 1.0 - all_front
    front = (sparse_img != 0).to(torch.float32)
    back = 1.0 - front
    # binary XOR of 0/1 masks == absolute difference
    hole_mask1 = (all_back - back).abs()
    hole_mask2 = (all_front - back).abs()
    return sparse_img, raw_depth, hole_mask1, hole_mask2


def uvs_to_pixels(uvs: torch.Tensor, res: int) -> torch.Tensor:
    """UV [N,2] in [0,1] -> integer (row, col) pixels, clipped
    (reference: DepthPrompting.py:179-184)."""
    p = (uvs * res).to(torch.int32)
    p = torch.stack([p[:, 1], p[:, 0]], dim=-1)
    return p.clamp(0, res - 1)

"""Depth-image hole inpainting by diffusion (counterpart of
genpc_tpu/render/inpaint.py ``diffusion_inpaint``).

Hole pixels relax by repeated 4-neighbour averaging toward the harmonic
fill with the known pixels as boundary.  ``torch.roll`` is periodic like
``jnp.roll``, so the image border wraps exactly as in the reference.
The cv2 ``INPAINT_NS`` host backend is not ported.
"""

from __future__ import annotations

import torch


def diffusion_inpaint(img: torch.Tensor, hole_mask: torch.Tensor,
                      iters: int = 250) -> torch.Tensor:
    """Fill hole pixels by iterative 4-neighbour diffusion.

    img [...,C,H,W] float; hole_mask [...,H,W] or [...,C,H,W] (any
    nonzero = hole; a channel axis is reduced by max).  Leading axes
    batch independent images."""
    x = img.to(torch.float32)
    m = hole_mask.to(torch.float32)
    if m.ndim == x.ndim:
        m = m.amax(dim=-3)
    hole = (m > 0.5).unsqueeze(-3)
    known = ~hole

    # seed holes with the mean of the known pixels for faster relaxation
    known_mean = (x * known).sum(dim=(-2, -1)) / torch.clamp_min(
        known.sum(dim=(-2, -1)), 1)
    x = torch.where(hole, known_mean[..., None, None], x)
    for _ in range(iters):
        s = (torch.roll(x, 1, dims=-2) + torch.roll(x, -1, dims=-2)
             + torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1))
        x = torch.where(hole, s / 4.0, x)
    return x

"""Depth-image hole inpainting (counterpart of
genpc_tpu/render/inpaint.py).

``diffusion_inpaint`` (the reference's device default, ``inpainter:
jax``): hole pixels relax by repeated 4-neighbour averaging toward the
harmonic fill with the known pixels as boundary.  ``torch.roll`` is
periodic like ``jnp.roll``, so the image border wraps exactly as in the
reference.  ``inpaint_image(..., backend="cv2")`` is the reference's
host backend, OpenCV's Navier-Stokes inpainting on uint8 images, run on
the host as there (cv2 is imported only then).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain.ops.rowsum import sum_dims


def diffusion_inpaint(img: torch.Tensor, hole_mask: torch.Tensor,
                      iters: int = 250) -> torch.Tensor:
    """Fill hole pixels by iterative 4-neighbour diffusion.

    img [...,C,H,W] float; hole_mask [...,H,W] or [...,C,H,W] (any
    nonzero = hole; a channel axis is reduced by max).  Leading axes
    batch independent images (on the card each image's mean is summed
    alone, ``ops/rowsum``, so a batch of any size fills it alike)."""
    x = img.to(torch.float32)
    m = hole_mask.to(torch.float32)
    if m.ndim == x.ndim:
        m = m.amax(dim=-3)
    hole = (m > 0.5).unsqueeze(-3)
    known = ~hole

    # seed holes with the mean of the known pixels for faster relaxation
    known_mean = sum_dims(x * known, (-2, -1)) / torch.clamp_min(
        known.sum(dim=(-2, -1)), 1)
    x = torch.where(hole, known_mean[..., None, None], x)
    for _ in range(iters):
        s = (torch.roll(x, 1, dims=-2) + torch.roll(x, -1, dims=-2)
             + torch.roll(x, 1, dims=-1) + torch.roll(x, -1, dims=-1))
        x = torch.where(hole, s / 4.0, x)
    return x


def inpaint_image(img, hole_mask, backend: str = "jax",
                  iters: int = 250) -> torch.Tensor:
    """Dispatch: 'jax' (the diffusion fill, on img's device) or 'cv2'
    (``cv2.inpaint(..., 2, cv2.INPAINT_NS)`` on the host, as the
    reference: the image and mask through uint8, the result / 255 on the
    CPU).  img [C, H, W] in [0, 1] (numpy or torch); returns that layout
    in fp32."""
    if backend == "cv2":
        import cv2

        def host(a):
            return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
        img_np = (host(img).transpose(1, 2, 0) * 255).astype(np.uint8)
        m = host(hole_mask)
        if m.ndim == 3:
            m = m.max(axis=0)
        mask_np = (m * 255).astype(np.uint8)
        out = cv2.inpaint(img_np, mask_np, 2, cv2.INPAINT_NS)
        return torch.from_numpy(
            out.transpose(2, 0, 1).astype(np.float32) / np.float32(255.0))
    if backend != "jax":
        raise ValueError(f"unknown inpaint backend {backend!r}")
    return diffusion_inpaint(torch.as_tensor(img), torch.as_tensor(hole_mask),
                             iters=iters)

"""2D image utilities (counterpart of genpc_tpu/render/image_ops.py;
reference: utils/utils_2d.py): morphology, Scharr edges, a bilateral
filter and image concatenation in plain torch on the inputs' device;
``naive_inpainting`` is a host op through scipy's ``griddata``, as in the
reference (utils_2d.py:529-572).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def dilate(mask, iterations: int = 1) -> torch.Tensor:
    """Binary 3x3 dilation of mask [H,W] (float or bool)."""
    m = _f32(mask)[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, 3, 1, 1)
    return m[0, 0]


def erode(mask, iterations: int = 1) -> torch.Tensor:
    """Binary 3x3 erosion (outside the image counts as set, as the
    reference's reduce_window with init -1 over -mask)."""
    m = _f32(mask)[None, None]
    for _ in range(iterations):
        m = -F.max_pool2d(-m, 3, 1, 1)
    return m[0, 0]


def fill_hole(mask, iterations: int = 2) -> torch.Tensor:
    """Morphological close (reference: utils_2d.py:511-528)."""
    return erode(dilate(mask, iterations), iterations)


def naive_inpainting(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Interpolation fill of masked pixels (reference: utils_2d.py:529-572):
    img [H,W,C]; mask [H,W] nonzero = hole.  Host scipy griddata, linear
    with the nearest value where linear has none."""
    from scipy.interpolate import griddata
    img = np.asarray(img, np.float64)
    m = np.asarray(mask) > 0.5
    if not m.any():
        return img
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    known = ~m
    pts = np.stack([yy[known], xx[known]], axis=1)
    q = np.stack([yy[m], xx[m]], axis=1)
    out = img.copy()
    for c in range(img.shape[2]):
        vals = griddata(pts, img[..., c][known], q, method="linear")
        nn = griddata(pts, img[..., c][known], q, method="nearest")
        out[..., c][m] = np.where(np.isnan(vals), nn, vals)
    return out


def scharr_edges(img) -> torch.Tensor:
    """Scharr gradient magnitude (reference: utils_2d.py:725-780): img
    [H,W] or [H,W,C] (channel mean) -> [H,W], zero padding."""
    g = _f32(img)
    if g.ndim == 3:
        g = g.mean(-1)
    kx = torch.tensor([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                      dtype=torch.float32, device=g.device)
    k = torch.stack([kx, kx.T])[:, None]               # [2,1,3,3]
    # the reference's conv_general_dilated is a correlation, as conv2d
    gx, gy = F.conv2d(g[None, None], k, padding=1)[0]
    return torch.sqrt(gx.square() + gy.square())


def bilateral_filter(img, radius: int = 2, sigma_space: float = 2.0,
                     sigma_color: float = 0.1) -> torch.Tensor:
    """Edge-preserving smoothing (reference: utils_2d.py:782-850) of img
    [H,W,C] in [0,1]: the (2r+1)² neighbours of each pixel (wrapping at
    the borders, as the reference's roll), weighted by distance and by
    colour difference, summed in the reference's (dy, dx) order."""
    x = _f32(img)
    acc = torch.zeros_like(x)
    wacc = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(x, (dy, dx), dims=(0, 1))
            w_s = math.exp(-(dy * dy + dx * dx) / (2 * sigma_space ** 2))
            dc = (shifted - x).square().sum(-1)
            w = w_s * torch.exp(-dc / (2 * sigma_color ** 2))
            acc = acc + shifted * w[..., None]
            wacc = wacc + w
    return acc / wacc[..., None]


def cat_images(images, axis: int = 1, pad: int = 0, pad_value: float = 1.0
               ) -> np.ndarray:
    """Concatenate [H,W,C] images with optional padding bars (reference:
    utils_2d.py:95-210)."""
    images = [np.asarray(im) for im in images]
    if pad:
        h, w, c = images[0].shape
        bar = np.full((h, pad, c) if axis == 1 else (pad, w, c), pad_value,
                      images[0].dtype)
        out = []
        for i, im in enumerate(images):
            out.append(im)
            if i < len(images) - 1:
                out.append(bar)
        images = out
    return np.concatenate(images, axis=axis)

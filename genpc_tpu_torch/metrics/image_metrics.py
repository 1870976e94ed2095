"""2D image metrics: MSE, PSNR, SSIM and a feature-space FID (counterpart
of genpc_tpu/metrics/image_metrics.py; reference: utils/metric_utils
psnr_ssmi.py, fid.py).  MSE, PSNR and SSIM are plain torch on the
inputs' device; the Fréchet distance takes the matrix square root on the
host through scipy, as the reference.  The feature extractor is
pluggable; the default is downsampled grayscale pixels (no checkpoint).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def mse(a, b) -> torch.Tensor:
    a = _f32(a)
    return (a - _f32(b).to(a.device)).square().mean()


def psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range ** 2
                              / torch.clamp_min(mse(a, b), 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-x.square() / (2 * sigma ** 2))
    k = torch.outer(g, g)
    return k / k.sum()


def ssim(a, b, data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over channels of a, b [H,W,C] (or [H,W]): an 11×11
    Gaussian window (sigma 1.5) over the valid region."""
    a = _f32(a)
    b = _f32(b).to(a.device)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel(device=a.device)[None, None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def filt(x):
        return F.conv2d(x.permute(2, 0, 1)[:, None], k)[:, 0]

    mu_a, mu_b = filt(a), filt(b)
    var_a = filt(a * a) - mu_a.square()
    var_b = filt(b * b) - mu_b.square()
    cov = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a.square() + mu_b.square() + c1) * (var_a + var_b + c2))
    return s.mean()


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets [N,D] (reference: fid.py:9-81)."""
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean, _ = scipy.linalg.sqrtm(s1 @ s2, disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1 + s2 - 2.0 * covmean))


def default_feature_extractor(images, dim: int = 64) -> np.ndarray:
    """Checkpoint-free embedding of images [N,H,W,C] (or [H,W,C]): the
    grayscale image resized to sqrt(dim)² by bilinear interpolation
    (``jax.image.resize(..., "linear")``, which antialiases when it
    shrinks, as ``F.interpolate(..., antialias=True)`` does)."""
    x = _f32(images)
    if x.ndim == 3:
        x = x[None]
    g = x.mean(-1)[:, None]
    side = int(np.sqrt(dim))
    g = F.interpolate(g, size=(side, side), mode="bilinear",
                      align_corners=False, antialias=True)
    return g.reshape(x.shape[0], -1).cpu().numpy()


def fid(images_a, images_b,
        feature_fn: Optional[Callable] = None) -> float:
    fn = feature_fn or default_feature_extractor
    return frechet_distance(fn(np.asarray(images_a)),
                            fn(np.asarray(images_b)))

"""Diffusion samplers (counterpart of genpc_tpu/models/schedulers.py).

  * ``EulerAncestral`` — the SDXL ControlNet path (30 steps);
  * ``DDIM`` — deterministic (eta = 0);
  * ``FlowMatchEuler`` — rectified-flow sampling for the DiT backends.

The tables are computed in float64 with numpy and stored as fp32 tensors
on the sampler's device; every step's arithmetic is fp32 on that device,
as in the reference, so the loop never waits for the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def betas_scaled_linear(num_train: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """The SD/SDXL 'scaled_linear' beta schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                       num_train, dtype=np.float64) ** 2


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def at(table: torch.Tensor, i):
    """table[i] for a step index that is an int or a [1] index tensor on
    the table's device (a CUDA graph of a step reads its index from a
    buffer: ``index_select`` keeps the read on the device)."""
    if isinstance(i, torch.Tensor):
        return table.index_select(0, i)
    return table[i]


@dataclass
class EulerAncestral:
    """Euler-ancestral sampler over the discrete sigma schedule
    ('linspace' + 'epsilon': SDXL ControlNet; 'trailing' + 'v':
    zero123plus)."""
    num_steps: int
    num_train: int = 1000
    spacing: str = "linspace"
    prediction: str = "epsilon"
    device: torch.device | str = "cpu"

    def __post_init__(self):
        betas = betas_scaled_linear(self.num_train)
        alphas_cum = np.cumprod(1.0 - betas)
        sigmas_full = np.sqrt((1 - alphas_cum) / alphas_cum)
        if self.spacing == "trailing":
            ts = (np.arange(self.num_train, 0,
                            -self.num_train / self.num_steps)
                  .round() - 1).astype(np.float64)
        else:   # diffusers default 'linspace'
            ts = np.linspace(0, self.num_train - 1, self.num_steps)[::-1]
        sig = np.interp(ts, np.arange(self.num_train), sigmas_full)
        self.timesteps = _f32(ts, self.device)
        self.sigmas = _f32(np.append(sig, 0.0), self.device)
        self.init_noise_sigma = float(np.sqrt(sig[0] ** 2 + 1.0))

    def scale_model_input(self, sample, i):
        return sample / torch.sqrt(at(self.sigmas, i) ** 2 + 1.0)

    def add_noise(self, x0, noise, i):
        """Unscaled sample at step i's noise level: x0 + sigma * noise."""
        return x0 + at(self.sigmas, i) * noise

    def pred_x0(self, model_out, i, sample):
        sigma = at(self.sigmas, i)
        if self.prediction == "v":
            return (sample / (sigma ** 2 + 1.0)
                    - model_out * sigma / torch.sqrt(sigma ** 2 + 1.0))
        return sample - sigma * model_out

    def step(self, model_out, i, sample, noise):
        """One ancestral step; noise ~ N(0, 1) of the sample's shape; i an
        int or a [1] index tensor."""
        sigma = at(self.sigmas, i)
        sigma_next = at(self.sigmas, i + 1)
        pred_x0 = self.pred_x0(model_out, i, sample)
        var = torch.clamp_min(sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
                              / torch.clamp_min(sigma ** 2, 1e-12), 0.0)
        sigma_up = torch.sqrt(var)
        sigma_down = torch.sqrt(torch.clamp_min(sigma_next ** 2 - var, 0.0))
        derivative = (sample - pred_x0) / torch.clamp_min(sigma, 1e-12)
        sample = sample + derivative * (sigma_down - sigma)
        return sample + noise * sigma_up


@dataclass
class DDIM:
    """Deterministic DDIM (eta = 0)."""
    num_steps: int
    num_train: int = 1000
    device: torch.device | str = "cpu"

    def __post_init__(self):
        betas = betas_scaled_linear(self.num_train)
        a_cum = np.cumprod(1.0 - betas).astype(np.float32)
        self.alphas_cum = _f32(a_cum, self.device)
        step = self.num_train // self.num_steps
        ts = (np.arange(self.num_steps) * step)[::-1].copy()
        self.timesteps = torch.as_tensor(ts, dtype=torch.int32,
                                         device=self.device)
        #: per step: alpha_cum at t and at the previous timestep (1 after
        #: the last step), so a step reads them with ``at``
        self.a_t = _f32(a_cum[ts], self.device)
        a_prev = a_cum[np.maximum(ts - step, 0)]
        a_prev[-1] = 1.0
        self.a_prev = _f32(a_prev, self.device)
        self.init_noise_sigma = 1.0

    def scale_model_input(self, sample, i: int):
        return sample

    def step(self, eps, i, sample, noise=None):
        """One DDIM step; i an int or a [1] index tensor."""
        a_t, a_prev = at(self.a_t, i), at(self.a_prev, i)
        x0 = (sample - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


@dataclass
class FlowMatchEuler:
    """Rectified-flow Euler sampler: x_t = (1-t)·x0 + t·noise, t from 1 to
    0, the model predicting v = noise - x0; with the FLUX timestep
    shift."""
    num_steps: int
    shift: float = 3.0
    device: torch.device | str = "cpu"

    def __post_init__(self):
        t = np.linspace(1.0, 1.0 / self.num_steps, self.num_steps)
        t = self.shift * t / (1.0 + (self.shift - 1.0) * t)
        self.timesteps = _f32(t, self.device)
        self.sigmas = _f32(np.append(t, 0.0), self.device)
        self.init_noise_sigma = 1.0

    def scale_model_input(self, sample, i: int):
        return sample

    def t_next(self, i):
        """Flow time after step i (0.0 at the end of sampling)."""
        return at(self.sigmas, i + 1)

    def step(self, velocity, i, sample, noise=None):
        """One Euler step; i an int or a [1] index tensor."""
        dt = at(self.sigmas, i + 1) - at(self.sigmas, i)
        return sample + velocity * dt


def cfg_combine(eps_uncond, eps_cond, scale):
    """Classifier-free guidance combination."""
    return eps_uncond + scale * (eps_cond - eps_uncond)

"""AutoencoderKL, the SDXL-class VAE (counterpart of genpc_tpu/models/vae.py).

NCHW, an attention mid-block, 8x spatial factor, scaling factor 0.13025.
Parameter names are the diffusers AutoencoderKL's.  Two differences from
a diffusers VAE are the reference's and kept: the mid-block attention's
q/k/v projections carry no bias, and the stride-2 downsampling convs pad
1 on every side (diffusers pads right and bottom only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    F32, Conv2d, Downsample, GroupNorm, Linear, ResnetBlock, Upsample,
    attention)


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.13025

    @property
    def spatial_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def preset(cls, name: str) -> "VAEConfig":
        if name == "tiny":
            # keeps the real ÷8 spatial factor
            return cls(block_out_channels=(32, 32, 64, 64),
                       layers_per_block=1, scaling_factor=0.13025)
        if name == "flux":
            # FLUX/Qwen-family 16-channel VAE
            return cls(latent_channels=16, scaling_factor=0.3611)
        return cls()


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over the mid-block's pixels."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels)
        self.to_q = Linear(channels, channels, bias=False)
        self.to_k = Linear(channels, channels, bias=False)
        self.to_v = Linear(channels, channels, bias=False)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)
        out = self.to_out[0](attention(self.to_q(t), self.to_k(t),
                                       self.to_v(t), heads=1))
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class _MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttnBlock(ch)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Level(nn.Module):
    """One encoder (down) or decoder (up) level: resnets, then a resampler."""

    def __init__(self, in_ch: int, ch: int, n: int, resample: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if i == 0 else ch, ch) for i in range(n)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample(ch)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample(ch)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv2d(3, boc[0])
        self.down_blocks = nn.ModuleList([
            _Level(boc[max(lvl - 1, 0)], ch, cfg.layers_per_block,
                   "down" if lvl < len(boc) - 1 else "")
            for lvl, ch in enumerate(boc)])
        self.mid_block = _MidBlock(boc[-1])
        self.conv_norm_out = GroupNorm(boc[-1])
        self.conv_out = Conv2d(boc[-1], 2 * cfg.latent_channels, compute=F32)

    def forward(self, img):
        x = self.conv_in(img)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.latent_channels, boc[-1])
        self.mid_block = _MidBlock(boc[-1])
        # diffusers up_blocks[0] is the deepest level
        levels = list(reversed(range(len(boc))))
        self.up_blocks = nn.ModuleList([
            _Level(boc[min(lvl + 1, len(boc) - 1)], boc[lvl],
                   cfg.layers_per_block + 1, "up" if lvl > 0 else "")
            for lvl in levels])
        self.conv_norm_out = GroupNorm(boc[0])
        self.conv_out = Conv2d(boc[0], 3, compute=F32)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg.latent_channels
        self.quant_conv = Conv2d(2 * lc, 2 * lc, k=1, compute=F32)
        self.post_quant_conv = Conv2d(lc, lc, k=1, compute=F32)

    def encode(self, img, generator: torch.Generator | None = None):
        """img [B,3,H,W] in [-1,1] -> scaled latents (the mode without a
        generator, a sample with one)."""
        mean, logvar = self.quant_conv(self.encoder(img)).chunk(2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30, 20))
            mean = mean + std * torch.randn(mean.shape, generator=generator,
                                            device=mean.device)
        return mean * self.cfg.scaling_factor

    def decode(self, latents):
        """Scaled latents -> image [B,3,H,W] in [-1,1]."""
        return self.decoder(
            self.post_quant_conv(latents / self.cfg.scaling_factor))

    def forward(self, img, generator: torch.Generator | None = None):
        return self.decode(self.encode(img, generator))

"""Conditional latent-diffusion UNet and ControlNet (counterpart of
genpc_tpu/models/unet.py).

The SDXL-class UNet2DConditionModel the reference drives, NCHW, with
diffusers' parameter names (``down_blocks.1.attentions.0...``,
``mid_block``, ``up_blocks.0`` the deepest level, ``controlnet_down_
blocks.N``), so a real checkpoint loads by name.  ``UNetCore`` holds the
down+mid trunk the UNet and the ControlNet share; both subclass it, so
the trunk's names carry no prefix, as in diffusers.

Two behaviours of the reference are kept for parity (ROADMAP queue 3
lists them against diffusers): ``silu`` is applied to the time embedding
before the blocks and again inside every ResnetBlock, and the
ControlNet's residuals reach only the conditional CFG branch (the
caller's choice, models/controlnet_depth.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    F32, Conv2d, Downsample, GroupNorm, ResnetBlock, SpatialTransformer,
    TimestepEmbed, Upsample, timestep_embedding)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    layers_per_block: int = 2
    transformer_depths: Tuple[int, ...] = (0, 2, 10)   # per resolution level
    context_dim: int = 2048
    attention_head_dim: int = 64
    addition_embed_dim: int = 0      # SDXL micro-conditioning (2816)
    time_embed_dim: Optional[int] = None
    mid_depth: Optional[int] = None  # None -> transformer_depths[-1]

    @property
    def temb_dim(self) -> int:
        return self.time_embed_dim or self.block_out_channels[0] * 4

    @classmethod
    def preset(cls, name: str) -> "UNetConfig":
        if name == "tiny":
            # addition_embed_dim = tiny pooled (64) + 6 x 256 time-id
            # sinusoids: the tiny preset runs the micro-conditioning too
            return cls(block_out_channels=(32, 64),
                       layers_per_block=1, transformer_depths=(0, 1),
                       context_dim=64, attention_head_dim=16,
                       addition_embed_dim=64 + 6 * 256)
        if name == "base":   # SD-1.5 class
            return cls(block_out_channels=(320, 640, 1280, 1280),
                       layers_per_block=2,
                       transformer_depths=(1, 1, 1, 0),
                       context_dim=768, attention_head_dim=8)
        if name == "sdxl":
            return cls(block_out_channels=(320, 640, 1280),
                       layers_per_block=2, transformer_depths=(0, 2, 10),
                       context_dim=2048, attention_head_dim=64,
                       addition_embed_dim=2816)
        if name == "sd2":
            # zero123plus v1.2 backbone (SD-2.1 class)
            return cls(block_out_channels=(320, 640, 1280, 1280),
                       layers_per_block=2,
                       transformer_depths=(1, 1, 1, 0), mid_depth=1,
                       context_dim=1024, attention_head_dim=64)
        raise ValueError(name)

    def transformer(self, ch: int, depth: int) -> SpatialTransformer:
        return SpatialTransformer(ch, ch // self.attention_head_dim, depth,
                                  self.context_dim)


class CrossAttnDownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int,
                 tf_depth: int, add_downsample: bool):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, cfg.temb_dim)
            for i in range(n)])
        if tf_depth > 0:
            self.attentions = nn.ModuleList(
                [cfg.transformer(out_ch, tf_depth) for _ in range(n)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])

    def forward(self, x, temb, context, ref=None):
        skips = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, ref)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class CrossAttnUpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_chs: Sequence[int], out_ch: int,
                 tf_depth: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(c, out_ch, cfg.temb_dim) for c in in_chs])
        if tf_depth > 0:
            self.attentions = nn.ModuleList(
                [cfg.transformer(out_ch, tf_depth) for _ in in_chs])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])

    def forward(self, x, skips, temb, context, ref=None):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, ref)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, ch: int, tf_depth: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch, cfg.temb_dim),
                                      ResnetBlock(ch, ch, cfg.temb_dim)])
        if tf_depth > 0:
            self.attentions = nn.ModuleList([cfg.transformer(ch, tf_depth)])

    def forward(self, x, temb, context, ref=None):
        x = self.resnets[0](x, temb)
        if hasattr(self, "attentions"):
            x = self.attentions[0](x, context, ref)
        return self.resnets[1](x, temb)


def skip_channels(cfg: UNetConfig) -> List[int]:
    """Channels of the trunk's skip stack, in push order."""
    boc = cfg.block_out_channels
    chs = [boc[0]]
    for level, ch in enumerate(boc):
        chs += [ch] * cfg.layers_per_block
        if level < len(boc) - 1:
            chs.append(ch)
    return chs


class UNetCore(nn.Module):
    """The down+mid trunk and the time embedding, shared by the full
    UNet and the ControlNet."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        boc = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, boc[0])
        self.time_embedding = TimestepEmbed(boc[0], cfg.temb_dim)
        if cfg.addition_embed_dim:
            self.add_embedding = TimestepEmbed(cfg.addition_embed_dim,
                                               cfg.temb_dim)
        self.down_blocks = nn.ModuleList([
            CrossAttnDownBlock(cfg, boc[max(lvl - 1, 0)], ch,
                               cfg.transformer_depths[lvl],
                               add_downsample=lvl < len(boc) - 1)
            for lvl, ch in enumerate(boc)])
        mid_depth = (cfg.mid_depth if cfg.mid_depth is not None
                     else cfg.transformer_depths[-1])
        self.mid_block = MidBlock(cfg, boc[-1], mid_depth)

    def temb(self, t, added_cond=None):
        temb = self.time_embedding(
            timestep_embedding(t, self.cfg.block_out_channels[0]))
        if self.cfg.addition_embed_dim and added_cond is not None:
            temb = temb + self.add_embedding(added_cond)
        return F.silu(temb)

    def trunk(self, latents, temb, context, cond_residual=None,
              adapter_features=None, ref=None):
        x = self.conv_in(latents)
        if cond_residual is not None:
            x = x + cond_residual
        skips = [x]
        for level, blk in enumerate(self.down_blocks):
            if adapter_features is not None and level < len(adapter_features):
                x = x + adapter_features[level]   # T2I-adapter injection
            x, s = blk(x, temb, context, ref)
            skips += s
        return self.mid_block(x, temb, context, ref), skips


class UNet2DCondition(UNetCore):
    """Full UNet: trunk + up path; takes ControlNet residuals or T2I-adapter
    features."""

    def __init__(self, cfg: UNetConfig):
        super().__init__(cfg)
        boc = cfg.block_out_channels
        skips = skip_channels(cfg)
        x_ch = boc[-1]
        ups = []
        for level in reversed(range(len(boc))):
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(x_ch + skips.pop())
                x_ch = boc[level]
            ups.append(CrossAttnUpBlock(cfg, in_chs, boc[level],
                                        cfg.transformer_depths[level],
                                        add_upsample=level > 0))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = GroupNorm(boc[0])
        self.conv_out = Conv2d(boc[0], cfg.out_channels, compute=F32)

    def forward(self, latents, t, context, added_cond=None,
                control_residuals=None, cond_residual=None,
                adapter_features=None, ref=None):
        temb = self.temb(t, added_cond)
        x, skips = self.trunk(latents, temb, context, cond_residual,
                              adapter_features, ref)
        if control_residuals is not None:
            mid_res, down_res = control_residuals
            x = x + mid_res
            skips = [s + r for s, r in zip(skips, down_res)]
        for blk in self.up_blocks:
            x = blk(x, skips, temb, context, ref)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ControlNetConditioningEmbedding(nn.Module):
    """Depth image -> latent-resolution conditioning features:
    len(channels) - 1 stride-2 convs (SDXL: (16, 32, 96, 256), ÷8)."""

    def __init__(self, out_ch: int,
                 channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        self.conv_in = Conv2d(3, channels[0])
        blocks = []
        for i in range(len(channels) - 1):
            blocks += [Conv2d(channels[i], channels[i]),
                       Conv2d(channels[i], channels[i + 1], stride=2)]
        self.blocks = nn.ModuleList(blocks)
        # diffusers zero_module(Conv2d(..., kernel_size=3)), in fp32
        self.conv_out = Conv2d(channels[-1], out_ch, compute=F32)

    def forward(self, cond_image):
        x = F.silu(self.conv_in(cond_image))
        for blk in self.blocks:
            x = F.silu(blk(x))
        return self.conv_out(x)


class ZeroConv(Conv2d):
    """The 1x1 fp32 conv of a ControlNet residual tap (zero-initialised
    in training)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, k=1, compute=F32)


class ControlNet(UNetCore):
    """UNet trunk + zero-conv residual taps: returns (mid residual, [down
    residuals]) shaped to add onto the full UNet's skip stack."""

    def __init__(self, cfg: UNetConfig,
                 cond_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__(cfg)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            cfg.block_out_channels[0], cond_channels)
        self.controlnet_down_blocks = nn.ModuleList(
            [ZeroConv(c) for c in skip_channels(cfg)])
        self.controlnet_mid_block = ZeroConv(cfg.block_out_channels[-1])

    def forward(self, latents, t, context, cond_image, added_cond=None,
                conditioning_scale: float = 1.0):
        temb = self.temb(t, added_cond)
        cond = self.controlnet_cond_embedding(cond_image)
        x, skips = self.trunk(latents, temb, context, cond_residual=cond)
        down = [zc(s) * conditioning_scale
                for zc, s in zip(self.controlnet_down_blocks, skips)]
        return self.controlnet_mid_block(x) * conditioning_scale, down

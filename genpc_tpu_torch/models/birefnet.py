"""BiRefNet, the matting network of RMBG-2.0 (counterpart of
genpc_tpu/models/birefnet.py).

A Swin-v1 dense-prediction backbone (``bb``: patch embedding, four
stages of window-attention blocks with a shifted window every second
block, patch merging between stages, an out-norm per stage) feeds a
progressive decoder (``squeeze_module``, ``decoder.decoder_block4..1``,
the lateral 1x1 convolutions, the ``gdt_convs`` guidance gates and
``conv_out1``); the result is a sigmoid matte at the input size.
``BiRefNetConfig.preset("full")`` is Swin-v1-Large at 1024²; "tiny" is
the test preset.

Parameter names are the public RMBG-2.0 checkpoint's
(``bb.layers.N.blocks.M.attn.qkv``, ``decoder.gdt_convs_4.0``, ...), so
``weights.load_matting`` is a strict load by name; BatchNorm keeps the
checkpoint's running statistics as buffers.  The window attention's
relative position index and the shifted windows' masks are computed,
not stored (a checkpoint's ``relative_position_index`` and ``attn_mask``
buffers are dropped).

Behaviours of the reference kept for parity (ROADMAP queue 3 lists them
against the public model): flax's defaults (LayerNorm eps 1e-6, the
tanh GELU in the MLP), each block padding H and W up to a multiple of
the window after ``norm1`` with the shift mask computed on the padded
grid and -1e9 where the public model has -100, the patch-merging order
(0,0), (1,0), (0,1), (1,1), the ``jax.image.resize`` bilinear upsampling
(equal to ``F.interpolate(mode="bilinear", align_corners=False)`` at
these integer factors, edges included), and the compute types: bf16
dense layers and convolutions, fp32 norms, the guidance gates and
``conv_out1`` in fp32.  Attention follows ``jax.nn.dot_product_attention``:
fp32 logits of the bf16 queries and keys, the bias added in fp32, the
softmax cast back to bf16 before the product with the values.

Layout: images NCHW; the backbone works channels-last [B, H, W, C].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    F32, BatchNorm2dInference, Conv2d, LayerNorm, Linear, box, gelu_tanh)


@dataclass(frozen=True)
class BiRefNetConfig:
    embed_dim: int = 192                    # swin_v1_large
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 12
    patch: int = 4
    img_size: int = 1024
    dec_inter: int = 64                     # BasicDecBlk hidden width
    gdt_ch: int = 64                        # guidance branch width

    @property
    def channels(self) -> Tuple[int, ...]:
        d = self.embed_dim
        return (d, 2 * d, 4 * d, 8 * d)

    @classmethod
    def preset(cls, name: str) -> "BiRefNetConfig":
        if name == "tiny":
            return cls(embed_dim=16, depths=(1, 1, 1, 1),
                       num_heads=(2, 2, 2, 2), window=4, patch=4,
                       img_size=64, dec_inter=8, gdt_ch=8)
        return cls()


# ------------------------------------------------------------------ Swin

def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nw, w * w, C] (row-major windows)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int
                   ) -> torch.Tensor:
    b = x.shape[0] // ((h // w) * (wd // w))
    x = x.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def relative_position_index(w: int) -> np.ndarray:
    """The Swin (2w-1)^2 bias-table index for a w*w window."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij"))            # [2,w,w]
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]                # [2,T,T]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """The additive mask [nw, T, T] of the shifted windows of an h x w
    (padded) grid: -1e9 between tokens of different regions."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = window_partition(torch.from_numpy(img_mask), ws)[..., 0].numpy()
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -1e9, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        #: the bias table's index, computed (not a buffer: a module
        #: materialised with ``to_empty`` would lose its values)
        self._index = torch.from_numpy(
            relative_position_index(window)).reshape(-1)

    def forward(self, x, mask=None):
        """x [nW, T, C]; mask [nw_per_img, T, T] additive or None."""
        nw, t, c = x.shape
        hd = c // self.heads
        q, k, v = (a.reshape(nw, t, self.heads, hd).transpose(1, 2)
                   for a in self.qkv(x).chunk(3, dim=-1))
        table = self.relative_position_bias_table
        if self._index.device != table.device:
            self._index = self._index.to(table.device)
        bias = table.to(F32)[self._index]
        bias = bias.reshape(t, t, self.heads).permute(2, 0, 1)[None]
        if mask is not None:
            # the windows of every image of the batch take the same masks
            bias = bias + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]
        logits = torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2)) \
            * (1.0 / math.sqrt(hd)) + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        att = torch.matmul(probs, v).transpose(1, 2).reshape(nw, t, c)
        return self.proj(att)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = box(fc1=Linear(dim, 4 * dim), fc2=Linear(4 * dim, dim))
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_mask(h, w, self.window, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x):
        """x [B, H, W, C]; H and W padded up to window multiples after
        norm1 (the Swin forward's padding)."""
        _, h0, w0, _ = x.shape
        ws, s = self.window, self.shift
        res = x
        x = self.norm1(x)
        pad_h, pad_w = (-h0) % ws, (-w0) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        h, w = h0 + pad_h, w0 + pad_w
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        wins = self.attn(window_partition(x, ws),
                         self._mask(h, w, x.device) if s else None)
        x = window_reverse(wins, ws, h, w)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = res + x[:, :h0, :w0]
        h2 = gelu_tanh(self.mlp.fc1(self.norm2(x)))
        return x + self.mlp.fc2(h2)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # swin concat order: x0=(0,0) x1=(1,0) x2=(0,1) x3=(1,1)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        return self.reduction(self.norm(x))


class SwinBackbone(nn.Module):
    """Microsoft Swin-v1 dense-prediction backbone (BiRefNet's ``bb``):
    images [B, 3, H, W] -> the four stages' out-normed features [B, h, w,
    C] at strides 4, 8, 16, 32."""

    def __init__(self, cfg: BiRefNetConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = box(
            proj=Conv2d(3, cfg.embed_dim, k=cfg.patch, stride=cfg.patch,
                        padding=0),
            norm=LayerNorm(cfg.embed_dim))
        layers = []
        for l, depth in enumerate(cfg.depths):
            dim = cfg.channels[l]
            stage = box(blocks=nn.ModuleList([
                SwinBlock(dim, cfg.num_heads[l], cfg.window,
                          0 if b % 2 == 0 else cfg.window // 2)
                for b in range(depth)]))
            if l < len(cfg.depths) - 1:
                stage.downsample = PatchMerging(dim)
            layers.append(stage)
        self.layers = nn.ModuleList(layers)
        for l in range(len(cfg.depths)):
            self.add_module(f"norm{l}", LayerNorm(cfg.channels[l]))

    def forward(self, img):
        x = self.patch_embed.proj(img).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        outs = []
        for l, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            outs.append(getattr(self, f"norm{l}")(x))
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        return outs


# --------------------------------------------------------------- decoder

class BasicDecBlk(nn.Module):
    """conv_in -> bn_in -> relu -> conv_out -> bn_out."""

    def __init__(self, in_ch: int, out_ch: int, inter: int):
        super().__init__()
        self.conv_in = Conv2d(in_ch, inter)
        self.bn_in = BatchNorm2dInference(inter)
        self.conv_out = Conv2d(inter, out_ch)
        self.bn_out = BatchNorm2dInference(out_ch)

    def forward(self, x):
        x = F.relu(self.bn_in(self.conv_in(x)))
        return self.bn_out(self.conv_out(x))


def _upsample(x, factor: int):
    """``jax.image.resize(..., "bilinear")`` by an integer factor."""
    return F.interpolate(x, scale_factor=float(factor), mode="bilinear",
                         align_corners=False)


class BiRefNet(nn.Module):
    """Backbone + progressive decoder: images [B, 3, H, W] normalised as
    x - 0.5 -> the sigmoid matte [B, 1, H, W] in fp32."""

    def __init__(self, cfg: BiRefNetConfig):
        super().__init__()
        self.cfg = cfg
        ch, inter, g = cfg.channels, cfg.dec_inter, cfg.gdt_ch
        self.bb = SwinBackbone(cfg)
        self.squeeze_module = nn.ModuleList([BasicDecBlk(ch[3], ch[3],
                                                         inter)])
        dec = box(decoder_block4=BasicDecBlk(ch[3], ch[2], inter),
                  decoder_block3=BasicDecBlk(ch[2], ch[1], inter),
                  decoder_block2=BasicDecBlk(ch[1], ch[0], inter),
                  decoder_block1=BasicDecBlk(ch[0], ch[0] // 2, inter))
        for tag, c in (("4", ch[2]), ("3", ch[1]), ("2", ch[0])):
            dec.add_module(f"lateral_block{tag}", box(conv=Conv2d(c, c, k=1)))
            dec.add_module(f"gdt_convs_{tag}", nn.Sequential(
                Conv2d(c, g), BatchNorm2dInference(g), nn.ReLU()))
            dec.add_module(f"gdt_convs_attn_{tag}", nn.Sequential(
                Conv2d(g, 1, k=1, compute=F32)))
            dec.add_module(f"gdt_convs_pred_{tag}", nn.Sequential(
                Conv2d(g, 1, k=1, compute=F32)))
        dec.add_module("conv_out1", nn.Sequential(
            Conv2d(ch[0] // 2, 1, k=1, compute=F32)))
        self.decoder = dec

    def _gate(self, x, tag: str):
        """The guidance gate: x * sigmoid(attn).  (The reference also
        computes the ``gdt_convs_pred`` map and discards it.)"""
        g = getattr(self.decoder, f"gdt_convs_{tag}")(x)
        return x * torch.sigmoid(getattr(self.decoder,
                                         f"gdt_convs_attn_{tag}")(g))

    def forward(self, img):
        dec = self.decoder
        feats = [f.permute(0, 3, 1, 2) for f in self.bb(img)]
        x = self.squeeze_module[0](feats[3])
        for tag, lvl in (("4", 2), ("3", 1), ("2", 0)):
            p = self._gate(getattr(dec, f"decoder_block{tag}")(x), tag)
            lat = getattr(dec, f"lateral_block{tag}").conv(feats[lvl])
            x = _upsample(p, 2) + lat
        p1 = _upsample(dec.decoder_block1(x), self.cfg.patch)
        return torch.sigmoid(dec.conv_out1(p1))

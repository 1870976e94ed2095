"""FLUX.1-Depth-dev's networks in plain fp32 torch, for the plain
reference's FLUX backends (``dit_depth.py`` beside this file): the MMDiT,
the T5-XXL encoder, the CLIP-L text tower, the 16-channel VAE, their
seeded random weights and the FlowMatchEuler tables.

Written from the published description:
  * the MMDiT of black-forest-labs/FLUX.1-Depth-dev
    (``transformer/config.json``): 19 double-stream blocks (joint
    attention over [text, image] with a weight set per stream, AdaLN-zero
    modulation per stream) and 38 single-stream blocks (parallel attention
    and MLP, one output projection), 3,072 wide, 24 heads of 128, q/k RMS
    norms, RoPE over three position axes of (16, 56, 56) dimensions, 64
    latent and 64 depth-latent channels in (2 x 2 patches of 16 + 16), the
    timestep, the distilled guidance and the pooled CLIP-L vector summed
    into the modulation vector;
  * T5-XXL v1.1's encoder: 24 blocks, d_model 4,096, 64 heads of 64, a
    gated-GELU feed-forward of 10,240, RMS norms, unscaled attention with
    a relative-position bias (32 buckets, distance 128) that block 0 holds;
  * CLIP ViT-L/14's text tower: 12 causal layers, 768 wide, 12 heads,
    quick-GELU, the pooled vector at the end-of-text token;
  * the FLUX VAE: 16 latent channels, levels of (128, 256, 512, 512), 2
    resnets a level, a single-head attention mid-block, scaling 0.3611.

Every layer computes in float32 (``runtime`` turns TF32 off); attention is
softmax(Q Kᵀ / √d) V written out.  There is no kernel, no CUDA graph and
no quantised layer: an int4 layer's weight is its codes times its scale,
dequantised to fp32 once when the weights are drawn.  ``set_rounding``
makes every linear layer and every attention round its inputs (the
control's fp8 e4m3; the weights stay as drawn).  Parameters carry the
checkpoints' names (diffusers, HF), and ``build`` draws from them the
values the port holds (its docstring).  The departures from the
published model are listed in ``dit_depth.py``.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.plain import runtime  # noqa: F401  (TF32 off)

F32 = torch.float32
#: the norms' epsilon
EPS = 1e-6
#: the largest code of a weight-only width (symmetric codes)
QMAX = {8: 127, 4: 7}
#: the largest finite fp8 e4m3 value
FP8_MAX = 448.0


def same(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 (saturating at ±448) and back to fp32."""
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(F32)


class Module(nn.Module):
    """A module whose linear layers and attentions round their inputs by
    ``rnd`` (identity unless ``set_rounding`` says otherwise)."""
    rnd: Callable = staticmethod(same)


def set_rounding(root: nn.Module, fn: Callable) -> None:
    for m in root.modules():
        if isinstance(m, Module):
            m.rnd = fn


class Box(Module):
    """A container that only names its children."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for k, v in children.items():
            self.add_module(k, v)


class Lin(Module):
    """y = x Wᵀ + b; ``quant`` marks a layer the port holds as weight-only
    int codes (its weight drawn in that form)."""

    def __init__(self, i: int, o: int, bias: bool = True,
                 quant: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None
        self.quant = quant

    def forward(self, x):
        return F.linear(self.rnd(x), self.weight, self.bias)


class Conv(Module):
    def __init__(self, i: int, o: int, k: int = 3, stride: int = 1,
                 padding: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(o, i, k, k))
        self.bias = nn.Parameter(torch.empty(o))
        self.stride = stride
        self.padding = k // 2 if padding is None else padding

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Norm(Module):
    """The norms, whose scale a random fill sets to 1: ``kind`` 'layer'
    (with a bias), 'group' (32 groups, NCHW, with a bias) or 'rms'."""

    def __init__(self, dim: int, kind: str):
        super().__init__()
        self.kind = kind
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim)) if kind != "rms" else None

    def forward(self, x):
        if self.kind == "layer":
            return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, EPS)
        if self.kind == "group":
            return F.group_norm(x, 32, self.weight, self.bias, EPS)
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) \
            * self.weight


def attend(q, k, v, rnd=same, bias=None, causal: bool = False,
           scale: float | None = None):
    """q [B, H, T, d], k and v [B, H, S, d] -> softmax(q kᵀ · scale + bias)
    v; ``scale`` 1/√d unless given; ``causal`` hides the later keys."""
    q, k, v = rnd(q), rnd(k), rnd(v)
    s = torch.matmul(q, k.transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]) if scale is None else scale)
    if bias is not None:
        s = s + bias
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def heads(x, n: int):
    """[B, T, n·d] -> [B, n, T, d]."""
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1).transpose(1, 2)


def merge(x):
    """[B, n, T, d] -> [B, T, n·d]."""
    b, n, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, n * d)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ------------------------------------------------------------------ MMDiT

@dataclass(frozen=True)
class DiTConfig:
    hidden_dim: int = 3072
    num_heads: int = 24
    double_blocks: int = 19
    single_blocks: int = 38
    patch_size: int = 2
    in_channels: int = 16
    cond_channels: int = 16
    text_dim: int = 4096
    pooled_dim: int = 768
    axes_dim: Tuple[int, int, int] = (16, 56, 56)
    theta: int = 10000

    @classmethod
    def preset(cls, size: str) -> "DiTConfig":
        """'full': the published widths; 'tiny': the CPU tests' size."""
        if size == "tiny":
            return cls(hidden_dim=64, num_heads=4, double_blocks=2,
                       single_blocks=2, in_channels=4, cond_channels=4,
                       text_dim=64, pooled_dim=32, axes_dim=(4, 6, 6))
        return cls()


def timestep_embedding(t, dim: int = 256):
    """Sinusoidal embedding [B] -> [B, dim], [cos, sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=F32, device=t.device) / half)
    args = t.to(F32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope_table(ids, axes_dim, theta: int):
    """Position ids [T, 3] -> (cos, sin) [T, head_dim / 2]: axis a takes
    axes_dim[a] / 2 frequencies theta^(-2j / axes_dim[a])."""
    cos, sin = [], []
    for a, d in enumerate(axes_dim):
        freqs = 1.0 / (theta ** (torch.arange(d // 2, dtype=F32,
                                              device=ids.device) * 2.0 / d))
        ang = ids[:, a:a + 1].to(F32) * freqs[None]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def rope(x, cos, sin):
    """x [B, H, T, d]: each pair (x[2j], x[2j+1]) rotated by its angle."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def layer_norm(x):
    """LayerNorm without scale or bias."""
    return F.layer_norm(x, x.shape[-1:], eps=EPS)


def mlp(d: int, quant: bool) -> nn.Module:
    """diffusers FeedForward('gelu-approximate'): ``net.0.proj``, ``net.2``."""
    return Box(net=nn.ModuleList([Box(proj=Lin(d, 4 * d, quant=quant)),
                                  nn.Identity(),
                                  Lin(4 * d, d, quant=quant)]))


def run_mlp(m, x):
    return m.net[2](gelu_tanh(m.net[0].proj(x)))


class DoubleBlock(Module):
    def __init__(self, cfg: DiTConfig, quant: bool):
        super().__init__()
        d, dh = cfg.hidden_dim, cfg.hidden_dim // cfg.num_heads
        self.h = cfg.num_heads

        def lin(o=d):
            return Lin(d, o, quant=quant)
        self.norm1 = Box(linear=lin(6 * d))
        self.norm1_context = Box(linear=lin(6 * d))
        self.ff, self.ff_context = mlp(d, quant), mlp(d, quant)
        self.attn = Box(
            to_q=lin(), to_k=lin(), to_v=lin(), add_q_proj=lin(),
            add_k_proj=lin(), add_v_proj=lin(),
            to_out=nn.ModuleList([lin()]), to_add_out=lin(),
            norm_q=Norm(dh, "rms"), norm_k=Norm(dh, "rms"),
            norm_added_q=Norm(dh, "rms"), norm_added_k=Norm(dh, "rms"))

    def forward(self, img, txt, vec, cos, sin):
        sv = F.silu(vec)
        i_mod = self.norm1.linear(sv)[:, None].chunk(6, dim=-1)
        t_mod = self.norm1_context.linear(sv)[:, None].chunk(6, dim=-1)
        a, h = self.attn, self.h
        img_n = layer_norm(img) * (1 + i_mod[1]) + i_mod[0]
        txt_n = layer_norm(txt) * (1 + t_mod[1]) + t_mod[0]
        q = torch.cat([a.norm_added_q(heads(a.add_q_proj(txt_n), h)),
                       a.norm_q(heads(a.to_q(img_n), h))], dim=2)
        k = torch.cat([a.norm_added_k(heads(a.add_k_proj(txt_n), h)),
                       a.norm_k(heads(a.to_k(img_n), h))], dim=2)
        v = torch.cat([heads(a.add_v_proj(txt_n), h),
                       heads(a.to_v(img_n), h)], dim=2)
        att = merge(attend(rope(q, cos, sin), rope(k, cos, sin), v,
                           self.rnd))
        lt = txt.shape[1]
        img = img + i_mod[2] * a.to_out[0](att[:, lt:])
        txt = txt + t_mod[2] * a.to_add_out(att[:, :lt])
        img = img + i_mod[5] * run_mlp(
            self.ff, layer_norm(img) * (1 + i_mod[4]) + i_mod[3])
        txt = txt + t_mod[5] * run_mlp(
            self.ff_context, layer_norm(txt) * (1 + t_mod[4]) + t_mod[3])
        return img, txt


class SingleBlock(Module):
    def __init__(self, cfg: DiTConfig, quant: bool):
        super().__init__()
        d, dh = cfg.hidden_dim, cfg.hidden_dim // cfg.num_heads
        self.h = cfg.num_heads
        self.norm = Box(linear=Lin(d, 3 * d, quant=quant))
        self.attn = Box(to_q=Lin(d, d, quant=quant),
                        to_k=Lin(d, d, quant=quant),
                        to_v=Lin(d, d, quant=quant),
                        norm_q=Norm(dh, "rms"), norm_k=Norm(dh, "rms"))
        self.proj_mlp = Lin(d, 4 * d, quant=quant)
        self.proj_out = Lin(5 * d, d, quant=quant)

    def forward(self, x, vec, cos, sin):
        shift, scale, gate = self.norm.linear(F.silu(vec))[:, None].chunk(
            3, dim=-1)
        xn = layer_norm(x) * (1 + scale) + shift
        a, h = self.attn, self.h
        att = merge(attend(rope(a.norm_q(heads(a.to_q(xn), h)), cos, sin),
                           rope(a.norm_k(heads(a.to_k(xn), h)), cos, sin),
                           heads(a.to_v(xn), h), self.rnd))
        return x + gate * self.proj_out(
            torch.cat([att, gelu_tanh(self.proj_mlp(xn))], dim=-1))


def embedder(i: int, d: int) -> nn.Module:
    return Box(linear_1=Lin(i, d), linear_2=Lin(d, d))


def run_embedder(m, x):
    return m.linear_2(F.silu(m.linear_1(x)))


class MMDiT(Module):
    """latents [B, C, H, W] (the depth latents beside them) -> velocity
    [B, C, H, W]; ``quant`` marks every block matmul as int codes."""

    def __init__(self, cfg: DiTConfig, quant: bool = False):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_dim, cfg.patch_size
        self.x_embedder = Lin(p * p * (cfg.in_channels + cfg.cond_channels),
                              d)
        self.context_embedder = Lin(cfg.text_dim, d)
        self.time_text_embed = Box(
            timestep_embedder=embedder(256, d),
            guidance_embedder=embedder(256, d),
            text_embedder=embedder(cfg.pooled_dim, d))
        self.transformer_blocks = nn.ModuleList(
            [DoubleBlock(cfg, quant) for _ in range(cfg.double_blocks)])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleBlock(cfg, quant) for _ in range(cfg.single_blocks)])
        self.norm_out = Box(linear=Lin(d, 2 * d))
        self.proj_out = Lin(d, p * p * cfg.in_channels)

    def forward(self, latents, t, txt, pooled, cond_latents, guidance):
        cfg = self.cfg
        b, c, h, w = latents.shape
        p = cfg.patch_size
        x = torch.cat([latents, cond_latents], dim=1)
        # patches in (h, w) raster order, features in (py, px, c) order
        x = x.permute(0, 2, 3, 1).reshape(b, h // p, p, w // p, p, -1)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p), -1)
        img = self.x_embedder(x)
        tok = self.context_embedder(txt)
        te = self.time_text_embed
        vec = (run_embedder(te.timestep_embedder,
                            timestep_embedding(t * 1000.0))
               + run_embedder(te.text_embedder, pooled)
               + run_embedder(te.guidance_embedder,
                              timestep_embedding(guidance * 1000.0)))
        # text at position (0, 0, 0), image patches at (0, y, x)
        gy, gx = torch.meshgrid(torch.arange(h // p, device=x.device),
                                torch.arange(w // p, device=x.device),
                                indexing="ij")
        ids = torch.cat([
            torch.zeros(tok.shape[1], 3, dtype=torch.long, device=x.device),
            torch.stack([torch.zeros_like(gy).ravel(), gy.ravel(),
                         gx.ravel()], dim=-1)])
        cos, sin = rope_table(ids, cfg.axes_dim, cfg.theta)
        for blk in self.transformer_blocks:
            img, tok = blk(img, tok, vec, cos, sin)
        seq = torch.cat([tok, img], dim=1)
        for blk in self.single_transformer_blocks:
            seq = blk(seq, vec, cos, sin)
        img = seq[:, tok.shape[1]:]
        scale, shift = self.norm_out.linear(F.silu(vec))[:, None].chunk(
            2, dim=-1)
        out = self.proj_out(layer_norm(img) * (1 + scale) + shift)
        out = out.reshape(b, h // p, w // p, p, p, c)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)


# --------------------------------------------------------------------- T5

@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    buckets: int = 32
    max_distance: int = 128

    @classmethod
    def preset(cls, size: str) -> "T5Config":
        if size == "tiny":
            return cls(vocab_size=256, d_model=64, d_kv=16, num_heads=4,
                       d_ff=128, num_layers=2)
        return cls()


def t5_buckets(n: int, buckets: int, max_distance: int) -> np.ndarray:
    """T5's bidirectional relative-position buckets [n, n] (key minus
    query position)."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]
    nb = buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(rel, 1) / exact)
                     / np.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, nb - 1))


class T5Block(Module):
    def __init__(self, cfg: T5Config, first: bool, quant: bool):
        super().__init__()
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv

        def lin(i, o):
            return Lin(i, o, bias=False, quant=quant)
        att = Box(q=lin(d, inner), k=lin(d, inner), v=lin(d, inner),
                  o=lin(inner, d))
        if first:
            att.relative_attention_bias = nn.Embedding(cfg.buckets,
                                                       cfg.num_heads)
        self.h = cfg.num_heads
        self.layer = nn.ModuleList([
            Box(SelfAttention=att, layer_norm=Norm(d, "rms")),
            Box(DenseReluDense=Box(wi_0=lin(d, cfg.d_ff),
                                   wi_1=lin(d, cfg.d_ff),
                                   wo=lin(cfg.d_ff, d)),
                layer_norm=Norm(d, "rms"))])

    def forward(self, x, bias):
        att, ff = self.layer
        a, h = att.SelfAttention, self.h
        n = att.layer_norm(x)
        x = x + a.o(merge(attend(heads(a.q(n), h), heads(a.k(n), h),
                                 heads(a.v(n), h), self.rnd, bias=bias,
                                 scale=1.0)))
        n = ff.layer_norm(x)
        m = ff.DenseReluDense
        return x + m.wo(gelu_tanh(m.wi_0(n)) * m.wi_1(n))


class T5Encoder(Module):
    """ids [B, L], mask [B, L] bool -> hidden states [B, L, d_model], zero
    at the padding."""

    def __init__(self, cfg: T5Config, quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = Box(
            block=nn.ModuleList([T5Block(cfg, i == 0, quant)
                                 for i in range(cfg.num_layers)]),
            final_layer_norm=Norm(cfg.d_model, "rms"))

    def forward(self, ids, mask):
        cfg = self.cfg
        n = ids.shape[1]
        buckets = torch.from_numpy(t5_buckets(n, cfg.buckets,
                                              cfg.max_distance)).to(ids.device)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        bias = table[buckets].permute(2, 0, 1)[None] + torch.where(
            mask, 0.0, -1e9)[:, None, None, :]
        x = self.shared.weight[ids]
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x) * mask[..., None]


# ----------------------------------------------------------------- CLIP-L

@dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77

    @classmethod
    def preset(cls, size: str) -> "CLIPConfig":
        if size == "tiny":
            return cls(vocab_size=1024, hidden_dim=64, num_layers=2,
                       num_heads=4)
        return cls()


class CLIPLayer(Module):
    def __init__(self, d: int, h: int):
        super().__init__()
        self.h = h
        self.layer_norm1 = Norm(d, "layer")
        self.self_attn = Box(q_proj=Lin(d, d), k_proj=Lin(d, d),
                             v_proj=Lin(d, d), out_proj=Lin(d, d))
        self.layer_norm2 = Norm(d, "layer")
        self.mlp = Box(fc1=Lin(d, 4 * d), fc2=Lin(4 * d, d))

    def forward(self, x):
        a, h = self.self_attn, self.h
        n = self.layer_norm1(x)
        x = x + a.out_proj(merge(attend(heads(a.q_proj(n), h),
                                        heads(a.k_proj(n), h),
                                        heads(a.v_proj(n), h), self.rnd,
                                        causal=True)))
        y = self.mlp.fc1(self.layer_norm2(x))
        return x + self.mlp.fc2(y * torch.sigmoid(1.702 * y))


class CLIPText(Module):
    """ids [B, L] -> the pooled vector [B, hidden] (the final layer norm's
    state at the end-of-text token, the largest id)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.text_model = Box(
            embeddings=Box(
                token_embedding=nn.Embedding(cfg.vocab_size, d),
                position_embedding=nn.Embedding(cfg.max_len, d)),
            encoder=Box(layers=nn.ModuleList(
                [CLIPLayer(d, cfg.num_heads)
                 for _ in range(cfg.num_layers)])),
            final_layer_norm=Norm(d, "layer"))

    def forward(self, ids):
        tm = self.text_model
        e = tm.embeddings
        x = e.token_embedding.weight[ids] + e.position_embedding.weight[
            :ids.shape[1]][None]
        for layer in tm.encoder.layers:
            x = layer(x)
        x = tm.final_layer_norm(x)
        return x[torch.arange(x.shape[0], device=x.device),
                 torch.argmax(ids, dim=1)]


# -------------------------------------------------------------------- VAE

@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.3611

    @classmethod
    def preset(cls, size: str) -> "VAEConfig":
        if size == "tiny":
            return cls(latent_channels=4, block_out_channels=(32, 32, 64, 64),
                       layers_per_block=1, scaling_factor=0.13025)
        return cls()

    @property
    def factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


class Resnet(Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.norm1, self.conv1 = Norm(i, "group"), Conv(i, o)
        self.norm2, self.conv2 = Norm(o, "group"), Conv(o, o)
        self.conv_shortcut = Conv(i, o, k=1) if i != o else None

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x))


class VAEAttention(Module):
    def __init__(self, c: int):
        super().__init__()
        self.group_norm = Norm(c, "group")
        self.to_q = Lin(c, c, bias=False)
        self.to_k = Lin(c, c, bias=False)
        self.to_v = Lin(c, c, bias=False)
        self.to_out = nn.ModuleList([Lin(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)
        out = attend(self.to_q(t)[:, None], self.to_k(t)[:, None],
                     self.to_v(t)[:, None], self.rnd)[:, 0]
        return x + self.to_out[0](out).transpose(1, 2).reshape(b, c, h, w)


def mid_block(c: int) -> nn.Module:
    return Box(resnets=nn.ModuleList([Resnet(c, c), Resnet(c, c)]),
               attentions=nn.ModuleList([VAEAttention(c)]))


def run_mid(m, x):
    return m.resnets[1](m.attentions[0](m.resnets[0](x)))


def level(i: int, c: int, n: int, resample: str) -> nn.Module:
    box = Box(resnets=nn.ModuleList([Resnet(i if j == 0 else c, c)
                                     for j in range(n)]))
    if resample == "down":   # stride 2, padded 1 on every side
        box.downsamplers = nn.ModuleList([Box(conv=Conv(c, c, stride=2))])
    elif resample == "up":   # nearest 2x, then a 3x3 conv
        box.upsamplers = nn.ModuleList([Box(conv=Conv(c, c))])
    return box


def run_level(m, x):
    for r in m.resnets:
        x = r(x)
    if hasattr(m, "downsamplers"):
        x = m.downsamplers[0].conv(x)
    if hasattr(m, "upsamplers"):
        x = m.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0,
                                               mode="nearest"))
    return x


class VAE(Module):
    """encode: image [B, 3, H, W] in [-1, 1] -> the posterior's mean times
    the scaling factor; decode: the inverse path."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        boc, n, lc = (cfg.block_out_channels, cfg.layers_per_block,
                      cfg.latent_channels)
        last = len(boc) - 1
        self.encoder = Box(
            conv_in=Conv(3, boc[0]),
            down_blocks=nn.ModuleList([
                level(boc[max(i - 1, 0)], c, n, "down" if i < last else "")
                for i, c in enumerate(boc)]),
            mid_block=mid_block(boc[-1]),
            conv_norm_out=Norm(boc[-1], "group"),
            conv_out=Conv(boc[-1], 2 * lc))
        self.decoder = Box(
            conv_in=Conv(lc, boc[-1]),
            mid_block=mid_block(boc[-1]),
            up_blocks=nn.ModuleList([
                level(boc[min(i + 1, last)], boc[i], n + 1,
                      "up" if i > 0 else "")
                for i in reversed(range(len(boc)))]),
            conv_norm_out=Norm(boc[0], "group"),
            conv_out=Conv(boc[0], 3))
        self.quant_conv = Conv(2 * lc, 2 * lc, k=1)
        self.post_quant_conv = Conv(lc, lc, k=1)

    def encode(self, img):
        e = self.encoder
        x = e.conv_in(img)
        for lvl in e.down_blocks:
            x = run_level(lvl, x)
        x = e.conv_out(F.silu(e.conv_norm_out(run_mid(e.mid_block, x))))
        mean = self.quant_conv(x).chunk(2, dim=1)[0]
        return mean * self.cfg.scaling_factor

    def decode(self, z):
        d = self.decoder
        x = run_mid(d.mid_block, d.conv_in(
            self.post_quant_conv(z / self.cfg.scaling_factor)))
        for lvl in d.up_blocks:
            x = run_level(lvl, x)
        return d.conv_out(F.silu(d.conv_norm_out(x)))


# ---------------------------------------------------------------- weights

def _generator(device, seed: int, prefix: str, name: str):
    g = torch.Generator(device=device)
    g.manual_seed(zlib.crc32(f"{seed}:{prefix}:{name}".encode()))
    return g


@torch.no_grad()
def build(module: nn.Module, device, seed: int, prefix: str,
          stored: torch.dtype, bits: int) -> nn.Module:
    """A module built on the meta device given fp32 storage on ``device``
    and the port's seeded random weights (those of the port's
    ``models/weights.random_fill``): a tensor's generator is seeded by the
    CRC-32 of "seed:prefix:name"; an int layer (``Lin.quant`` at ``bits``
    4 or 8) draws a unit normal [out, in] in fp32, rounds it at 3 sigma
    full scale to the codes and is those codes times 3 / (qmax √in), its
    bias 0; norm scales are 1, biases 0, every other tensor N(0, 0.02)
    drawn in the port's storage dtype ``stored`` (bf16 at full size) and
    widened to fp32.  One tensor is drawn at a time, on the device."""
    module.to_empty(device=device).requires_grad_(False).eval()
    drawn = set()
    for name, m in module.named_modules():
        if isinstance(m, Lin) and m.quant and bits:
            qmax = QMAX[bits]
            o, i = m.weight.shape
            w = torch.randn(o, i, device=device, generator=_generator(
                device, seed, prefix, f"{name}.weight"))
            q = torch.clamp(torch.round(w * (qmax / 3.0)), -qmax, qmax)
            del w
            scale = torch.full((o,), 3.0 / (qmax * math.sqrt(i)), dtype=F32,
                               device=device)
            m.weight.copy_(q * scale[:, None])
            drawn.add(f"{name}.weight")
    norms = {f"{n}.weight" for n, m in module.named_modules()
             if isinstance(m, Norm)}
    for name, p in module.named_parameters():
        if name in drawn:
            continue
        if name in norms:
            p.fill_(1.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            t = torch.empty(p.shape, dtype=stored, device=device)
            t.normal_(0.0, 0.02, generator=_generator(device, seed, prefix,
                                                      name))
            p.copy_(t)
    return module


# -------------------------------------------------------------- sampling

def flow_tables(steps: int, device, shift: float = 3.0):
    """FlowMatchEuler's (timesteps [steps], sigmas [steps + 1]) in fp32:
    t from 1 to 1/steps, shifted to shift·t / (1 + (shift − 1)·t), then
    0."""
    t = np.linspace(1.0, 1.0 / steps, steps)
    t = shift * t / (1.0 + (shift - 1.0) * t)
    return (torch.as_tensor(t.astype(np.float32), device=device),
            torch.as_tensor(np.append(t, 0.0).astype(np.float32),
                            device=device))

"""Shared neural building blocks of the generative backends (counterpart
of genpc_tpu/models/layers.py).

The reference's flax layers compute in mixed precision, and these copy it
layer by layer:
  * ``Linear`` and ``Conv2d`` cast their input, weight and bias to their
    compute type (bf16 unless a layer is declared fp32) and return that
    type;
  * ``GroupNorm`` and ``LayerNorm`` compute in fp32, with flax's default
    eps of 1e-6 (torch's own default is 1e-5), and return fp32;
  * a residual sum of bf16 and fp32 promotes to fp32 in both frameworks.
The stored parameters keep the dtype they were materialised in (fp32 at
the test presets, bf16 at full size), as the reference's trees do.

fp32 layers run in full fp32 on the card: ``genpc_tpu_torch.runtime``,
imported here, turns TF32 off for matmuls and cuDNN convolutions.

Layout is PyTorch's: images NCHW, tokens [B, T, C] in (h, w) row-major
order, the order of the reference's NHWC reshape.  Parameter names are
the diffusers checkpoints' (``to_out.0``, ``ff.net.0.proj``,
``downsamplers.0.conv``), so a real state dict loads by name.

Attention is ``F.scaled_dot_product_attention`` (the reference leaves
it to XLA's ``jax.nn.dot_product_attention``).  ``RefBank`` carries
zero123plus's reference attention through a UNet's transformer blocks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch import runtime  # noqa: F401  (TF32 off)

BF16 = torch.bfloat16
F32 = torch.float32
#: flax's GroupNorm/LayerNorm default epsilon (torch's default is 1e-5)
NORM_EPS = 1e-6


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim], [cos, sin] in fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=F32, device=t.device)
                      / half)
    args = t.to(F32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class Linear(nn.Module):
    """Dense layer computing in ``compute`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, compute: torch.dtype = BF16):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def forward(self, x):
        c = self.compute
        return F.linear(x.to(c), self.weight.to(c),
                        None if self.bias is None else self.bias.to(c))


class Conv2d(nn.Module):
    """Square-kernel convolution computing in ``compute``; padding is
    symmetric, k // 2 unless given (flax ``padding=1`` for 3x3, none for
    1x1 and for a patch embedding, whose stride is its kernel)."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 3,
                 stride: int = 1, bias: bool = True,
                 compute: torch.dtype = BF16, padding: Optional[int] = None):
        super().__init__()
        self.compute, self.stride = compute, stride
        self.padding = k // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x):
        c = self.compute
        return F.conv2d(x.to(c), self.weight.to(c),
                        None if self.bias is None else self.bias.to(c),
                        stride=self.stride, padding=self.padding)


class GroupNorm(nn.Module):
    """32-group GroupNorm in fp32 over NCHW."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        return F.group_norm(x.to(F32), self.groups, self.weight.to(F32),
                            self.bias.to(F32), NORM_EPS)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x.to(F32), self.weight.shape, self.weight.to(F32),
                            self.bias.to(F32), NORM_EPS)


class RMSNorm(nn.Module):
    """RMS norm with a learned scale, in fp32: the result is fp32
    (``keep_dtype=False``: T5's and Qwen2.5-VL's norm) or cast back to the
    input's dtype (``keep_dtype=True``: the MMDiT's q/k and text norms)."""

    def __init__(self, dim: int, eps: float = NORM_EPS,
                 keep_dtype: bool = False):
        super().__init__()
        self.eps, self.keep_dtype = eps, keep_dtype
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        xf = x.to(F32)
        out = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight.to(F32)
        return out.to(x.dtype) if self.keep_dtype else out


class BatchNorm2dInference(nn.Module):
    """BatchNorm over the channels of NCHW in inference mode, from the
    checkpoint's running statistics (``running_mean``/``running_var``
    buffers), in fp32 with torch's and flax's default eps of 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var.to(F32) + 1e-5)
        c = (1, -1, 1, 1)
        return ((x.to(F32) - self.running_mean.to(F32).view(c))
                * inv.view(c) * self.weight.to(F32).view(c)
                + self.bias.to(F32).view(c))


NORMS = (GroupNorm, LayerNorm, RMSNorm, BatchNorm2dInference)


def box(**children: nn.Module) -> nn.Module:
    """A container that only names its children (a checkpoint's path)."""
    m = nn.Module()
    for k, v in children.items():
        m.add_module(k, v)
    return m


def gelu_tanh(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def sdpa_heads(q, k, v, mask=None, causal: bool = False):
    """[B, T, H, dh] q and [B, S, H, dh] k, v -> [B, T, H * dh];
    ``mask`` broadcasts to [B, H, T, S] (True: attend)."""
    b, t, h, dh = q.shape
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal)
    return out.transpose(1, 2).reshape(b, t, h * dh)


def attention(q, k, v, heads: int, causal: bool = False):
    """[B, T, heads*dh] q and [B, S, heads*dh] k, v -> [B, T, heads*dh]."""
    b, _, inner = q.shape

    def split(a):
        return a.reshape(b, a.shape[1], heads, inner // heads)

    return sdpa_heads(split(q), split(k), split(v), causal=causal)


class TimestepEmbed(nn.Module):
    """MLP over the sinusoidal embedding (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class Attention(nn.Module):
    """Multi-head attention; cross-attention when context is given."""

    def __init__(self, dim: int, heads: int,
                 context_dim: Optional[int] = None,
                 dim_head: Optional[int] = None):
        super().__init__()
        self.heads = heads
        inner = (dim_head or dim // heads) * heads
        ctx = context_dim or dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx, inner, bias=False)
        self.to_v = Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        out = attention(self.to_q(x), self.to_k(context), self.to_v(context),
                        self.heads)
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu_tanh(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers ``ff.net.0.proj`` / ``ff.net.2``)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLU(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class RefBank:
    """Reference-attention token store (zero123plus conditioning).

    Each multiview step runs the UNet twice: a WRITE pass over the
    noised condition latents records every self-attention's post-norm
    tokens; the READ pass over the sample concatenates the recorded
    tokens into each attn1's keys and values.  Both passes visit the
    attention sites in the same order, so the bank is positional.
    """

    def __init__(self, mode: str, tokens=None):
        if mode not in ("w", "r"):
            raise ValueError(f"RefBank mode {mode!r}: 'w' or 'r'")
        self.mode = mode
        self.tokens = [] if tokens is None else list(tokens)
        self._i = 0

    def visit(self, h):
        """WRITE: record h, return None.  READ: the tokens recorded at
        this site."""
        if self.mode == "w":
            self.tokens.append(h)
            return None
        t = self.tokens[self._i]
        self._i += 1
        return t


class TransformerBlock(nn.Module):
    """Self-attn + cross-attn + FF, pre-LayerNorm (BasicTransformerBlock)."""

    def __init__(self, dim: int, heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, ref: Optional[RefBank] = None):
        h = self.norm1(x)
        ctx1 = None
        if ref is not None:
            r = ref.visit(h)
            if r is not None:
                ctx1 = torch.cat([h, r.to(h.dtype)], dim=1)
        x = x + self.attn1(h, ctx1)
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """NCHW features -> tokens -> transformer blocks -> NCHW (+ residual)."""

    def __init__(self, channels: int, heads: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, heads, context_dim)
             for _ in range(depth)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context=None, ref=None):
        b, c, h, w = x.shape
        tok = self.proj_in(self.norm(x).flatten(2).transpose(1, 2))
        for blk in self.transformer_blocks:
            tok = blk(tok, context, ref)
        tok = self.proj_out(tok)
        return tok.transpose(1, 2).reshape(b, c, h, w) + x


class ResnetBlock(nn.Module):
    """GroupNorm-SiLU-Conv x2 with timestep injection (ResnetBlock2D)."""

    def __init__(self, in_ch: int, out_ch: int,
                 temb_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = Conv2d(in_ch, out_ch)
        self.time_emb_proj = Linear(temb_dim, out_ch) if temb_dim else None
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch)
        self.conv_shortcut = Conv2d(in_ch, out_ch, k=1) \
            if in_ch != out_ch else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        res = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + res


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, stride=2)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x (the reference's ``jax.image.resize(..., "nearest")``),
    then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))

"""MMDiT, the FLUX / Qwen-Image multimodal diffusion transformer
(counterpart of genpc_tpu/models/dit.py).

Parameter names are the diffusers checkpoints': a Qwen-family preset
(``cond_mode="sequence"``: ``qwen``, ``base_qwen``, ``tiny_qwen``) is named
as ``QwenImageTransformer2DModel`` (``img_in``, ``txt_norm``,
``transformer_blocks.N.img_mod.1``, ``img_mlp.net.0.proj``...), a FLUX-
family preset (``flux``, ``base``, ``tiny``) as ``FluxTransformer2DModel``
(``x_embedder``, ``transformer_blocks.N.norm1.linear``, ``ff.net.2``,
``single_transformer_blocks.N.proj_mlp``...).  ``weights.from_flax``
maps either onto the reference's one flax tree.

Compute types are the reference's, layer by layer: the block matmuls in
bf16; the AdaLN modulations, ``norm_out``'s and ``proj_out`` in fp32;
LayerNorms without affine in fp32 at eps 1e-6; RMS norms in fp32, cast
back to their input's type; the tanh GELU.  RoPE rotates interleaved
pairs (``0::2`` / ``1::2``) on a 3-axis table.  With ``quant_bits`` 8
or 4 every block matmul (the modulations included) is a
``quant.QuantLinear``, as the reference's ``_tp_dense`` makes it.

Attention is ``F.scaled_dot_product_attention`` on bf16 q/k/v with the
key mask.  The reference switches above 2,048 joint tokens to
query-chunked attention with fp32 logits; its unchunked call also forms
fp32 logits and an fp32 softmax and rounds the probabilities to bf16
before the product with v, so both of its branches are the one
computation the fused kernels do (fp32 accumulation and softmax, bf16
probabilities), and the port does not chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    BF16, F32, NORM_EPS, Linear, RMSNorm, TimestepEmbed, box, gelu_tanh,
    sdpa_heads, timestep_embedding)
from genpc_tpu_torch.models.quant import QuantLinear


@dataclass(frozen=True)
class DiTConfig:
    hidden_dim: int = 3072
    num_heads: int = 24
    double_blocks: int = 19
    single_blocks: int = 38
    patch_size: int = 2
    in_channels: int = 16         # latent channels (FLUX VAE: 16)
    cond_channels: int = 16       # control latent channels (0 = none)
    text_dim: int = 4096          # T5-XXL (flux) / Qwen2.5-VL (3584)
    pooled_dim: int = 768         # CLIP-L pooled (flux only)
    guidance_embed: bool = True   # FLUX distilled guidance conditioning
    txt_input_norm: bool = False  # Qwen RMS-norms text features on input
    cond_mode: str = "channels"   # 'channels' (flux) | 'sequence' (qwen)
    axes_dim: Tuple[int, int, int] = (16, 56, 56)  # RoPE dims per axis
    theta: int = 10000
    # weight-only quantisation of every block matmul: 0 (bf16), 8 or 4
    # (models/quant.py); embedders, norms and the output head stay
    quant_bits: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def family(self) -> str:
        """Whose checkpoint names the parameters carry."""
        return "qwen" if self.cond_mode == "sequence" else "flux"

    @classmethod
    def preset(cls, name: str) -> "DiTConfig":
        if name == "tiny":
            return cls(hidden_dim=64, num_heads=4, double_blocks=2,
                       single_blocks=2, in_channels=4, cond_channels=4,
                       text_dim=64, pooled_dim=32, axes_dim=(4, 6, 6))
        if name == "tiny_qwen":
            return cls(hidden_dim=64, num_heads=4, double_blocks=2,
                       single_blocks=0, in_channels=4, cond_channels=4,
                       text_dim=64, pooled_dim=0, guidance_embed=False,
                       txt_input_norm=True, cond_mode="sequence",
                       axes_dim=(4, 6, 6))
        if name == "base":
            return cls(hidden_dim=768, num_heads=12, double_blocks=4,
                       single_blocks=8, in_channels=4, cond_channels=4,
                       text_dim=64, pooled_dim=64, axes_dim=(16, 24, 24))
        if name == "base_qwen":
            return cls(hidden_dim=768, num_heads=12, double_blocks=8,
                       single_blocks=0, in_channels=4, cond_channels=4,
                       text_dim=64, pooled_dim=0, guidance_embed=False,
                       txt_input_norm=True, cond_mode="sequence",
                       axes_dim=(16, 24, 24))
        if name == "flux":
            # FLUX.1-Depth-dev: x_embedder in = 2*2*(16+16) = 128
            return cls()
        if name == "qwen":
            # Qwen-Image-Edit: 60 double blocks, no single stream
            return cls(hidden_dim=3072, num_heads=24, double_blocks=60,
                       single_blocks=0, text_dim=3584, pooled_dim=0,
                       guidance_embed=False, txt_input_norm=True,
                       cond_mode="sequence")
        raise ValueError(name)


# ----------------------------------------------------------------- RoPE

def rope_table(ids: torch.Tensor, axes_dim: Tuple[int, ...], theta: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [T, 3] -> (cos, sin), each [T, head_dim // 2], in fp32: each
    position axis takes axes_dim[a] // 2 frequencies."""
    cos_parts, sin_parts = [], []
    for a, d in enumerate(axes_dim):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=F32,
                                              device=ids.device) * 2.0 / d))
        ang = ids[:, a:a + 1].to(F32) * freqs[None, :]
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
    return torch.cat(cos_parts, -1), torch.cat(sin_parts, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D]: rotate each interleaved pair (x[0::2], x[1::2]) by
    (cos, sin) [T, D/2], in fp32; returns x's dtype."""
    xf = x.to(F32)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def joint_attention(q, k, v, cos, sin, mask=None):
    """q, k, v [B, T, H, dh] -> [B, T, H * dh]: RoPE on q and k, then
    attention; mask [B, T] bool marks the valid KEY tokens (None: all)."""
    return sdpa_heads(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                      None if mask is None else mask[:, None, None, :])


def _ln(x):
    """LayerNorm without scale or bias, fp32, eps 1e-6."""
    return F.layer_norm(x.to(F32), x.shape[-1:], eps=NORM_EPS)


def _heads(x, heads: int, norm: RMSNorm):
    """[B, T, H * dh] -> per-head RMS-normed [B, T, H, dh]."""
    b, t, d = x.shape
    return norm(x.reshape(b, t, heads, d // heads))


def block_linear(cfg: DiTConfig, in_features: int, out_features: int,
                 compute: torch.dtype = BF16) -> nn.Module:
    """A block matmul: ``Linear``, or ``QuantLinear`` at the config's
    ``quant_bits``."""
    if cfg.quant_bits:
        return QuantLinear(in_features, out_features, cfg.quant_bits,
                           compute=compute)
    return Linear(in_features, out_features, compute=compute)


class _GeluProj(nn.Module):
    def __init__(self, cfg: DiTConfig, dim: int, inner: int):
        super().__init__()
        self.proj = block_linear(cfg, dim, inner)

    def forward(self, x):
        return gelu_tanh(self.proj(x))


class GeluMLP(nn.Module):
    """diffusers FeedForward('gelu-approximate'): ``net.0.proj``, ``net.2``."""

    def __init__(self, cfg: DiTConfig, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GeluProj(cfg, dim, 4 * dim),
                                  nn.Identity(),
                                  block_linear(cfg, 4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


def _modulation(cfg: DiTConfig, chunks: int) -> nn.Module:
    """The AdaLN linear (fp32): FLUX's ``<norm>.linear``, Qwen's
    ``<stream>_mod.1`` (after its SiLU)."""
    dim = cfg.hidden_dim
    lin = block_linear(cfg, dim, chunks * dim, compute=F32)
    if cfg.family == "flux":
        return box(linear=lin)
    return nn.ModuleList([nn.Identity(), lin])


def _mod_linear(m: nn.Module) -> nn.Module:
    return m.linear if hasattr(m, "linear") else m[1]


class DoubleBlock(nn.Module):
    """Two-stream block (FluxTransformerBlock / QwenImageTransformerBlock):
    joint attention over [txt, img], AdaLN-zero per stream."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, dh, fam = cfg.hidden_dim, cfg.head_dim, cfg.family
        self.heads = cfg.num_heads
        names = (("norm1", "norm1_context", "ff", "ff_context")
                 if fam == "flux" else
                 ("img_mod", "txt_mod", "img_mlp", "txt_mlp"))
        self._names = names
        for n in names[:2]:
            self.add_module(n, _modulation(cfg, 6))
        for n in names[2:]:
            self.add_module(n, GeluMLP(cfg, d))

        def lin():
            return block_linear(cfg, d, d)
        self.attn = box(
            to_q=lin(), to_k=lin(), to_v=lin(), add_q_proj=lin(),
            add_k_proj=lin(), add_v_proj=lin(),
            to_out=nn.ModuleList([lin()]), to_add_out=lin(),
            norm_q=RMSNorm(dh, keep_dtype=True),
            norm_k=RMSNorm(dh, keep_dtype=True),
            norm_added_q=RMSNorm(dh, keep_dtype=True),
            norm_added_k=RMSNorm(dh, keep_dtype=True))

    def forward(self, img, txt, vec, cos, sin, mask=None):
        img_mod, txt_mod, img_mlp, txt_mlp = (getattr(self, n)
                                              for n in self._names)
        sv = F.silu(vec.to(F32))
        (i_shift, i_scale, i_gate, i_shift2, i_scale2,
         i_gate2) = _mod_linear(img_mod)(sv)[:, None].chunk(6, dim=-1)
        (t_shift, t_scale, t_gate, t_shift2, t_scale2,
         t_gate2) = _mod_linear(txt_mod)(sv)[:, None].chunk(6, dim=-1)
        a, h = self.attn, self.heads
        img_n = _ln(img) * (1 + i_scale) + i_shift
        txt_n = _ln(txt) * (1 + t_scale) + t_shift
        q = torch.cat([_heads(a.add_q_proj(txt_n), h, a.norm_added_q),
                       _heads(a.to_q(img_n), h, a.norm_q)], dim=1)
        k = torch.cat([_heads(a.add_k_proj(txt_n), h, a.norm_added_k),
                       _heads(a.to_k(img_n), h, a.norm_k)], dim=1)
        v = torch.cat([a.add_v_proj(txt_n), a.to_v(img_n)], dim=1)
        lt = txt.shape[1]
        att = joint_attention(q, k, v.reshape(q.shape), cos, sin, mask)
        img = img + i_gate * a.to_out[0](att[:, lt:])
        txt = txt + t_gate * a.to_add_out(att[:, :lt])
        img = img + i_gate2 * img_mlp(_ln(img) * (1 + i_scale2) + i_shift2)
        txt = txt + t_gate2 * txt_mlp(_ln(txt) * (1 + t_scale2) + t_shift2)
        return img, txt


class SingleBlock(nn.Module):
    """Fused single-stream block (FluxSingleTransformerBlock): parallel
    attention and MLP, one output projection, 3-chunk AdaLN."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d, dh = cfg.hidden_dim, cfg.head_dim
        self.heads = cfg.num_heads
        self.norm = _modulation(cfg, 3)
        self.attn = box(to_q=block_linear(cfg, d, d),
                        to_k=block_linear(cfg, d, d),
                        to_v=block_linear(cfg, d, d),
                        norm_q=RMSNorm(dh, keep_dtype=True),
                        norm_k=RMSNorm(dh, keep_dtype=True))
        self.proj_mlp = block_linear(cfg, d, 4 * d)
        self.proj_out = block_linear(cfg, 5 * d, d)

    def forward(self, x, vec, cos, sin, mask=None):
        shift, scale, gate = self.norm.linear(
            F.silu(vec.to(F32)))[:, None].chunk(3, dim=-1)
        xn = _ln(x) * (1 + scale) + shift
        a, h = self.attn, self.heads
        q = _heads(a.to_q(xn), h, a.norm_q)
        k = _heads(a.to_k(xn), h, a.norm_k)
        att = joint_attention(q, k, a.to_v(xn).reshape(q.shape), cos, sin,
                              mask)
        mlp = gelu_tanh(self.proj_mlp(xn))
        return x + gate * self.proj_out(torch.cat([att, mlp], dim=-1))


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)(W/p), p*p*C]: tokens in (h, w) raster
    order, features in (py, px, c) order (the reference's NHWC reshape)."""
    b, c, h, w = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, h // p, p, w // p, p, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                               p * p * c)


class MMDiT(nn.Module):
    """latents [B, C, H, W] -> velocity [B, C, H, W] (fp32)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d, p = cfg.hidden_dim, cfg.patch_size
        qwen = cfg.family == "qwen"
        in_ch = cfg.in_channels + (cfg.cond_channels
                                   if cfg.cond_mode == "channels" else 0)
        self._img_in = "img_in" if qwen else "x_embedder"
        self._txt_in = "txt_in" if qwen else "context_embedder"
        self.add_module(self._img_in, Linear(p * p * in_ch, d))
        if cfg.txt_input_norm:
            self.txt_norm = RMSNorm(cfg.text_dim, keep_dtype=True)
        self.add_module(self._txt_in, Linear(cfg.text_dim, d))
        emb = {"timestep_embedder": TimestepEmbed(256, d)}
        if cfg.guidance_embed:
            emb["guidance_embedder"] = TimestepEmbed(256, d)
        if cfg.pooled_dim:
            emb["text_embedder"] = TimestepEmbed(cfg.pooled_dim, d)
        self.time_text_embed = box(**emb)
        self.transformer_blocks = nn.ModuleList(
            [DoubleBlock(cfg) for _ in range(cfg.double_blocks)])
        self.single_transformer_blocks = nn.ModuleList(
            [SingleBlock(cfg) for _ in range(cfg.single_blocks)])
        self.norm_out = box(linear=Linear(d, 2 * d, compute=F32))
        self.proj_out = Linear(d, p * p * cfg.in_channels, compute=F32)

    def rope(self, h: int, w: int, lt: int, seq_cond: bool, device):
        """(cos, sin) of the joint sequence [txt, img(, edit img)]: text
        at axis-0 positions (its index for Qwen, 0 for FLUX), image
        patches at (0, y, x); edit-image tokens reuse the image grid."""
        p = self.cfg.patch_size
        gy, gx = torch.meshgrid(torch.arange(h // p, device=device),
                                torch.arange(w // p, device=device),
                                indexing="ij")
        img_ids = torch.stack([torch.zeros_like(gy).ravel(), gy.ravel(),
                               gx.ravel()], dim=-1)
        if seq_cond:
            img_ids = torch.cat([img_ids, img_ids], dim=0)
        zeros = torch.zeros(lt, dtype=torch.long, device=device)
        t0 = (torch.arange(lt, device=device)
              if self.cfg.cond_mode == "sequence" else zeros)
        txt_ids = torch.stack([t0, zeros, zeros], dim=-1)
        return rope_table(torch.cat([txt_ids, img_ids], dim=0),
                          self.cfg.axes_dim, self.cfg.theta)

    def forward(self, latents, t, txt, pooled=None, cond_latents=None,
                guidance=None, txt_mask=None):
        """latents [B, C, H, W]; t [B] in [0, 1]; txt [B, L, text_dim];
        txt_mask [B, L] bool marks real prompt tokens; cond_latents [B,
        Cc, H, W] join along channels (FLUX) or the sequence (Qwen)."""
        cfg = self.cfg
        b, _, h, w = latents.shape
        p = cfg.patch_size
        x, seq_cond = latents, None
        if cond_latents is not None:
            if cfg.cond_mode == "channels":
                x = torch.cat([x, cond_latents], dim=1)
            else:
                seq_cond = patchify(cond_latents, p)
        x = patchify(x, p)
        n_img = x.shape[1]
        if seq_cond is not None:
            x = torch.cat([x, seq_cond], dim=1)
        img = getattr(self, self._img_in)(x)
        if cfg.txt_input_norm:
            txt = self.txt_norm(txt)
        txt_tok = getattr(self, self._txt_in)(txt)

        te = self.time_text_embed
        vec = te.timestep_embedder(timestep_embedding(t * 1000.0, 256))
        if pooled is not None and cfg.pooled_dim:
            vec = vec + te.text_embedder(pooled)
        if cfg.guidance_embed and guidance is not None:
            vec = vec + te.guidance_embedder(
                timestep_embedding(guidance * 1000.0, 256))

        lt = txt_tok.shape[1]
        cos, sin = self.rope(h, w, lt, seq_cond is not None, latents.device)
        mask = None
        if txt_mask is not None:
            mask = torch.cat([txt_mask.to(torch.bool),
                              torch.ones((b, img.shape[1]), dtype=torch.bool,
                                         device=img.device)], dim=1)
        for blk in self.transformer_blocks:
            img, txt_tok = blk(img, txt_tok, vec, cos, sin, mask)
        if len(self.single_transformer_blocks):
            seq = torch.cat([txt_tok, img], dim=1)
            for blk in self.single_transformer_blocks:
                seq = blk(seq, vec, cos, sin, mask)
            img = seq[:, lt:]

        img = _ln(img[:, :n_img])
        # AdaLayerNormContinuous: (scale, shift)
        scale, shift = self.norm_out.linear(
            F.silu(vec.to(F32)))[:, None].chunk(2, dim=-1)
        out = self.proj_out(img * (1 + scale) + shift)
        c = cfg.in_channels
        out = out.reshape(b, h // p, w // p, p, p, c)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)

"""Qwen2.5-VL, the Qwen-Image-Edit conditioning towers (counterpart of
genpc_tpu/models/qwen_vl.py).

``QwenVLEncoder.encode(prompt, image)`` renders the edit chat template,
splices the vision tower's merged tokens over the ``<|image_pad|>``
slot, runs the language tower with M-RoPE position ids, and returns the
final hidden states after the template prefix: the per-token features
the MMDiT conditions on.

Both towers carry the HF checkpoint's names below its prefixes
(``model.language_model.`` and ``model.visual.``, or the older
``model.`` and ``visual.``; ``weights.load_qwen_vl`` strips either):
  * the text tower (a Qwen2 decoder): GQA attention (28 query and 4 key
    and value heads; q/k/v biased, o not), SwiGLU MLP, pre-RMSNorm, a
    causal mask, and M-RoPE, whose frequency sections (16, 24, 24) take
    their positions from the temporal, height and width planes and
    rotate half the head against the other half;
  * the vision tower: a Conv3D patch embedding over two copies of the
    frame (a matmul on flattened patches), 2-D rotary positions, window
    attention (112-pixel windows, full attention in blocks 7, 15, 23 and
    31; the grid is snapped to whole windows, so the window order is a
    permutation), a biased gated MLP, and the 2x2 merger.
Compute types are the reference's: bf16 matmuls, fp32 RMS norms (whose
result stays fp32), RoPE in fp32; the text tower's residual stream is
fp32, the vision tower's bf16.  Parameters are fp32 at the test preset
and bf16 at full size.  ``quant_bits`` (the reference's default: int4
at full size) makes the text layers' and vision blocks' matmuls
``quant.QuantLinear``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    BF16, F32, Linear, RMSNorm, box, sdpa_heads)
from genpc_tpu_torch.models.quant import QuantLinear, resolve_quant_bits

#: the random weights' seed (the reference initialises from PRNGKey(0))
WEIGHT_SEED = 0


@dataclass(frozen=True)
class QwenVLConfig:
    # text tower
    vocab_size: int = 152064
    hidden: int = 3584
    layers: int = 28
    heads: int = 28
    kv_heads: int = 4
    head_dim: int = 128
    intermediate: int = 18944
    eps: float = 1e-6
    theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    # vision tower
    vit_depth: int = 32
    vit_dim: int = 1280
    vit_heads: int = 16
    vit_ffn: int = 3420
    patch: int = 14
    temporal_patch: int = 2
    merge: int = 2
    window: int = 112            # pixels; window cells = window/merge/patch
    fullatt_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    vit_theta: float = 10000.0
    # weight-only quantisation of the text layers' and vision blocks'
    # matmuls: 0 (bf16), 8 or 4 (models/quant.py)
    quant_bits: int = 0

    @property
    def window_cells(self) -> int:
        return self.window // (self.merge * self.patch)

    @classmethod
    def preset(cls, name: str) -> "QwenVLConfig":
        if name == "tiny":
            return cls(vocab_size=512, hidden=64, layers=2, heads=4,
                       kv_heads=2, head_dim=16, intermediate=128,
                       mrope_section=(4, 2, 2),
                       vit_depth=2, vit_dim=32, vit_heads=2, vit_ffn=64,
                       patch=4, merge=2, window=16, fullatt_blocks=(1,))
        if name == "full":
            return cls()
        raise ValueError(name)


def _dense(cfg: QwenVLConfig, in_features: int, out_features: int,
           bias: bool = True) -> nn.Module:
    """A block matmul: ``Linear``, or ``QuantLinear`` at the config's
    ``quant_bits``."""
    if cfg.quant_bits:
        return QuantLinear(in_features, out_features, cfg.quant_bits,
                           bias=bias)
    return Linear(in_features, out_features, bias=bias)


# --------------------------------------------------------------- M-RoPE

def mrope_cos_sin(pos_ids: torch.Tensor, cfg: QwenVLConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pos_ids [3, B, L] (t/h/w planes) -> cos, sin [B, L, head_dim]:
    frequency section s reads its positions from plane s, and the table
    is duplicated for the rotate-half convention."""
    half = cfg.head_dim // 2
    inv = (1.0 / (cfg.theta ** (np.arange(0, half) / half))).astype(
        np.float32)
    freqs = pos_ids[..., None].to(F32) * torch.from_numpy(inv).to(
        pos_ids.device)                                    # [3, B, L, half]
    parts, start = [], 0
    for i, width in enumerate(cfg.mrope_section):
        parts.append(freqs[i, :, :, start:start + width])
        start += width
    picked = torch.cat(parts, dim=-1)
    emb = torch.cat([picked, picked], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k [B, L, H, hd]; cos, sin [B, L, hd], broadcast over heads."""
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return (q * cos + _rotate_half(q) * sin,
            k * cos + _rotate_half(k) * sin)


# ------------------------------------------------------------ text tower

class QwenTextLayer(nn.Module):
    def __init__(self, cfg: QwenVLConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden, cfg.head_dim
        self.input_layernorm = RMSNorm(d, cfg.eps)
        self.self_attn = box(
            q_proj=_dense(cfg, d, cfg.heads * hd),
            k_proj=_dense(cfg, d, cfg.kv_heads * hd),
            v_proj=_dense(cfg, d, cfg.kv_heads * hd),
            o_proj=_dense(cfg, cfg.heads * hd, d, bias=False))
        self.post_attention_layernorm = RMSNorm(d, cfg.eps)
        self.mlp = box(
            gate_proj=_dense(cfg, d, cfg.intermediate, bias=False),
            up_proj=_dense(cfg, d, cfg.intermediate, bias=False),
            down_proj=_dense(cfg, cfg.intermediate, d, bias=False))

    def forward(self, x, cos, sin, mask=None):
        cfg, a = self.cfg, self.self_attn
        b, L, _ = x.shape
        hd = cfg.head_dim
        h = self.input_layernorm(x)
        q = a.q_proj(h).reshape(b, L, cfg.heads, hd)
        k = a.k_proj(h).reshape(b, L, cfg.kv_heads, hd)
        v = a.v_proj(h).reshape(b, L, cfg.kv_heads, hd)
        q, k = apply_rope(q.to(F32), k.to(F32), cos, sin)
        rep = cfg.heads // cfg.kv_heads
        c = a.q_proj.compute
        att = sdpa_heads(q.to(c), k.repeat_interleave(rep, dim=2).to(c),
                         v.repeat_interleave(rep, dim=2), mask,
                         causal=mask is None)
        x = x + a.o_proj(att)
        h = self.post_attention_layernorm(x)
        m = self.mlp
        return x + m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h))


class QwenVLTextModel(nn.Module):
    """The language tower; returns the hidden states after the final norm
    (HF's hidden_states[-1], what the Qwen-Image pipelines read)."""

    def __init__(self, cfg: QwenVLConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList([QwenTextLayer(cfg)
                                     for _ in range(cfg.layers)])
        self.norm = RMSNorm(cfg.hidden, cfg.eps)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings in fp32 (the reference's table is fp32)."""
        return F.embedding(ids, self.embed_tokens.weight).to(F32)

    def forward(self, ids=None, pos_ids=None, attn_mask=None,
                inputs_embeds=None):
        """ids [B, L] or inputs_embeds [B, L, hidden]; pos_ids [3, B, L];
        attn_mask [B, L] bool marks valid keys (None: all)."""
        x = self.embed(ids) if inputs_embeds is None else inputs_embeds
        L = x.shape[1]
        cos, sin = mrope_cos_sin(pos_ids, self.cfg)
        mask = None
        if attn_mask is not None:
            causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                           device=x.device))
            mask = causal[None, None] & attn_mask[:, None, None, :]
        for layer in self.layers:
            x = layer(x, cos, sin, mask)
        return self.norm(x)


# ---------------------------------------------------------- vision tower

def vision_rope(grid: int, cfg: QwenVLConfig) -> np.ndarray:
    """Rotary angles [S, head_dim // 2] of a square grid of ``grid``
    patches, in the grouped order (each 2x2 merged cell's 4 patches
    consecutive, cells in raster order)."""
    m = cfg.merge
    hd = cfg.vit_dim // cfg.vit_heads
    quarter = hd // 4
    inv_freq = 1.0 / (cfg.vit_theta ** (np.arange(quarter) * 2.0 / (hd // 2)))
    g = grid
    rows = np.arange(g)[:, None].repeat(g, 1)
    cols = np.arange(g)[None, :].repeat(g, 0)

    def group(a):   # raster patch grid -> grouped (cell-major) order
        return a.reshape(g // m, m, g // m, m).transpose(0, 2, 1, 3
                                                         ).reshape(-1)

    hf = group(rows)[:, None] * inv_freq[None, :]
    wf = group(cols)[:, None] * inv_freq[None, :]
    return np.concatenate([hf, wf], axis=1).astype(np.float32)


def snap_vision_px(px: int, cfg: QwenVLConfig) -> int:
    """An image side rounded up to whole attention windows (112 px at
    patch 14, merge 2): the grid must tile into windows."""
    wpx = cfg.window_cells * cfg.merge * cfg.patch
    return -(-px // wpx) * wpx


def window_permutation(grid: int, cfg: QwenVLConfig) -> np.ndarray:
    """The permutation taking grouped-order patch tokens into window
    order; the grid must make whole windows."""
    m, wc = cfg.merge, cfg.window_cells
    gc = grid // m
    if gc % wc:
        raise ValueError(f"grid {grid} does not tile into "
                         f"{wc * m}-patch windows")
    cell_idx = np.arange(gc * gc).reshape(gc // wc, wc, gc // wc, wc)
    cell_order = cell_idx.transpose(0, 2, 1, 3).reshape(-1)
    return (cell_order[:, None] * (m * m)
            + np.arange(m * m)[None, :]).reshape(-1)


class PatchEmbed3D(nn.Module):
    """The Conv3D patch embedding (no bias, stride = kernel) as a matmul
    over patches flattened in the kernel's (C, T, P, P) order; the weight
    keeps the checkpoint's 5-D shape."""

    def __init__(self, dim: int, temporal: int, patch: int,
                 compute: torch.dtype = BF16):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.empty(dim, 3, temporal, patch,
                                               patch))

    def forward(self, x):
        w = self.weight.reshape(self.weight.shape[0], -1)
        return F.linear(x.to(self.compute), w.to(self.compute))


class QwenVisionBlock(nn.Module):
    def __init__(self, cfg: QwenVLConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.vit_dim
        self.norm1 = RMSNorm(d, cfg.eps)
        self.attn = box(qkv=_dense(cfg, d, 3 * d), proj=_dense(cfg, d, d))
        self.norm2 = RMSNorm(d, cfg.eps)
        self.mlp = box(gate_proj=_dense(cfg, d, cfg.vit_ffn),
                       up_proj=_dense(cfg, d, cfg.vit_ffn),
                       down_proj=_dense(cfg, cfg.vit_ffn, d))

    def forward(self, x, cos, sin, window_len: int):
        """x [S, D] in window order; attention within runs of window_len
        tokens (S for the full-attention blocks)."""
        cfg = self.cfg
        d, heads = cfg.vit_dim, cfg.vit_heads
        hd = d // heads
        S = x.shape[0]
        qkv = self.attn.qkv(self.norm1(x)).reshape(S, 3, heads, hd)
        q, k, v = qkv.unbind(1)
        q, k = apply_rope(q[None].to(F32), k[None].to(F32), cos[None],
                          sin[None])
        c = self.attn.qkv.compute
        shape = (S // window_len, window_len, heads, hd)
        att = sdpa_heads(q.reshape(shape).to(c), k.reshape(shape).to(c),
                         v.reshape(shape))
        x = x + self.attn.proj(att.reshape(S, d))
        h = self.norm2(x)
        m = self.mlp
        return x + m.down_proj(F.silu(m.gate_proj(h)) * m.up_proj(h))


class QwenVisionModel(nn.Module):
    """A square image's patches -> merged tokens [grid² / 4, hidden] in
    raster order of the merged cells."""

    def __init__(self, cfg: QwenVLConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = box(proj=PatchEmbed3D(
            cfg.vit_dim, cfg.temporal_patch, cfg.patch))
        self.blocks = nn.ModuleList([QwenVisionBlock(cfg)
                                     for _ in range(cfg.vit_depth)])
        mm = cfg.merge ** 2
        self.merger = box(ln_q=RMSNorm(cfg.vit_dim, cfg.eps),
                          mlp=nn.ModuleList([
                              Linear(mm * cfg.vit_dim, mm * cfg.vit_dim),
                              nn.GELU(),
                              Linear(mm * cfg.vit_dim, cfg.hidden)]))

    def forward(self, patches: torch.Tensor, grid: int) -> torch.Tensor:
        """patches [S, C*T*P*P] in the grouped order, S = grid²."""
        cfg = self.cfg
        dev = patches.device
        perm = window_permutation(grid, cfg)
        x = self.patch_embed.proj(patches)[torch.from_numpy(perm).to(dev)]
        rope = torch.from_numpy(vision_rope(grid, cfg)[perm]).to(dev)
        emb = torch.cat([rope, rope], dim=-1)
        cos, sin = torch.cos(emb), torch.sin(emb)
        S = x.shape[0]
        wlen = (cfg.window_cells * cfg.merge) ** 2
        for i, blk in enumerate(self.blocks):
            x = blk(x, cos, sin, S if i in cfg.fullatt_blocks else wlen)
        mm = cfg.merge * cfg.merge
        x = self.merger.ln_q(x).reshape(S // mm, mm * cfg.vit_dim)
        mlp = self.merger.mlp
        x = mlp[2](F.gelu(mlp[0](x)))
        # undo the window order at merged-cell granularity
        inv = np.argsort(perm.reshape(-1, mm)[:, 0] // mm)
        return x[torch.from_numpy(inv).to(dev)]


def image_to_patches(img: np.ndarray, cfg: QwenVLConfig) -> np.ndarray:
    """[H, W, 3] image in [0, 1] -> [S, C*T*P*P] CLIP-normalised patches
    in the grouped order, each flattened in the Conv3D kernel's order
    with the frame duplicated."""
    mean = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
    x = (np.asarray(img, np.float32) - mean) / std
    g = img.shape[0] // cfg.patch
    p, m, t = cfg.patch, cfg.merge, cfg.temporal_patch
    x = x.reshape(g, p, g, p, 3).transpose(0, 2, 1, 3, 4)
    x = x.reshape(g // m, m, g // m, m, p, p, 3).transpose(
        0, 2, 1, 3, 4, 5, 6).reshape(g * g, p, p, 3)
    x = x.transpose(0, 3, 1, 2)                       # [S, C, P, P]
    x = np.repeat(x[:, :, None], t, axis=2)           # [S, C, T, P, P]
    return x.reshape(g * g, -1)


# -------------------------------------------------------------- protocol

EDIT_TEMPLATE_PREFIX = (
    "<|im_start|>system\nDescribe the key features of the input image "
    "(color, shape, size, texture, objects, background), then explain "
    "how the user's text instruction should alter or modify the image. "
    "Generate a new image that meets the user's requirements while "
    "maintaining consistency with the original input where appropriate."
    "<|im_end|>\n<|im_start|>user\n")
EDIT_TEMPLATE_SUFFIX = "<|im_end|>\n<|im_start|>assistant\n"
IMAGE_SLOT = "Picture 1: <|vision_start|><|image_pad|><|vision_end|>"
#: the side the Qwen-Image-Edit pipeline gives the VL image, before the
#: snap to whole windows (448 px, 1,024 patches, 256 merged tokens)
VISION_PX = 392


class QwenVLEncoder:
    """Qwen-Image-Edit prompt encoding on ``device``: template and image
    tokens -> the post-template features [1, L, hidden] (fp32).

    Without ``<weights_dir>/tokenizer/tokenizer.json`` (and the
    ``tokenizers`` package, imported only then) words map to ids by a
    SHA-1 of each word, as in the reference.  The towers are built on the
    meta device and materialised by ``init_params`` (seeded random
    weights, then ``<weights_dir>/text_encoder`` where it exists)."""

    def __init__(self, size: str = "tiny",
                 weights_dir: Optional[str] = None,
                 quant_bits: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        full = size == "full"
        self.cfg = dataclasses.replace(
            QwenVLConfig.preset(size),
            quant_bits=resolve_quant_bits(quant_bits, full))
        self.device = torch.device(device)
        self.dtype = BF16 if full else F32
        self.weights_dir = weights_dir
        self.vision_px = snap_vision_px(VISION_PX if full else 16, self.cfg)
        with torch.device("meta"):
            self.text = QwenVLTextModel(self.cfg)
            self.vision = QwenVisionModel(self.cfg)
        self.tok = None
        if weights_dir:
            path = os.path.join(weights_dir, "tokenizer", "tokenizer.json")
            if os.path.exists(path):
                from tokenizers import Tokenizer
                self.tok = Tokenizer.from_file(path)
        self.ready = False

    def models(self):
        return {"qwen_vl_text": self.text, "qwen_vl_vision": self.vision}

    def init_params(self, state=None) -> None:
        """Materialise both towers on the device: from ``state`` (kind ->
        state dict) when given, else seeded random weights, then the
        checkpoint of ``weights_dir`` where it exists."""
        from genpc_tpu_torch.models.weights import load_qwen_vl, materialize
        for kind, mod in self.models().items():
            materialize(mod, self.device, self.dtype,
                        seed=None if state is not None else WEIGHT_SEED,
                        prefix=kind)
            if state is not None:
                mod.load_state_dict(state[kind], strict=True)
        if self.weights_dir:
            load_qwen_vl(self.weights_dir, self.text, self.vision)
        self.ready = True

    def release(self) -> None:
        """Both towers back to the meta device."""
        for mod in self.models().values():
            mod.to_empty(device="meta")
        self.ready = False

    # -- tokenization ---------------------------------------------------
    def _ids(self, text: str) -> np.ndarray:
        if self.tok is not None:
            return np.asarray(self.tok.encode(
                text, add_special_tokens=False).ids, np.int64)
        words = text.replace("<|", " <|").replace("|>", "|> ").split()
        return np.asarray(
            [int(hashlib.sha1(w.encode()).hexdigest()[:8], 16)
             % (self.cfg.vocab_size - 8) + 8 for w in words], np.int64)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def encode(self, prompt: str, image: Optional[np.ndarray] = None
               ) -> torch.Tensor:
        """-> [1, L, hidden] conditioning tokens (template prefix dropped);
        image [H, W, 3] in [0, 1] fills the image slot."""
        pre_ids = self._ids(EDIT_TEMPLATE_PREFIX)
        drop = len(pre_ids)           # everything before the user payload
        if image is not None:
            head = np.concatenate([pre_ids,
                                   self._ids("Picture 1: <|vision_start|>")])
            tail = np.concatenate([self._ids("<|vision_end|>" + prompt),
                                   self._ids(EDIT_TEMPLATE_SUFFIX)])
            img_tokens = self.encode_image(image)
            embeds = torch.cat([self.text.embed(self._tensor(head)),
                                img_tokens.to(F32),
                                self.text.embed(self._tensor(tail))])[None]
            pos = self.mrope_positions(len(head), img_tokens.shape[0],
                                       len(tail))
            hidden = self.text(pos_ids=pos, inputs_embeds=embeds)
        else:
            ids = np.concatenate([pre_ids, self._ids(prompt),
                                  self._ids(EDIT_TEMPLATE_SUFFIX)])
            pos = self._tensor(np.broadcast_to(
                np.arange(len(ids))[None, None], (3, 1, len(ids))))
            hidden = self.text(self._tensor(ids)[None], pos)
        return hidden[:, drop:]

    def encode_image(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] in [0, 1] -> merged tokens [T_img, hidden]: Pillow's
        bicubic resize to vision_px, the patches, the vision tower."""
        from PIL import Image
        px = self.vision_px
        img = np.asarray(Image.fromarray(
            (np.clip(image, 0, 1) * 255).astype(np.uint8)).resize(
            (px, px), Image.BICUBIC), np.float32) / 255.0
        patches = image_to_patches(img, self.cfg)
        return self.vision(self._tensor(patches), px // self.cfg.patch)

    def mrope_positions(self, n_head: int, n_img: int, n_tail: int
                        ) -> torch.Tensor:
        """M-RoPE ids [3, 1, L] of [text, image, text]: text advances all
        planes together; image tokens sit at (base, base + row, base +
        col) on the merged grid; text resumes at base + the grid side."""
        gc = int(round(np.sqrt(n_img)))
        head = np.arange(n_head)
        i = np.arange(n_img)
        tail = n_head + gc + np.arange(n_tail)
        planes = [np.concatenate([head, n_head + off, tail])
                  for off in (0 * i, i // gc, i % gc)]
        return self._tensor(np.stack(planes)[:, None, :])

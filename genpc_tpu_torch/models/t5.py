"""T5 v1.1 encoder, the FLUX.1 text tower (counterpart of
genpc_tpu/models/t5.py).

FLUX.1-Depth-dev conditions on T5-XXL's per-token hidden states (512
tokens, 4,096 wide) and on CLIP-L's pooled vector.  The encoder carries
HF ``T5EncoderModel``'s names (``shared``, ``encoder.block.N.layer.0.
SelfAttention.q``, ``encoder.block.N.layer.1.DenseReluDense.wi_0``...),
so a checkpoint loads by name; the relative-position bias table lives in
block 0, as in HF, and every layer reads it.

Numerics are the reference's:
  * the norms are fp32 RMS norms whose result stays fp32, and the
    residual stream is fp32 (the embedding is read in fp32);
  * the q/k/v/o and feed-forward matmuls compute in bf16 (``quant_bits``
    8 or 4 makes them ``quant.QuantLinear``);
  * attention has no 1/sqrt(d) scale: fp32 scores from the bf16
    projections, plus the position bias, masked keys set to -1e9, an fp32
    softmax, bf16 probabilities against bf16 values;
  * the feed-forward is gated GELU (tanh form): wo(gelu(wi_0 h) * wi_1 h);
  * the output is multiplied by the token mask.

Tokenisation: ``<weights_dir>/tokenizer_2/tokenizer.json`` through the
``tokenizers`` package (imported only then), else a SHA-1 hash of each
word, as the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import (
    BF16, F32, Linear, RMSNorm, box, gelu_tanh)
from genpc_tpu_torch.models.quant import QuantLinear, resolve_quant_bits
from genpc_tpu_torch.models.text_encoder import (
    CLIPTextConfig, CLIPTextModel, make_tokenizer)

#: the random weights' seed (the reference initialises from PRNGKey(0))
WEIGHT_SEED = 0


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    # weight-only quantisation of the block matmuls: 0 (bf16), 8 or 4
    quant_bits: int = 0

    @classmethod
    def preset(cls, name: str) -> "T5Config":
        if name == "tiny":
            return cls(vocab_size=256, d_model=64, d_kv=16, num_heads=4,
                       d_ff=128, num_layers=2)
        if name == "xxl":
            return cls()
        raise ValueError(name)


def t5_relative_buckets(qlen: int, klen: int, num_buckets: int,
                        max_distance: int) -> np.ndarray:
    """Bidirectional relative-position bucket map [qlen, klen] (HF
    T5Attention._relative_position_bucket)."""
    ctx = np.arange(qlen)[:, None]
    mem = np.arange(klen)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    out += np.where(is_small, rel, large)
    return out


def _dense(cfg: T5Config, in_features: int, out_features: int) -> nn.Module:
    """A block matmul (no bias): bf16 ``Linear`` or ``QuantLinear``."""
    if cfg.quant_bits:
        return QuantLinear(in_features, out_features, cfg.quant_bits,
                           bias=False)
    return Linear(in_features, out_features, bias=False)


class T5SelfAttention(nn.Module):
    """HF T5Attention (encoder, self): ``q``, ``k``, ``v``, ``o`` and, in
    block 0 only, ``relative_attention_bias``."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = _dense(cfg, cfg.d_model, inner)
        self.k = _dense(cfg, cfg.d_model, inner)
        self.v = _dense(cfg, cfg.d_model, inner)
        self.o = _dense(cfg, inner, cfg.d_model)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(cfg.rel_buckets,
                                                        cfg.num_heads)

    def forward(self, x, pos_bias, mask):
        """x [B, L, D]; pos_bias [1, H, L, L] fp32; mask [B, L] bool."""
        cfg = self.cfg
        b, L, _ = x.shape

        def split(a):
            return a.reshape(b, L, cfg.num_heads, cfg.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        scores = torch.matmul(q.to(F32), k.to(F32).transpose(-1, -2))
        scores = (scores + pos_bias).masked_fill(
            ~mask[:, None, None, :], -1e9)
        att = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, L, -1)
        return self.o(out)


class T5Block(nn.Module):
    """HF T5Block: ``layer.0`` (self-attention + its pre-norm) and
    ``layer.1`` (the gated-GELU feed-forward + its pre-norm)."""

    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.layer = nn.ModuleList([
            box(SelfAttention=T5SelfAttention(cfg, has_bias),
                layer_norm=RMSNorm(d, eps)),
            box(DenseReluDense=box(wi_0=_dense(cfg, d, cfg.d_ff),
                                   wi_1=_dense(cfg, d, cfg.d_ff),
                                   wo=_dense(cfg, cfg.d_ff, d)),
                layer_norm=RMSNorm(d, eps))])

    def forward(self, x, pos_bias, mask):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), pos_bias, mask)
        h = ff.layer_norm(x)
        m = ff.DenseReluDense
        return x + m.wo(gelu_tanh(m.wi_0(h)) * m.wi_1(h))


class T5Encoder(nn.Module):
    """HF T5EncoderModel: ids [B, L] (and a mask [B, L] bool) -> the final
    per-token hidden states [B, L, D] in fp32, zero at masked tokens."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = box(
            block=nn.ModuleList([T5Block(cfg, i == 0)
                                 for i in range(cfg.num_layers)]),
            final_layer_norm=RMSNorm(cfg.d_model, cfg.layer_norm_eps))

    def position_bias(self, L: int, device) -> torch.Tensor:
        """[1, H, L, L] fp32 from block 0's table."""
        cfg = self.cfg
        buckets = torch.from_numpy(t5_relative_buckets(
            L, L, cfg.rel_buckets, cfg.rel_max_distance)).to(device)
        table = self.encoder.block[0].layer[0].SelfAttention \
            .relative_attention_bias.weight
        return F.embedding(buckets, table).to(F32).permute(2, 0, 1)[None]

    def forward(self, ids, mask=None):
        if mask is None:
            mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        x = F.embedding(ids, self.shared.weight).to(F32)
        pos_bias = self.position_bias(ids.shape[1], ids.device)
        for blk in self.encoder.block:
            x = blk(x, pos_bias, mask)
        return self.encoder.final_layer_norm(x) * mask[..., None]


class T5Tokenizer:
    """HF fast tokenizer (``tokenizer.json``) with T5's EOS and padding."""

    def __init__(self, tok, max_len: int = 512):
        self.tok = tok
        self.max_len = max_len
        self.eos = tok.token_to_id("</s>")
        self.pad = tok.token_to_id("<pad>") or 0

    @classmethod
    def from_dir(cls, path: str, max_len: int = 512) -> "T5Tokenizer":
        from tokenizers import Tokenizer
        return cls(Tokenizer.from_file(os.path.join(path, "tokenizer.json")),
                   max_len)

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.tok.encode(text, add_special_tokens=False).ids
        ids = ids[: self.max_len - 1] + [self.eos]
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids = ids + [self.pad] * (self.max_len - len(ids))
        return np.asarray(ids, np.int64), np.asarray(mask, bool)


class T5HashTokenizer:
    """Without ``tokenizer.json``: each lower-cased word to an id by a
    SHA-1 of it, then EOS (id 1), padded with 0."""

    def __init__(self, vocab_size: int, max_len: int = 512):
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        words = text.lower().split()[: self.max_len - 1]
        ids = [int(hashlib.sha1(w.encode()).hexdigest()[:8], 16)
               % (self.vocab_size - 2) + 2 for w in words] + [1]
        mask = [1] * len(ids) + [0] * (self.max_len - len(ids))
        ids += [0] * (self.max_len - len(ids))
        return np.asarray(ids, np.int64), np.asarray(mask, bool)


class T5PromptEncoder:
    """The FLUX text path on ``device``: ``encode(prompts)`` -> (T5 context
    [B, max_len, d_model] fp32, CLIP-L pooled [B, 768]), the
    prompt_embeds / pooled_prompt_embeds of FluxControlPipeline; 512
    tokens at full size, 32 at the tiny preset.

    ``quant_bits`` (None: int4 at full size, bf16 below) quantises T5's
    block matmuls.  Both towers are built on the meta device;
    ``init_params`` materialises them (seeded random weights, then
    ``<weights_dir>/text_encoder_2`` and ``/text_encoder`` where they
    exist), ``release`` frees them."""

    def __init__(self, size: str = "tiny",
                 weights_dir: Optional[str] = None, max_len: int = 512,
                 quant_bits: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        full = size == "full"
        self.cfg = dataclasses.replace(
            T5Config.preset("xxl" if full else "tiny"),
            quant_bits=resolve_quant_bits(quant_bits, full))
        self.cfg_l = CLIPTextConfig.preset("clip_l" if full else "tiny")
        self.max_len = max_len if full else 32
        self.device = torch.device(device)
        self.dtype = BF16 if full else F32
        self.weights_dir = weights_dir
        tok_dir = os.path.join(weights_dir, "tokenizer_2") \
            if weights_dir else ""
        if os.path.exists(os.path.join(tok_dir, "tokenizer.json")):
            self.tok = T5Tokenizer.from_dir(tok_dir, self.max_len)
        else:
            self.tok = T5HashTokenizer(self.cfg.vocab_size, self.max_len)
        self.tok_l = make_tokenizer(weights_dir, self.cfg_l.vocab_size,
                                    self.cfg_l.max_len)
        with torch.device("meta"):
            self.model = T5Encoder(self.cfg)
            self.model_l = CLIPTextModel(self.cfg_l)
        self.ready = False

    def models(self) -> Dict[str, nn.Module]:
        return {"t5": self.model, "clip_l": self.model_l}

    def init_params(self, state=None) -> None:
        """Materialise both towers on the device: from ``state`` (kind ->
        state dict) when given, else seeded random weights, then the
        checkpoints of ``weights_dir`` where they exist."""
        from genpc_tpu_torch.models.weights import (load_t5_and_clip_l,
                                                    materialize)
        for kind, mod in self.models().items():
            materialize(mod, self.device, self.dtype,
                        seed=None if state is not None else WEIGHT_SEED,
                        prefix=kind)
            if state is not None:
                mod.load_state_dict(state[kind], strict=True)
        if self.weights_dir:
            load_t5_and_clip_l(self.weights_dir, self.model, self.model_l)
        self.ready = True

    def release(self) -> None:
        """Both towers back to the meta device."""
        for mod in self.models().values():
            mod.to_empty(device="meta")
        self.ready = False

    @torch.inference_mode()
    def encode(self, prompts: Sequence[str] | str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(prompts, str):
            prompts = [prompts]
        ids, masks = map(np.stack, zip(*[self.tok(p) for p in prompts]))
        ids_l = np.stack([self.tok_l(p) for p in prompts])

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        ctx = self.model(dev(ids).long(), dev(masks))
        _, _, pooled = self.model_l(dev(ids_l).long())
        return ctx, pooled

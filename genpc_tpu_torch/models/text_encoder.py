"""CLIP text and vision towers and the CLIP BPE tokenizer (counterpart of
genpc_tpu/models/text_encoder.py).

SDXL conditions on two CLIP text towers: CLIP-L (quick-gelu) and
OpenCLIP-G (tanh gelu, with a text projection).  The context is the
PENULTIMATE layer's hidden states of both towers side by side; the
pooled vector is the G tower's EOS-token state after the final layer
norm, projected.  Parameter names are HF CLIPTextModel(WithProjection)'s.

zero123plus conditions on a CLIP ViT-H vision tower (``CLIPVisionModel``,
HF CLIPVisionModelWithProjection's names): its projected class-token
embedding is ramped into the SD2 text context.  ``clip_preprocess``
resizes with Pillow's bicubic filter, as the reference does, and
normalises with CLIP's mean and std.

Tokenization: the CLIP byte-pair encoding when the checkpoint's
vocab.json / merges.txt ship in ``<weights_dir>/tokenizer`` (it needs
the ``regex`` package, imported then), otherwise a stable hashing
tokenizer.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.models.layers import (
    F32, Conv2d, LayerNorm, Linear, attention, gelu_tanh)


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_len: int = 77
    act: str = "quick_gelu"      # clip-l: quick_gelu; openclip-g: gelu
    proj_dim: int = 0            # text_projection width (0 = absent)

    @classmethod
    def preset(cls, name: str) -> "CLIPTextConfig":
        if name == "tiny":
            return cls(vocab_size=1024, hidden_dim=64, num_layers=2,
                       num_heads=4, max_len=77)
        if name == "tiny_g":
            return cls(vocab_size=1024, hidden_dim=64, num_layers=2,
                       num_heads=4, max_len=77, act="gelu", proj_dim=64)
        if name == "clip_l":
            return cls(hidden_dim=768, num_layers=12, num_heads=12,
                       act="quick_gelu")
        if name == "clip_g":
            return cls(hidden_dim=1280, num_layers=32, num_heads=20,
                       act="gelu", proj_dim=1280)
        if name == "clip_sd2":
            return cls(hidden_dim=1024, num_layers=23, num_heads=16,
                       act="gelu")
        raise ValueError(name)


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_dim: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    patch: int = 14
    image_size: int = 224
    act: str = "gelu"
    proj_dim: int = 1024

    @classmethod
    def preset(cls, name: str) -> "CLIPVisionConfig":
        if name == "tiny":
            # the projection matches the tiny text width it is ramped into
            return cls(hidden_dim=64, num_layers=2, num_heads=4, patch=8,
                       image_size=32, proj_dim=64)
        if name == "vit_h":
            # the zero123plus image encoder: OpenCLIP ViT-H, projected to
            # the SD2 text width
            return cls()
        raise ValueError(name)


class _SelfAttn(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = Linear(d, d), Linear(d, d)
        self.v_proj, self.out_proj = Linear(d, d), Linear(d, d)

    def forward(self, x, causal: bool):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x),
                                       self.v_proj(x), self.heads, causal))


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(d, 4 * d), Linear(4 * d, d)


class CLIPBlock(nn.Module):
    """HF CLIPEncoderLayer: pre-LN attention + MLP."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.act = cfg.act
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = _SelfAttn(d, cfg.num_heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = _MLP(d)

    def forward(self, x, causal: bool = True):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        h = self.mlp.fc1(self.layer_norm2(x))
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = gelu_tanh(h)
        return x + self.mlp.fc2(h)


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_dim)
        self.position_embedding = nn.Embedding(cfg.max_len, cfg.hidden_dim)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPBlock(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_dim)


class CLIPTextModel(nn.Module):
    """ids [B, L] -> (last hidden, penultimate hidden, pooled)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)
        if cfg.proj_dim:
            self.text_projection = Linear(cfg.hidden_dim, cfg.proj_dim,
                                          bias=False, compute=F32)

    def forward(self, ids) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        tm = self.text_model
        x = tm.embeddings(ids)
        penult = x
        for i, blk in enumerate(tm.encoder.layers):
            if i == self.cfg.num_layers - 1:
                penult = x          # hidden_states[-2] (SDXL context)
            x = blk(x)
        x = tm.final_layer_norm(x)
        eos = torch.argmax(ids, dim=1)   # CLIP convention: highest id = EOT
        pooled = x[torch.arange(x.shape[0], device=x.device), eos]
        if self.cfg.proj_dim:
            pooled = self.text_projection(pooled)
        return x, penult, pooled


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = Conv2d(3, d, k=cfg.patch, stride=cfg.patch,
                                      bias=False, padding=0)
        self.position_embedding = nn.Embedding(
            1 + (cfg.image_size // cfg.patch) ** 2, d)

    def forward(self, imgs):
        x = self.patch_embedding(imgs).flatten(2).transpose(1, 2)
        # the concatenation promotes, as jnp.concatenate does
        dt = torch.promote_types(x.dtype, self.class_embedding.dtype)
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x.to(dt)], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None]


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_dim)   # HF's spelling
        self.encoder = _Encoder(CLIPTextConfig(
            hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, act=cfg.act))
        self.post_layernorm = LayerNorm(cfg.hidden_dim)


class CLIPVisionModel(nn.Module):
    """HF CLIPVisionModelWithProjection: images [B, 3, S, S] (CLIP-
    normalised) -> (tokens, image_embeds), image_embeds the projected
    post-layernorm class token.  Bidirectional attention."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionTransformer(cfg)
        self.visual_projection = Linear(cfg.hidden_dim, cfg.proj_dim,
                                        bias=False, compute=F32)

    def forward(self, imgs) -> Tuple[torch.Tensor, torch.Tensor]:
        vm = self.vision_model
        x = vm.pre_layrnorm(vm.embeddings(imgs))
        for blk in vm.encoder.layers:
            x = blk(x, causal=False)
        pooled = vm.post_layernorm(x[:, 0])
        return x, self.visual_projection(pooled)


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(img: np.ndarray, size: int) -> np.ndarray:
    """[H, W, 3] in [0, 1] -> CLIP-normalised [1, size, size, 3] (NHWC,
    numpy, as the reference returns it), resized with Pillow's bicubic
    filter."""
    from PIL import Image
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    x = np.asarray(Image.fromarray(u8).resize((size, size), Image.BICUBIC),
                   np.float32) / 255.0
    return ((x - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD)[None]


# ------------------------------------------------------------- tokenizers

def _bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2/CLIP reversible byte<->unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _word_pattern():
    # the CLIP pattern needs the \p{L} / \p{N} classes of `regex`
    import regex
    return regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """The CLIP byte-pair encoder (openai simple_tokenizer algorithm).

    vocab: token string -> id; merges: ranked BPE pairs.  Word tokens end
    with '</w>'.  The same ids as HF's CLIPTokenizer for the same files.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 max_len: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_len = max_len
        self.bos = vocab.get("<|startoftext|>", len(vocab) - 2)
        self.eos = vocab.get("<|endoftext|>", len(vocab) - 1)
        self.vocab_size = max(len(vocab), self.eos + 1)
        self.cache: Dict[str, str] = {}
        self.pattern = _word_pattern()

    @classmethod
    def from_dir(cls, path: str, max_len: int = 77) -> "CLIPTokenizer":
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(ln.split()) for ln in lines
                  if ln and not ln.startswith("#") and len(ln.split()) == 2]
        return cls(vocab, merges, max_len)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in self.pattern.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(tok).split(" "):
                ids.append(self.encoder.get(piece, self.eos))
        return ids

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.bos] + self.encode(text)[: self.max_len - 2] + [self.eos]
        ids += [self.eos] * (self.max_len - len(ids))   # CLIP pads with EOT
        return np.asarray(ids[: self.max_len], np.int32)


class HashTokenizer:
    """Deterministic fallback tokenizer (word -> stable hashed id)."""

    def __init__(self, vocab_size: int = 49408, max_len: int = 77):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def __call__(self, text: str) -> np.ndarray:
        words = text.lower().split()
        ids = [self.bos]
        for w in words[: self.max_len - 2]:
            h = int(hashlib.sha1(w.encode()).hexdigest()[:8], 16)
            ids.append(h % (self.vocab_size - 2))
        ids.append(self.eos)
        ids += [0] * (self.max_len - len(ids))
        return np.asarray(ids[: self.max_len], np.int32)


def make_tokenizer(weights_dir: Optional[str], vocab_size: int,
                   max_len: int = 77):
    """Real CLIP BPE when the checkpoint's vocab ships; hash otherwise."""
    if weights_dir:
        tok_dir = os.path.join(weights_dir, "tokenizer")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            return CLIPTokenizer.from_dir(tok_dir, max_len)
    return HashTokenizer(vocab_size, max_len)


class PromptEncoder:
    """Two-tower SDXL prompt encoding on ``device``.

    The towers are built on the meta device; ``weights.materialize`` (or
    a state dict) gives them their parameters.  ``encode`` returns
    (context [B, 77, D_l + D_g] from the penultimate layers, pooled
    [B, proj_g]): the tensors diffusers feeds the SDXL UNet.
    """

    def __init__(self, size: str = "tiny",
                 weights_dir: Optional[str] = None,
                 device: torch.device | str = "cpu"):
        if size == "tiny":
            self.cfg_l = CLIPTextConfig.preset("tiny")
            self.cfg_g = CLIPTextConfig.preset("tiny_g")
        else:
            self.cfg_l = CLIPTextConfig.preset("clip_l")
            self.cfg_g = CLIPTextConfig.preset("clip_g")
        self.device = torch.device(device)
        self.tok = make_tokenizer(weights_dir, self.cfg_l.vocab_size,
                                  self.cfg_l.max_len)
        with torch.device("meta"):
            self.model_l = CLIPTextModel(self.cfg_l)
            self.model_g = CLIPTextModel(self.cfg_g)

    @torch.inference_mode()
    def encode(self, prompts) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(prompts, str):
            prompts = [prompts]
        ids = torch.as_tensor(np.stack([self.tok(p) for p in prompts]),
                              dtype=torch.long, device=self.device)
        _, pen_l, _ = self.model_l(ids)
        _, pen_g, pooled = self.model_g(ids)
        return torch.cat([pen_l, pen_g], dim=-1), pooled

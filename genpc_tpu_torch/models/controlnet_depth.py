"""Depth-conditioned SDXL-class image generation, ControlNet or T2I-Adapter
(counterpart of genpc_tpu/models/controlnet_depth.py).

``ControlNetDepth(cfg, adapter=False, seed=0)`` builds the UNet, the
ControlNet (or the adapter), the VAE and the two CLIP towers at
``cfg.model_size`` ("tiny" for tests, "full" for SDXL widths) on
``cfg.device`` (the card by default; the CPU only when asked).  Weights
load from ``cfg.weights_dir`` when it holds the diffusers checkpoints,
else they are seeded random weights (random-weight output is noise; the
synthetic backend is the model-free default).

``generate`` mirrors the reference's contract: the depth image is cut
to uint8 and resampled with Lanczos-3 (``resize_lanczos_uint8``, bit for
bit Pillow's 8-bit path), the prompts are encoded, the initial latents
and one noise tensor a step are drawn from the backend's generator, and
the pure ``denoise`` runs the Euler-ancestral loop (ControlNet + two
UNet passes a step, classifier-free guidance 5.0, 30 steps; on the card
each step is one CUDA graph replay) and the VAE decode.  As in the
reference, the unconditional branch gets no ControlNet residuals.
Parameters are fp32 at the test presets and bf16 at full size, with the
reference's per-layer compute types (models/layers.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.categories import get_category
from genpc_tpu_torch.models.adapter import T2IAdapter
from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import BF16, F32, timestep_embedding
from genpc_tpu_torch.models.schedulers import EulerAncestral, cfg_combine
from genpc_tpu_torch.models.text_encoder import PromptEncoder
from genpc_tpu_torch.models.unet import ControlNet, UNet2DCondition, UNetConfig
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from genpc_tpu_torch.models.weights import (
    load_clip_towers, load_sdxl_controlnet, materialize)
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import count, span

POSITIVE_TEMPLATE = ("A photo of {category}, 3d model, high resolution,"
                     "high quality,highly detailed,highly realistic,"
                     "clean look,no shadow,")
NEGATIVE_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing "
                   "fingers, extra digit, fewer digits, cropped, worst "
                   "quality, low quality")
#: the random weights' seed (the reference initialises from PRNGKey(0)
#: whatever the backend's seed)
WEIGHT_SEED = 0


# ------------------------------------------------------------ Lanczos-3

_PRECISION_BITS = 22     # Pillow's 8-bit resampling: 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos3(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: per output
    pixel the first input index and ksize 22-bit fixed-point weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    k = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos3((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        ww = 0.0
        for wi in w:
            ww += wi
        for x, wi in enumerate(w):
            wi = wi / ww if ww != 0.0 else wi
            k[xx, x] = int((-0.5 if wi < 0 else 0.5)
                           + wi * (1 << _PRECISION_BITS))
            idx[xx, x] = xmin + x
    return idx, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    idx, k = _lanczos_coeffs(img.shape[axis], out_size)
    a = np.moveaxis(img.astype(np.int64), axis, 0)            # [in, ...]
    acc = (a[idx] * k.reshape(k.shape + (1,) * (a.ndim - 1))).sum(1)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.moveaxis(np.clip(acc, 0, 255).astype(np.uint8), 0, axis)


def resize_lanczos_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [size, size, C] as Pillow's
    ``Image.resize((size, size), Image.LANCZOS)`` computes it: the
    horizontal pass first, each pass rounded and clipped to uint8."""
    out = img
    if img.shape[1] != size:
        out = _resample_axis(out, size, axis=1)
    if img.shape[0] != size:
        out = _resample_axis(out, size, axis=0)
    return out


# ------------------------------------------------------------- backend


# ------------------------------------------------------------- backend

class ControlNetDepth:
    """depth image -> RGB image; ``generate`` mirrors the reference."""

    def __init__(self, cfg=None, adapter: bool = False, seed: int = 0):
        self.cfg = cfg or {}
        size = self.cfg.get("model_size", "tiny")
        self.adapter = adapter
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if size == "full" else F32
        self.unet_cfg = UNetConfig.preset("sdxl" if size == "full" else size)
        self.vae_cfg = VAEConfig.preset("full" if size == "full" else "tiny")
        self.factor = self.vae_cfg.spatial_factor
        cond_ch = (16, 32, 96, 256)[: int(math.log2(self.factor)) + 1]
        with torch.device("meta"):
            self.unet = UNet2DCondition(self.unet_cfg)
            if adapter:
                # each level's feature matches the level's INPUT width:
                # the downsample keeps the previous level's channels
                boc = self.unet_cfg.block_out_channels
                self.controlnet = T2IAdapter((boc[0],) + boc[:-1],
                                             downscale=self.factor)
            else:
                self.controlnet = ControlNet(self.unet_cfg,
                                             cond_channels=cond_ch)
            self.vae = AutoencoderKL(self.vae_cfg)
        self.prompt_encoder = PromptEncoder(
            "full" if size == "full" else "tiny",
            weights_dir=self.cfg.get("weights_dir"), device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._ready = False
        self._graphs: Dict[tuple, GraphedCall] = {}

    # ------------------------------------------------------------------
    def models(self) -> Dict[str, nn.Module]:
        """The backend's models by kind (``weights.from_flax``'s names)."""
        return {"unet": self.unet,
                "adapter" if self.adapter else "controlnet": self.controlnet,
                "vae": self.vae, "clip_l": self.prompt_encoder.model_l,
                "clip_g": self.prompt_encoder.model_g}

    def init_params(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Materialise every model on the device: from ``state`` (kind ->
        state dict) when given, else seeded random weights, then the
        checkpoints of ``cfg.weights_dir`` where they exist."""
        self._graphs.clear()
        for kind, mod in self.models().items():
            materialize(mod, self.device, self.dtype,
                        seed=None if state is not None else WEIGHT_SEED,
                        prefix=kind)
            if state is not None:
                mod.load_state_dict(state[kind], strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            # a real T2I-Adapter checkpoint has no loader yet (ROADMAP)
            load_sdxl_controlnet(weights_dir, self.unet,
                                 None if self.adapter else self.controlnet,
                                 self.vae)
            load_clip_towers(weights_dir, self.prompt_encoder.model_l,
                             self.prompt_encoder.model_g)
        self._ready = True

    def release(self) -> None:
        """Free the parameters of every model (back to the meta device)
        and the allocator's cache; a later ``generate`` materialises them
        anew."""
        self._graphs.clear()
        for mod in self.models().values():
            mod.to_empty(device="meta")
        self._ready = False
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def _added_cond(self, pooled, size: int):
        """SDXL micro-conditioning: concat(pooled, sinusoid_256(time_ids))
        with time_ids = (orig_h, orig_w, crop_top, crop_left, tgt_h,
        tgt_w)."""
        time_ids = torch.tensor([size, size, 0, 0, size, size],
                                dtype=F32, device=pooled.device)
        time_emb = timestep_embedding(time_ids, 256).reshape(1, -1)
        return torch.cat([pooled, time_emb], dim=-1)

    def encode_prompts(self, category: str, size: int):
        """(ctx, ctx_neg, added, added_neg) for the product prompt and the
        negative prompt; the two-tower context is tiled and cut to the
        UNet's context width where they differ (the tiny presets)."""
        pe = self.prompt_encoder
        ctx, pooled = pe.encode(POSITIVE_TEMPLATE.format(category=category))
        ctx_neg, pooled_neg = pe.encode(NEGATIVE_PROMPT)
        cd = self.unet_cfg.context_dim
        if ctx.shape[-1] != cd:
            reps = -(-cd // ctx.shape[-1])
            ctx = ctx.repeat(1, 1, reps)[..., :cd]
            ctx_neg = ctx_neg.repeat(1, 1, reps)[..., :cd]
        return (ctx, ctx_neg, self._added_cond(pooled, size),
                self._added_cond(pooled_neg, size))

    def guided_eps(self, x, t, cond, ctx, ctx_neg, added, added_neg,
                   guidance: float = 5.0, control_scale: float = 1.0,
                   adapter_feats: Optional[List[torch.Tensor]] = None):
        """One guided model evaluation: the ControlNet and the conditional
        UNet (or the UNet with the adapter's features), then the
        unconditional UNet, combined by classifier-free guidance."""
        if self.adapter:
            eps_c = self.unet(x, t, ctx, added_cond=added,
                              adapter_features=adapter_feats)
        else:
            res = self.controlnet(x, t, ctx, cond, added_cond=added,
                                  conditioning_scale=control_scale)
            eps_c = self.unet(x, t, ctx, added_cond=added,
                              control_residuals=res)
        eps_u = self.unet(x, t, ctx_neg, added_cond=added_neg)
        return cfg_combine(eps_u, eps_c, guidance)

    def step_eps(self, x, t, cond, ctx, ctx_neg, added, added_neg,
                 guidance: float = 5.0, control_scale: float = 1.0,
                 adapter_feats: Optional[List[torch.Tensor]] = None):
        """``guided_eps`` as the loop runs it: eagerly on the CPU; on the
        card through a CUDA graph captured at the first call with these
        shapes, guidance and scale (a returned tensor is overwritten by
        the next call)."""
        def step(x, t, cond, ctx, ctx_neg, added, added_neg, *feats):
            return self.guided_eps(x, t, cond, ctx, ctx_neg, added,
                                   added_neg, guidance, control_scale,
                                   list(feats) if self.adapter else None)

        return graphed_call(self._graphs, (guidance, control_scale), step,
                            [x, t, cond, ctx, ctx_neg, added, added_neg,
                             *(adapter_feats or ())], self.device)

    @torch.inference_mode()
    def denoise_latents(self, cond, ctx, ctx_neg, added, added_neg,
                        latents, noises, guidance: float = 5.0,
                        control_scale: float = 1.0):
        """The Euler-ancestral loop, pure: ``latents`` [1,C,h,w] and
        ``noises`` [steps,1,C,h,w] are N(0, 1) draws; one step a noise."""
        sched = EulerAncestral(len(noises), device=latents.device)
        x = latents * sched.init_noise_sigma
        feats = ([f * control_scale for f in self.controlnet(cond)]
                 if self.adapter else None)
        for i in range(len(noises)):
            eps = self.step_eps(sched.scale_model_input(x, i),
                                sched.timesteps[i:i + 1], cond, ctx,
                                ctx_neg, added, added_neg, guidance,
                                control_scale, feats)
            x = sched.step(eps, i, x, noises[i])
        return x

    @torch.inference_mode()
    def decode(self, latents):
        """Latents -> image [1,3,H,W] in [0, 1]."""
        img = self.vae.decode(latents)
        return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)

    def denoise(self, cond, ctx, ctx_neg, added, added_neg, latents, noises,
                guidance: float = 5.0, control_scale: float = 1.0):
        """``denoise_latents`` then ``decode``: image [1,3,H,W] in [0, 1]."""
        return self.decode(self.denoise_latents(
            cond, ctx, ctx_neg, added, added_neg, latents, noises, guidance,
            control_scale))

    # ------------------------------------------------------------------
    def prepare_depth(self, depth, size: int) -> torch.Tensor:
        """Depth [3,H,W], [H,W,3] or [H,W] in [0, 1] -> the conditioning
        image [1,3,size,size] in [-1, 1] on the device."""
        d = np.asarray(depth, np.float32)
        if d.ndim == 3 and d.shape[0] in (1, 3):
            d = d.transpose(1, 2, 0)
        if d.ndim == 2:
            d = d[..., None]
        if d.shape[-1] == 1:
            d = np.repeat(d, 3, axis=-1)
        if d.shape[0] != size:
            u8 = (np.clip(d, 0, 1) * 255).astype(np.uint8)
            d = resize_lanczos_uint8(u8, size).astype(np.float32) / 255.0
        c = np.ascontiguousarray((d * 2.0 - 1.0).transpose(2, 0, 1))
        return torch.from_numpy(c)[None].to(self.device)

    def generate(self, depth, category_or_flag: str, size: int = 512,
                 controlnet_conditioning_scale: float = 1.0,
                 num_inference_steps: int = 30) -> np.ndarray:
        """Depth [3,H,W] or [H,W,3] float in [0,1] -> RGB [size,size,3]."""
        cond = self.prepare_depth(depth, size)
        if not self._ready:
            with span("init", sync=self.device):
                self.init_params()
        with span("prompt", sync=self.device):
            conds = self.encode_prompts(get_category(category_or_flag), size)
        h = size // self.factor
        shape = (1, self.unet_cfg.in_channels, h, h)
        latents = torch.randn(shape, generator=self.generator,
                              device=self.device)
        noises = torch.randn((num_inference_steps,) + shape,
                             generator=self.generator, device=self.device)
        with span("denoise", sync=self.device):
            count("steps", num_inference_steps)
            lat = self.denoise_latents(cond, *conds, latents, noises,
                                       guidance=5.0,
                                       control_scale=controlnet_conditioning_scale)
        with span("decode", sync=self.device):
            img = self.decode(lat)
        return img[0].permute(1, 2, 0).cpu().numpy()

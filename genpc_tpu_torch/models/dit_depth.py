"""Depth->image by the Qwen-Image-Edit MMDiT and rectified flow
(counterpart of the Qwen half of genpc_tpu/models/dit_depth.py).

``DiTDepthEdit(cfg, variant="qwen", seed=0)`` builds, on ``cfg.device``
(the card by default; the CPU only when asked) and at ``cfg.model_size``
("tiny" and "base" for tests, "full" for Qwen-Image-Edit's widths), the
MMDiT, the 16-channel VAE (the reference's FLUX-family preset; tiny
below full size) and the Qwen2.5-VL towers.  ``generate_batch`` follows
the reference:
  * each object's prompt and its depth image are encoded twice by
    Qwen2.5-VL (the product prompt and a ``" "`` negative, each with the
    image), padded to a token budget (512 at full size) with a key mask;
  * the depth image (Pillow's bilinear resize) is VAE-encoded and its
    latents join the sequence;
  * the sampler is FlowMatchEuler (shift 3.0, 8 steps) with true CFG 4.0:
    a conditional and an unconditional pass a step, combined by
    ``cfg_combine``; on the card each step (both passes, the combination
    and the Euler step) is one CUDA graph replay;
  * the initial latents come from one generator per object, seeded by
    the backend's seed and a running object counter, so grouping objects
    into batches changes no image.
``denoise_latents`` is pure: it takes its N(0, 1) draws.  Weight-only
quantisation is not ported: ``quant_bits`` and ``tower_quant_bits``
default, as in the reference, to int4 at full size, and only 0 (bf16)
builds.  Both models stay on the card between calls; ``release()`` frees
them.  The "flux" variant and ``FluxInpainter`` wait for T5.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.categories import get_category
from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import BF16, F32
from genpc_tpu_torch.models.qwen_vl import QwenVLEncoder, resolve_quant_bits
from genpc_tpu_torch.models.schedulers import FlowMatchEuler, at, cfg_combine
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import StageTimer

QWEN_PROMPT = (
    "A highly realistic {category} with a common, ordinary appearance, "
    "matching typical designs found in everyday life. "
    "Rendered in a professional product photography style with "
    "studio-grade natural lighting, soft and evenly distributed "
    "illumination. Realistic materials and natural textures, without "
    "exaggerated shapes or conceptual designs. Accurate proportions, "
    "reasonable structure, and clearly visible details, shown from a 3/4 "
    "perspective view to present the overall form. A clean white neutral "
    "background with sharp focus. The overall style is realistic, simple, "
    "and practical, making the object look like a real, commonly "
    "available item in everyday use.")
#: the random weights' seed (the reference initialises from PRNGKey(0)
#: whatever the backend's seed)
WEIGHT_SEED = 0
_FLUX = "(ROADMAP: FLUX and T5)"


def _pad_tokens(ctx: torch.Tensor, budget: int):
    """[L, D] -> ([budget, D], [budget] bool mask); truncates over-budget."""
    L, D = ctx.shape
    out = ctx.new_zeros((budget, D))
    n = min(L, budget)
    out[:n] = ctx[:n]
    mask = torch.zeros(budget, dtype=torch.bool, device=ctx.device)
    mask[:n] = True
    return out, mask


class DiTDepthEdit:
    """depth image -> RGB image; ``generate``/``generate_batch`` mirror
    the reference."""

    def __init__(self, cfg=None, variant: str = "qwen", seed: int = 0):
        if variant != "qwen":
            raise NotImplementedError(
                f"DiT variant {variant!r} is not ported to genpc_tpu_torch "
                f"yet {_FLUX}")
        self.cfg = cfg or {}
        size = self.cfg.get("model_size", "tiny")
        self.full = size == "full"
        resolve_quant_bits(self.cfg.get("quant_bits"), self.full,
                           "quant_bits")
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if self.full else F32
        self.dit_cfg = DiTConfig.preset(
            "qwen" if self.full else
            "base_qwen" if size == "base" else "tiny_qwen")
        self.vae_cfg = VAEConfig.preset("flux" if self.full else "tiny")
        self.factor = self.vae_cfg.spatial_factor
        self.vl = QwenVLEncoder("full" if self.full else "tiny",
                                weights_dir=self.cfg.get("weights_dir"),
                                quant_bits=self.cfg.get("tower_quant_bits"),
                                device=self.device)
        with torch.device("meta"):
            self.model = MMDiT(self.dit_cfg)
            self.vae = AutoencoderKL(self.vae_cfg)
        self.txt_budget = 512 if self.full else 160
        self.seed = seed
        self._noise_ctr = 0
        self.steps, self.guidance = 8, 4.0     # the reference's settings
        #: spans of generate_batch: vl_init, encode, dit_init, denoise,
        #: decode; and release
        self.timer = StageTimer(self.device)
        self._ready = False
        self._graphs: Dict[tuple, GraphedCall] = {}

    # ------------------------------------------------------------------
    def models(self) -> Dict[str, nn.Module]:
        """The backend's models by kind (``weights.from_flax``'s names)."""
        return {"dit": self.model, "vae": self.vae, **self.vl.models()}

    def init_dit(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Materialise the MMDiT and the VAE on the device: from ``state``
        when given, else seeded random weights, then the transformer
        checkpoint of ``cfg.weights_dir`` where it exists (the reference
        loads no VAE for this backend)."""
        from genpc_tpu_torch.models.weights import load_dit, materialize
        self._graphs.clear()
        for kind in ("dit", "vae"):
            mod = self.models()[kind]
            materialize(mod, self.device, self.dtype,
                        seed=None if state is not None else WEIGHT_SEED,
                        prefix=kind)
            if state is not None:
                mod.load_state_dict(state[kind], strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_dit(weights_dir, self, "qwen")
        self._ready = True

    def init_params(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Every model on the device (the VL towers, the MMDiT, the VAE)."""
        self.vl.init_params(state)
        self.init_dit(state)

    def release(self) -> None:
        """Free the parameters of every model (back to the meta device),
        the step graphs and the allocator's cache; the next call
        materialises them anew."""
        with self.timer.span("release"):
            self._graphs.clear()
            for mod in (self.model, self.vae):
                mod.to_empty(device="meta")
            self.vl.release()
            self._ready = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_prompts(self, categories: Sequence[str], depths01):
        """-> (txt, mask, txt_neg, mask_neg), [B, budget, hidden] fp32 and
        [B, budget] bool: per object the product prompt and " ", each
        encoded with the object's depth image [size, size, 3]."""
        out = [[], [], [], []]
        for cat, d in zip(categories, depths01):
            for j, prompt in enumerate((QWEN_PROMPT.format(category=cat),
                                        " ")):
                ctx, m = _pad_tokens(self.vl.encode(prompt, d)[0],
                                     self.txt_budget)
                out[2 * j].append(ctx)
                out[2 * j + 1].append(m)
        return tuple(torch.stack(x) for x in out)

    @torch.inference_mode()
    def cond_latents(self, depths01: np.ndarray) -> torch.Tensor:
        """depth images [B, size, size, 3] in [0, 1] -> VAE latents [B, Cc,
        h, w], tiled to the DiT's condition channels where they differ."""
        img = torch.from_numpy(np.ascontiguousarray(
            depths01.transpose(0, 3, 1, 2))).to(self.device)
        lat = self.vae.encode(img * 2 - 1)
        cc = self.dit_cfg.cond_channels
        if lat.shape[1] != cc:
            lat = lat.repeat(1, -(-cc // lat.shape[1]), 1, 1)[:, :cc]
        return lat

    def guided_velocity(self, latents, t, cond_lat, txt, mask, txt_neg,
                        mask_neg):
        """True CFG: the conditional and the unconditional pass, combined
        at the backend's guidance."""
        v_c = self.model(latents, t, txt, cond_latents=cond_lat,
                         txt_mask=mask)
        v_u = self.model(latents, t, txt_neg, cond_latents=cond_lat,
                         txt_mask=mask_neg)
        return cfg_combine(v_u, v_c, self.guidance)

    def sample_step(self, latents, i, cond_lat, txt, mask, txt_neg,
                    mask_neg, sched: FlowMatchEuler):
        """One sampler step for B objects; i a [1] step index."""
        t = at(sched.timesteps, i).expand(latents.shape[0])
        v = self.guided_velocity(latents, t, cond_lat, txt, mask, txt_neg,
                                 mask_neg)
        return sched.step(v, i, latents)

    def _step(self, sched, tensors):
        """``sample_step`` as the loop runs it: eagerly on the CPU; on the
        card through a CUDA graph captured at the first call with these
        shapes (a returned tensor is overwritten by the next call)."""
        return graphed_call(self._graphs, (sched.num_steps, self.guidance),
                            lambda *a: self.sample_step(*a, sched), tensors,
                            self.device)

    @torch.inference_mode()
    def denoise_latents(self, cond_lat, txt, mask, txt_neg, mask_neg,
                        latents, steps: int) -> torch.Tensor:
        """The rectified-flow loop, pure: ``latents`` [B, C, h, w] are the
        N(0, 1) draws."""
        sched = FlowMatchEuler(steps, device=latents.device)
        x = latents
        for i in range(steps):
            idx = torch.tensor([i], device=latents.device)
            x = self._step(sched, [x, idx, cond_lat, txt, mask, txt_neg,
                                   mask_neg]).clone()
        return x

    @torch.inference_mode()
    def decode(self, latents) -> torch.Tensor:
        """Latents -> images [B, 3, H, W] in [0, 1]."""
        return torch.clamp(self.vae.decode(latents) / 2.0 + 0.5, 0.0, 1.0)

    def draws(self, b: int, latent_hw: int) -> torch.Tensor:
        """N(0, 1) initial latents [b, C, h, w], one generator per object
        seeded by (the backend's seed, the running object counter)."""
        shape = (self.dit_cfg.in_channels, latent_hw, latent_hw)
        out = []
        for i in range(b):
            g = torch.Generator(device=self.device)
            g.manual_seed((self.seed << 32) + self._noise_ctr + i)
            out.append(torch.randn(shape, generator=g, device=self.device))
        self._noise_ctr += b
        return torch.stack(out)

    # ------------------------------------------------------------------
    @staticmethod
    def prep_depth(depth, size: int) -> np.ndarray:
        """Depth [3,H,W], [H,W,3] or [H,W] in [0, 1] -> [size, size, 3],
        resized (when its side differs) by Pillow's bilinear filter on
        uint8, as the reference."""
        d = np.asarray(depth, np.float32)
        if d.ndim == 3 and d.shape[0] in (1, 3):
            d = d.transpose(1, 2, 0)
        if d.ndim == 2:
            d = d[..., None]
        if d.shape[-1] == 1:
            d = np.repeat(d, 3, axis=-1)
        if d.shape[0] != size:
            from PIL import Image
            d = np.asarray(Image.fromarray(
                (np.clip(d, 0, 1) * 255).astype(np.uint8)).resize(
                (size, size), Image.BILINEAR), np.float32) / 255.0
        return d

    def generate_batch(self, depths, categories_or_flags: Sequence[str],
                       size: int = 512,
                       num_inference_steps: Optional[int] = None
                       ) -> np.ndarray:
        """B depth images -> B RGB images [B, size, size, 3] in [0, 1]: the
        prompts are encoded, then the B objects denoise together."""
        depths01 = np.stack([self.prep_depth(d, size) for d in depths])
        cats: List[str] = [get_category(f) for f in categories_or_flags]
        if not self.vl.ready:
            with self.timer.span("vl_init"):
                self.vl.init_params()
        with self.timer.span("encode"):
            txt, mask, neg, nmask = self.encode_prompts(cats, depths01)
        if not self._ready:
            with self.timer.span("dit_init"):
                self.init_dit()
        latents = self.draws(len(depths01), size // self.factor)
        with self.timer.span("denoise"):
            lat = self.denoise_latents(
                self.cond_latents(depths01), txt, mask, neg, nmask, latents,
                num_inference_steps or self.steps)
        with self.timer.span("decode"):
            img = self.decode(lat)
        return img.permute(0, 2, 3, 1).cpu().numpy()

    def generate(self, depth, category_or_flag: str, size: int = 512,
                 num_inference_steps: Optional[int] = None) -> np.ndarray:
        """Depth [3,H,W] or [H,W,3] in [0, 1] -> RGB [size, size, 3]."""
        return self.generate_batch([depth], [category_or_flag], size,
                                   num_inference_steps)[0]


class FluxInpainter:
    """The FLUX depth inpainter: not ported yet."""

    def __init__(self, cfg=None, seed: int = 0):
        raise NotImplementedError(
            f"FluxInpainter is not ported to genpc_tpu_torch yet {_FLUX}")

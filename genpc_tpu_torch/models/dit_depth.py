"""Depth->image by an MMDiT and rectified flow, the Qwen-Image-Edit and
FLUX.1-Depth-dev backends, and the FLUX inpainter (counterpart of
genpc_tpu/models/dit_depth.py).

``DiTDepthEdit(cfg, variant, seed=0)`` builds, on ``cfg.device`` (the card
by default; the CPU only when asked) and at ``cfg.model_size`` ("tiny"
and "base" for tests, "full" for the published widths), the MMDiT, the
16-channel VAE (the reference's FLUX-family preset; tiny below full
size) and the variant's prompt towers.  ``generate_batch`` follows the
reference:
  * variant "qwen" (Qwen-Image-Edit): each object's prompt and its depth
    image are encoded twice by Qwen2.5-VL (the product prompt and a
    ``" "`` negative, each with the image), padded to a token budget (512
    at full size) with a key mask; the depth image's VAE latents join
    the sequence; 8 steps with true CFG 4.0 (a conditional and an
    unconditional pass a step, combined by ``cfg_combine``);
  * variant "flux" (FLUX.1-Depth-dev): the objects' ``FLUX_PROMPT``s are
    encoded in one call by T5-XXL (512 tokens, no key mask into the
    MMDiT) and CLIP-L (the pooled vector, tiled to the MMDiT's pooled
    width); the depth image's VAE latents, tiled to the condition
    channels, join the latents along the channels; 30 steps at the
    distilled guidance 10.0 as the guidance embedding, no CFG branch;
  * the sampler is FlowMatchEuler (shift 3.0); on the card each step is
    one CUDA graph replay (``graphs.graphed_call``);
  * the initial latents come from one generator per object, seeded by
    the backend's seed and a running object counter, so grouping objects
    into batches changes no image;
  * the first Euler step's velocity of each object is kept, copied on
    the device inside the loop and to the host once the images are
    (``first_velocity``, of the last call), and the ``denoise`` span
    counts the batch rows and the image and text positions of every
    step (``rows``, ``img_tokens``, ``txt_tokens``).
``denoise_latents`` is pure: it takes its N(0, 1) draws.  ``quant_bits``
(the MMDiT) and ``tower_quant_bits`` (Qwen2.5-VL or T5) default, as in
the reference, to int4 at full size and bf16 below; 8 and 0 build too
(``quant.py``).  The models stay on the card between calls; ``release()``
frees every one of them, the prompt towers included (the reference's
frees Qwen's tower but not FLUX's T5).

``FluxInpainter.paint`` fills the hole of an image with the FLUX sampler
(its own ``DiTDepthEdit("flux")``): after each Euler step the latents
outside the hole are replaced by the known image's latents re-noised to
the next flow time, and the decoded image keeps the known pixels.  It
keeps the call's first velocity and counts in its ``inpaint`` span as
``generate_batch`` does in ``denoise``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.categories import get_category
from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import BF16, F32
from genpc_tpu_torch.models.quant import resolve_quant_bits
from genpc_tpu_torch.models.qwen_vl import QwenVLEncoder
from genpc_tpu_torch.models.schedulers import FlowMatchEuler, at, cfg_combine
from genpc_tpu_torch.models.t5 import T5PromptEncoder
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import count, span

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
FLUX_PROMPT = (
    "A raw photo of a {category}. no reflections, high quality, rich "
    "details. Shot with a macro lens (f/2.8, 50mm) and a Canon EOSR5")
#: the random weights' seed (the reference initialises from PRNGKey(0)
#: whatever the backend's seed)
WEIGHT_SEED = 0
#: (steps, guidance) of each variant: the reference's settings
SETTINGS = {"qwen": (8, 4.0), "flux": (30, 10.0)}


def _pad_tokens(ctx: torch.Tensor, budget: int):
    """[L, D] -> ([budget, D], [budget] bool mask); truncates over-budget."""
    L, D = ctx.shape
    out = ctx.new_zeros((budget, D))
    n = min(L, budget)
    out[:n] = ctx[:n]
    mask = torch.zeros(budget, dtype=torch.bool, device=ctx.device)
    mask[:n] = True
    return out, mask


def _tile(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x repeated along ``dim`` and cut to ``n`` there (the reference's
    ``jnp.tile(...)[..., :n]``)."""
    if x.shape[dim] == n:
        return x
    reps = [1] * x.ndim
    reps[dim] = -(-n // x.shape[dim])
    return x.repeat(*reps).narrow(dim, 0, n)


def _preset(variant: str, size: str) -> str:
    if size == "full":
        return variant
    if size == "base":
        return "base_qwen" if variant == "qwen" else "base"
    return "tiny_qwen" if variant == "qwen" else "tiny"


class DiTDepthEdit:
    """depth image -> RGB image; ``generate``/``generate_batch`` mirror
    the reference."""

    def __init__(self, cfg=None, variant: str = "qwen", seed: int = 0):
        if variant not in SETTINGS:
            raise ValueError(f"unknown DiT variant {variant!r}")
        self.cfg = cfg or {}
        self.variant = variant
        size = self.cfg.get("model_size", "tiny")
        self.full = size == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if self.full else F32
        self.dit_cfg = dataclasses.replace(
            DiTConfig.preset(_preset(variant, size)),
            quant_bits=resolve_quant_bits(self.cfg.get("quant_bits"),
                                          self.full))
        self.vae_cfg = VAEConfig.preset("flux" if self.full else "tiny")
        self.factor = self.vae_cfg.spatial_factor
        tower = dict(weights_dir=self.cfg.get("weights_dir"),
                     quant_bits=self.cfg.get("tower_quant_bits"),
                     device=self.device)
        if variant == "qwen":
            self.vl = QwenVLEncoder("full" if self.full else "tiny", **tower)
            self.tower, self.tower_name = self.vl, "vl"
            self.txt_budget = 512 if self.full else 160
        else:
            self.t5 = T5PromptEncoder("full" if self.full else "tiny",
                                      **tower)
            self.tower, self.tower_name = self.t5, "t5"
        with torch.device("meta"):
            self.model = MMDiT(self.dit_cfg)
            self.vae = AutoencoderKL(self.vae_cfg)
        self.seed = seed
        self._noise_ctr = 0
        self.steps, self.guidance = SETTINGS[variant]
        #: the last ``generate_batch``'s first-step velocities [B, C, h, w]
        #: (host, fp32)
        self.first_velocity: Optional[np.ndarray] = None
        self._ready = False
        self._graphs: Dict[tuple, GraphedCall] = {}

    # ------------------------------------------------------------------
    def models(self) -> Dict[str, nn.Module]:
        """The backend's models by kind (``weights.from_flax``'s names)."""
        return {"dit": self.model, "vae": self.vae, **self.tower.models()}

    def init_dit(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Materialise the MMDiT and the VAE on the device: from ``state``
        when given, else seeded random weights (the MMDiT's block matmuls
        drawn in their quantised form), then the transformer checkpoint
        of ``cfg.weights_dir`` where it exists (the reference loads no
        VAE for these backends)."""
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
            load_dit(weights_dir, self, self.variant)
        self._ready = True

    def init_params(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Every model on the device (the prompt towers, the MMDiT, the
        VAE)."""
        self.tower.init_params(state)
        self.init_dit(state)

    def release(self) -> None:
        """Free the parameters of every model (back to the meta device),
        the prompt towers included, the step graphs and the allocator's
        cache; the next call materialises them anew."""
        with span("release", sync=self.device):
            self._graphs.clear()
            for mod in (self.model, self.vae):
                mod.to_empty(device="meta")
            self.tower.release()
            self._ready = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_flux(self, prompts: Sequence[str]):
        """FLUX: -> (T5 context [B, L, 4096] fp32, CLIP-L pooled [B,
        pooled_dim], tiled to the MMDiT's pooled width)."""
        ctx, pooled = self.t5.encode(list(prompts))
        return ctx, _tile(pooled, self.dit_cfg.pooled_dim, -1)

    @torch.inference_mode()
    def encode_prompts(self, categories: Sequence[str], depths01):
        """The conditioning tensors of ``sample_step``.  qwen: (txt, mask,
        txt_neg, mask_neg), [B, budget, hidden] fp32 and [B, budget] bool:
        per object the product prompt and " ", each encoded with the
        object's depth image [size, size, 3].  flux: (txt, pooled) of the
        objects' FLUX_PROMPTs, in one call."""
        if self.variant == "flux":
            return self.encode_flux([FLUX_PROMPT.format(category=c)
                                     for c in categories])
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
        return _tile(self.vae.encode(img * 2 - 1),
                     self.dit_cfg.cond_channels, 1)

    def velocity(self, latents, t, cond_lat, *cond):
        """qwen: true CFG, the conditional and the unconditional pass
        combined at the backend's guidance; flux: one pass with the
        guidance as the distilled guidance embedding."""
        if self.variant == "flux":
            txt, pooled = cond
            return self.model(latents, t, txt, pooled=pooled,
                              cond_latents=cond_lat,
                              guidance=torch.full_like(t, self.guidance))
        txt, mask, txt_neg, mask_neg = cond
        v_c = self.model(latents, t, txt, cond_latents=cond_lat,
                         txt_mask=mask)
        v_u = self.model(latents, t, txt_neg, cond_latents=cond_lat,
                         txt_mask=mask_neg)
        return cfg_combine(v_u, v_c, self.guidance)

    def sample_step(self, latents, i, cond_lat, *args):
        """One sampler step for B objects: i a [1] step index; ``args``
        the conditioning tensors of ``encode_prompts``, then the
        scheduler.  Returns (the next latents, the step's velocity)."""
        *cond, sched = args
        t = at(sched.timesteps, i).expand(latents.shape[0])
        v = self.velocity(latents, t, cond_lat, *cond)
        return sched.step(v, i, latents), v

    def _step(self, sched, tensors):
        """``sample_step`` as the loop runs it: eagerly on the CPU; on the
        card through a CUDA graph captured at the first call with these
        shapes (a returned tensor is overwritten by the next call)."""
        return graphed_call(self._graphs, (sched.num_steps, self.guidance),
                            lambda *a: self.sample_step(*a, sched), tensors,
                            self.device)

    @torch.inference_mode()
    def denoise_latents(self, cond_lat, cond: Sequence[torch.Tensor],
                        latents, steps: int):
        """The rectified-flow loop, pure: ``latents`` [B, C, h, w] are the
        N(0, 1) draws, ``cond`` what ``encode_prompts`` returns ->
        (the final latents, the first step's velocity [B, C, h, w])."""
        sched = FlowMatchEuler(steps, device=latents.device)
        x, v0 = latents, None
        for i in range(steps):
            idx = torch.tensor([i], device=latents.device)
            x, v = self._step(sched, [x, idx, cond_lat, *cond])
            x = x.clone()
            if i == 0:
                v0 = v.clone()
        return x, v0

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

    def ensure_ready(self) -> None:
        """The prompt towers, then the MMDiT and VAE, materialised where
        they are not (spans ``<tower>_init`` and ``dit_init``)."""
        if not self.tower.ready:
            with span(f"{self.tower_name}_init", sync=self.device):
                self.tower.init_params()
        if not self._ready:
            with span("dit_init", sync=self.device):
                self.init_dit()

    def generate_batch(self, depths, categories_or_flags: Sequence[str],
                       size: int = 512,
                       num_inference_steps: Optional[int] = None
                       ) -> np.ndarray:
        """B depth images -> B RGB images [B, size, size, 3] in [0, 1]: the
        prompts are encoded, then the B objects denoise together."""
        depths01 = np.stack([self.prep_depth(d, size) for d in depths])
        cats: List[str] = [get_category(f) for f in categories_or_flags]
        self.ensure_ready()
        with span("encode", sync=self.device):
            cond = self.encode_prompts(cats, depths01)
        latents = self.draws(len(depths01), size // self.factor)
        steps = num_inference_steps or self.steps
        with span("denoise", sync=self.device):
            count_positions(steps, latents, cond[0], self.dit_cfg.patch_size)
            lat, v0 = self.denoise_latents(self.cond_latents(depths01), cond,
                                           latents, steps)
        with span("decode", sync=self.device):
            img = self.decode(lat)
            out = img.permute(0, 2, 3, 1).cpu().numpy()
        self.first_velocity = v0.cpu().numpy()
        return out

    def generate(self, depth, category_or_flag: str, size: int = 512,
                 num_inference_steps: Optional[int] = None) -> np.ndarray:
        """Depth [3,H,W] or [H,W,3] in [0, 1] -> RGB [size, size, 3]."""
        return self.generate_batch([depth], [category_or_flag], size,
                                   num_inference_steps)[0]


def count_positions(steps: int, latents: torch.Tensor, txt: torch.Tensor,
                    patch: int) -> None:
    """The open spans' counters of a sampler loop: ``steps``, and the
    batch rows (``rows``), the latents' image positions (``img_tokens``)
    and the text positions (``txt_tokens``) of its steps, summed over the
    steps."""
    b, _, h, w = latents.shape
    count("steps", steps)
    count("rows", b * steps)
    count("img_tokens", b * (h // patch) * (w // patch) * steps)
    count("txt_tokens", b * txt.shape[1] * steps)


class FluxInpainter:
    """The FLUX inpainter (the reference's ``inpainter="flux"``,
    ``Painting_Flux.paint``): the FLUX sampler with the known region
    composited back after each step, RePaint-style."""

    def __init__(self, cfg=None, seed: int = 0):
        self.backend = DiTDepthEdit(cfg, variant="flux", seed=seed)
        self.device = self.backend.device
        self._calls = 0
        #: the last paint's first-step velocity [C, h, w] (host, fp32)
        self.first_velocity: Optional[np.ndarray] = None

    def release(self) -> None:
        self.backend.release()

    def inpaint_step(self, latents, i, cond_lat, txt, pooled, known_c,
                     noise, hole, sched):
        """One Euler step, then outside the hole the known latents
        re-noised to the next flow time, (1 - t) x0 + t noise; returns
        (those latents, the step's velocity)."""
        x, v = self.backend.sample_step(latents, i, cond_lat, txt, pooled,
                                        sched)
        t_next = sched.t_next(i)
        known_t = (1.0 - t_next) * known_c + t_next * noise
        return torch.where(hole, x, known_t), v

    @torch.inference_mode()
    def inpaint_image(self, known, mask, txt, pooled, noise, steps: int):
        """Pure sampler: known [1, 3, H, W] in [-1, 1], mask [H, W] (> 0.5
        a hole pixel), noise [1, C, H/f, W/f] the N(0, 1) draw -> ([1, 3,
        H, W] in [0, 1] with the known pixels kept, the first step's
        velocity [1, C, H/f, W/f])."""
        be = self.backend
        f = be.factor
        known_lat = be.vae.encode(known)
        cond_lat = _tile(known_lat, be.dit_cfg.cond_channels, 1)
        known_c = _tile(known_lat, be.dit_cfg.in_channels, 1)
        h, w = mask.shape
        hole = mask.reshape(h // f, f, w // f, f).amax(dim=(1, 3)) > 0.5
        hole = hole[None, None]
        sched = FlowMatchEuler(steps, device=noise.device)
        x, v0 = noise, None
        for i in range(steps):
            idx = torch.tensor([i], device=noise.device)
            x, v = graphed_call(
                be._graphs, ("inpaint", steps, be.guidance),
                lambda *a: self.inpaint_step(*a, sched),
                [x, idx, cond_lat, txt, pooled, known_c, noise, hole],
                be.device)
            x = x.clone()
            if i == 0:
                v0 = v.clone()
        img = be.decode(x)
        return torch.where(mask[None, None] > 0.5, img,
                           known / 2.0 + 0.5), v0

    def paint_draws(self, latent_hw: int) -> torch.Tensor:
        """N(0, 1) latents [1, C, h, w] of this call: a generator keyed
        by the seed and the call counter."""
        be = self.backend
        g = torch.Generator(device=self.device)
        g.manual_seed((be.seed << 32) + (1 << 31) + self._calls)
        self._calls += 1
        return torch.randn((1, be.dit_cfg.in_channels, latent_hw,
                            latent_hw), generator=g, device=self.device)

    def paint(self, image, mask, prompt: str = "complete the depth map. ",
              size: int = 256, steps: int = 30) -> np.ndarray:
        """image [C, H, W] or [H, W, C] in [0, 1]; mask [H, W] or with a
        channel axis (1: hole) -> the painted image in image's layout.
        ``size`` is the reference's argument: the image's own side is
        used."""
        be = self.backend
        x = np.asarray(image, np.float32)
        chw = x.ndim == 3 and x.shape[0] in (1, 3)
        if chw:
            x = x.transpose(1, 2, 0)
        m = np.asarray(mask, np.float32)
        if m.ndim == 3:
            m = m.max(axis=0) if m.shape[0] in (1, 3) else m.max(axis=-1)
        be.ensure_ready()
        with span("encode", sync=self.device):
            txt, pooled = be.encode_flux([prompt])
        noise = self.paint_draws(x.shape[0] // be.factor)
        with span("inpaint", sync=self.device):
            count_positions(steps, noise, txt, be.dit_cfg.patch_size)
            known = torch.from_numpy(np.ascontiguousarray(
                (x * 2 - 1).transpose(2, 0, 1))[None]).to(self.device)
            out, v0 = self.inpaint_image(known, torch.from_numpy(m).to(
                self.device), txt, pooled, noise, steps)
            out = out[0].permute(1, 2, 0).cpu().numpy()
        self.first_velocity = v0[0].cpu().numpy()
        return out.transpose(2, 0, 1) if chw else out

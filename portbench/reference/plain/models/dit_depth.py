"""FLUX.1-Depth-dev depth->image generation and the FLUX inpainter, plainly:
the reference of the port's ``genpc_tpu_torch/models/dit_depth.py``
(variant "flux") for the benchmark's ``flux_depth_int4`` cells.

``DiTDepthEdit(cfg, "flux")`` and ``FluxInpainter(cfg)`` give
``generate``/``generate_batch``, ``paint`` and ``release`` as the port's
do, on the networks of ``flux.py`` (plain torch, fp32, TF32 off, one
object at a time, no CUDA graph, no quantised layer):
  * prompts: T5-XXL (512 tokens) and CLIP-L's pooled vector, each prompt
    encoded alone; the towers are freed before the MMDiT is built, so
    the fp32 MMDiT (47.6 GB at full size) and T5 (19 GB) never share the
    card;
  * generation: the depth image resized to ``size`` (Pillow's bilinear
    filter on uint8) and encoded by the VAE as the MMDiT's depth latents;
    30 FlowMatchEuler steps from the object's N(0, 1) draw at the
    distilled guidance 10.0; the VAE decode;
  * painting: the image's VAE latents as the depth latents and as the
    known latents; after each Euler step the latents outside the hole
    (a latent cell holding any hole pixel is a hole) are the known
    latents re-noised to the next flow time, (1 − t) x0 + t noise; the
    decoded image keeps the known pixels;
  * weights and draws: the port's values, from the port's seeds (the
    weights of ``flux.build``; a generation's draw from a generator seeded
    by (seed << 32) + the object's running count, a paint's by (seed <<
    32) + 2^31 + the call's count, both on the run's device).

Each object's first Euler step's velocity is kept with the output array
it came with, and the reference's object record reads it as
``paint_v0`` (with ``depth``) and ``gen_v0`` (with ``image``), the
fields the check compares.  ``cfg.reference_precision = "fp8_e4m3"``
rounds the inputs of every linear layer and attention to fp8 e4m3 (the
control; the int4 weights stay).

Departures from the published FLUX.1-Depth-dev pipeline (diffusers
``FluxControlPipeline``), each the port's, so that both compute one
thing:
  * random weights from seed 0 (no checkpoint), the weight-only int4
    quantisation of every MMDiT block matmul (the AdaLN modulations
    included) and of T5's block matmuls, per output channel;
  * hashing tokenizers (no vocabulary files): T5's SHA-1 word ids, EOS 1,
    pad 0; CLIP's BOS vocab − 2, EOS vocab − 1, pad 0;
  * a fixed timestep shift of 3.0 (the published pipeline shifts by the
    image's token count), no key mask from the T5 padding into the MMDiT;
  * the VAE: no shift factor, the mid-block attention's q/k/v without
    bias, the stride-2 convolutions padded 1 on every side;
  * the inpainter is RePaint-style compositing with the depth model, not
    FLUX.1-Fill.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.plain.categories import get_category
from portbench.reference.plain.models import flux
from portbench.reference.plain.pipeline.artifacts import ObjectArtifacts
from portbench.reference.plain.runtime import resolve_device

FLUX_PROMPT = (
    "A raw photo of a {category}. no reflections, high quality, rich "
    "details. Shot with a macro lens (f/2.8, 50mm) and a Canon EOSR5")
#: (steps, distilled guidance) of FLUX.1-Depth-dev in the reference
STEPS, GUIDANCE = 30, 10.0
#: the random weights' seed
WEIGHT_SEED = 0


class _Kept:
    """First-step velocities by the output array each came with (held
    while the array lives)."""

    def __init__(self):
        self._by_id: Dict[int, tuple] = {}

    def keep(self, out: np.ndarray, v0: np.ndarray) -> np.ndarray:
        key = id(out)

        def drop(ref, key=key):
            if self._by_id.get(key, (None,))[0] is ref:
                del self._by_id[key]
        self._by_id[key] = (weakref.ref(out, drop), v0)
        return out

    def of(self, out) -> Optional[np.ndarray]:
        entry = self._by_id.get(id(out))
        return entry[1] if entry is not None and entry[0]() is out else None


_KEPT = _Kept()
ObjectArtifacts.paint_v0 = property(
    lambda art: _KEPT.of(art.depth),
    doc="the FLUX paint's first-step velocity [C, h, w] of this depth")
ObjectArtifacts.gen_v0 = property(
    lambda art: _KEPT.of(art.image),
    doc="the generation's first-step velocity [C, h, w] of this image")


def _hash_ids(text: str, vocab: int, n: int) -> List[int]:
    return [int(hashlib.sha1(w.encode()).hexdigest()[:8], 16) % vocab
            for w in text.lower().split()[:n]]


def t5_ids(text: str, vocab: int, max_len: int):
    """T5's hashing tokenizer: word ids, EOS 1, padded with 0."""
    ids = [i + 2 for i in _hash_ids(text, vocab - 2, max_len - 1)] + [1]
    mask = [True] * len(ids) + [False] * (max_len - len(ids))
    return ids + [0] * (max_len - len(ids)), mask


def clip_ids(text: str, vocab: int, max_len: int = 77) -> List[int]:
    """CLIP's hashing tokenizer: BOS, word ids, EOS, padded with 0."""
    ids = [vocab - 2] + _hash_ids(text, vocab - 2, max_len - 2) + [vocab - 1]
    return (ids + [0] * max_len)[:max_len]


def prep_depth(depth, size: int) -> np.ndarray:
    """Depth [3, H, W] or [H, W] in [0, 1] -> [size, size, 3], resized by
    Pillow's bilinear filter on uint8 where its side differs."""
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


def _tile(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """x repeated along dim and cut to n there."""
    reps = [1] * x.ndim
    reps[dim] = -(-n // x.shape[dim])
    return x.repeat(*reps).narrow(dim, 0, n)


class _Flux:
    """The FLUX networks of one backend: the prompt towers, then the MMDiT
    and the VAE, each phase built when first needed and freed before the
    other is built."""

    def __init__(self, cfg):
        size = cfg.get("model_size", "tiny")
        full = size == "full"
        self.device = resolve_device(cfg.get("device", "cuda"))
        self.stored = torch.bfloat16 if full else torch.float32

        def bits(key):
            v = cfg.get(key)
            return int((4 if full else 0) if v is None else v)
        self.bits, self.tower_bits = bits("quant_bits"), bits(
            "tower_quant_bits")
        self.dit_cfg = flux.DiTConfig.preset(size)
        self.vae_cfg = flux.VAEConfig.preset(size)
        self.t5_cfg = flux.T5Config.preset(size)
        self.clip_cfg = flux.CLIPConfig.preset(size)
        self.max_len = 512 if full else 32
        precision = cfg.get("reference_precision", "fp32")
        if precision not in ("fp32", "fp8_e4m3"):
            raise ValueError(f"reference_precision {precision!r}: 'fp32' "
                             f"or 'fp8_e4m3'")
        self.rnd = flux.fp8_e4m3 if precision == "fp8_e4m3" else flux.same
        self.factor = self.vae_cfg.factor
        self.dit = self.vae = None
        self._prompts: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _build(self, module, prefix: str, bits: int = 0):
        flux.build(module, self.device, WEIGHT_SEED, prefix, self.stored,
                   bits)
        flux.set_rounding(module, self.rnd)
        return module

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]):
        """Each prompt -> (T5 context [1, L, 4096], CLIP-L pooled [1,
        pooled_dim]), one prompt at a time; the towers live only here."""
        todo = [p for p in dict.fromkeys(prompts) if p not in self._prompts]
        if todo:
            self.release()
            with torch.device("meta"):
                t5 = flux.T5Encoder(self.t5_cfg, quant=bool(self.tower_bits))
                clip = flux.CLIPText(self.clip_cfg)
            self._build(t5, "t5", self.tower_bits)
            self._build(clip, "clip_l")
            for p in todo:
                ids, mask = t5_ids(p, self.t5_cfg.vocab_size, self.max_len)
                ctx = t5(torch.tensor([ids], device=self.device),
                         torch.tensor([mask], device=self.device))
                pooled = clip(torch.tensor(
                    [clip_ids(p, self.clip_cfg.vocab_size,
                              self.clip_cfg.max_len)], device=self.device))
                self._prompts[p] = (ctx, _tile(
                    pooled, self.dit_cfg.pooled_dim, -1))
            del t5, clip
            self._empty_cache()
        return [self._prompts[p] for p in prompts]

    def ready(self) -> None:
        """The MMDiT and the VAE on the device."""
        if self.dit is None:
            with torch.device("meta"):
                dit = flux.MMDiT(self.dit_cfg, quant=bool(self.bits))
                vae = flux.VAE(self.vae_cfg)
            self.dit = self._build(dit, "dit", self.bits)
            self.vae = self._build(vae, "vae")

    def velocity(self, x, t, ctx, pooled, cond):
        return self.dit(x, t, ctx, pooled, cond,
                        torch.full_like(t, GUIDANCE))

    def decode(self, lat) -> torch.Tensor:
        return torch.clamp(self.vae.decode(lat) / 2.0 + 0.5, 0.0, 1.0)

    def release(self) -> None:
        self.dit = self.vae = None
        self._empty_cache()

    def _empty_cache(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class DiTDepthEdit:
    """depth image -> RGB image by FLUX.1-Depth-dev (variant "flux")."""

    def __init__(self, cfg=None, variant: str = "flux", seed: int = 0):
        if variant != "flux":
            raise NotImplementedError(
                f"the plain reference holds FLUX.1-Depth-dev only, not "
                f"{variant!r}")
        self.net = _Flux(cfg or {})
        self.device = self.net.device
        self.seed = seed
        self._noise_ctr = 0

    def release(self) -> None:
        self.net.release()

    @torch.no_grad()
    def generate_batch(self, depths, flags: Sequence[str], size: int = 512,
                       num_inference_steps: Optional[int] = None
                       ) -> List[np.ndarray]:
        """Each depth -> RGB [size, size, 3] in [0, 1], one object at a
        time (a list of arrays, each keeping its first-step velocity)."""
        net = self.net
        cond = net.encode([FLUX_PROMPT.format(category=get_category(f))
                           for f in flags])
        net.ready()
        steps = num_inference_steps or STEPS
        timesteps, sigmas = flux.flow_tables(steps, self.device)
        hw = size // net.factor
        out = []
        for depth, (ctx, pooled) in zip(depths, cond):
            g = torch.Generator(device=self.device)
            g.manual_seed((self.seed << 32) + self._noise_ctr)
            self._noise_ctr += 1
            x = torch.randn((net.dit_cfg.in_channels, hw, hw), generator=g,
                            device=self.device)[None]
            img01 = torch.from_numpy(np.ascontiguousarray(
                prep_depth(depth, size).transpose(2, 0, 1))[None]).to(
                self.device)
            lat = _tile(net.vae.encode(img01 * 2 - 1),
                        net.dit_cfg.cond_channels, 1)
            v0 = None
            for i in range(steps):
                v = net.velocity(x, timesteps[i:i + 1], ctx, pooled, lat)
                v0 = v if i == 0 else v0
                x = x + v * (sigmas[i + 1] - sigmas[i])
            img = net.decode(x)[0].permute(1, 2, 0).cpu().numpy()
            out.append(_KEPT.keep(img, v0[0].cpu().numpy()))
        return out

    def generate(self, depth, category_or_flag: str, size: int = 512,
                 num_inference_steps: Optional[int] = None) -> np.ndarray:
        return self.generate_batch([depth], [category_or_flag], size,
                                   num_inference_steps)[0]


class FluxInpainter:
    """The FLUX inpainter (``inpainter="flux"``): the FLUX sampler with
    the known region composited back after each step."""

    def __init__(self, cfg=None, seed: int = 0):
        self.net = _Flux(cfg or {})
        self.device = self.net.device
        self.seed = seed
        self._calls = 0

    def release(self) -> None:
        self.net.release()

    @torch.no_grad()
    def paint(self, image, mask, prompt: str = "complete the depth map. ",
              size: int = 256, steps: int = STEPS) -> np.ndarray:
        """image [C, H, W] or [H, W, C] in [0, 1]; mask [H, W] or with a
        channel axis (1: hole) -> the painted image in image's layout
        (``size`` is unused: the image's own side is)."""
        net = self.net
        x = np.asarray(image, np.float32)
        chw = x.ndim == 3 and x.shape[0] in (1, 3)
        if chw:
            x = x.transpose(1, 2, 0)
        m = np.asarray(mask, np.float32)
        if m.ndim == 3:
            m = m.max(axis=0) if m.shape[0] in (1, 3) else m.max(axis=-1)
        (ctx, pooled), = net.encode([prompt])
        net.ready()
        f, h, w = net.factor, m.shape[0], m.shape[1]
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) + (1 << 31) + self._calls)
        self._calls += 1
        noise = torch.randn((1, net.dit_cfg.in_channels, h // f, w // f),
                            generator=g, device=self.device)
        known = torch.from_numpy(np.ascontiguousarray(
            (x * 2 - 1).transpose(2, 0, 1))[None]).to(self.device)
        mask_t = torch.from_numpy(m).to(self.device)
        known_lat = net.vae.encode(known)
        cond = _tile(known_lat, net.dit_cfg.cond_channels, 1)
        known_c = _tile(known_lat, net.dit_cfg.in_channels, 1)
        hole = (mask_t.reshape(h // f, f, w // f, f).amax(dim=(1, 3))
                > 0.5)[None, None]
        timesteps, sigmas = flux.flow_tables(steps, self.device)
        lat, v0 = noise, None
        for i in range(steps):
            v = net.velocity(lat, timesteps[i:i + 1], ctx, pooled, cond)
            v0 = v if i == 0 else v0
            stepped = lat + v * (sigmas[i + 1] - sigmas[i])
            t_next = sigmas[i + 1]
            lat = torch.where(hole, stepped,
                              (1.0 - t_next) * known_c + t_next * noise)
        img = torch.where(mask_t[None, None] > 0.5, net.decode(lat),
                          known / 2.0 + 0.5)[0].permute(1, 2, 0).cpu().numpy()
        out = img.transpose(2, 0, 1) if chw else img
        return _KEPT.keep(out, v0[0].cpu().numpy())

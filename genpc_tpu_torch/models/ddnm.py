"""DDNM null-space diffusion inpainting, the reference's ``inpainter:
DDNM`` (counterpart of genpc_tpu/models/ddnm.py).

``DDNMInpainter(cfg, steps=50, seed=0)`` runs a pixel-space
``unet.UNet2DCondition`` with three input and output channels (the
``base`` preset's widths at full size, in bf16; the ``tiny`` preset's
otherwise, in fp32), unconditional (a zero context), on ``cfg.device``
(the card by default), with deterministic DDIM steps.  Each step
projects the model's x0 estimate onto the data-consistency set (known
pixels from the measurement, the hole from the model) and takes the DDIM
step with the noise that estimate implies; the known pixels are pasted
back at the end, so they come out exact.  ``inpaint_image`` is pure: it
takes its N(0, 1) draw.  Each call draws from a generator seeded by the
inpainter's seed and a running count of calls.  On the card each step is
one CUDA graph replay.

The weights are seeded random, or a checkpoint of the reference's
layout from ``<cfg.weights_dir>/ddnm`` (``weights.load_ddnm``, loaded
non-strictly as the reference does); at random weights the holes fill
with prior noise while the known pixels stay exact.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import BF16, F32
from genpc_tpu_torch.models.schedulers import DDIM, at
from genpc_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import count, span

#: the random weights' seed (the reference initialises from PRNGKey(0))
WEIGHT_SEED = 0


def ddnm_unet_config(full: bool) -> UNetConfig:
    """The pixel-space UNet: the base (full) or tiny preset's widths, 3
    channels in and out, no micro-conditioning."""
    p = UNetConfig.preset("base" if full else "tiny")
    return UNetConfig(in_channels=3, out_channels=3,
                      block_out_channels=p.block_out_channels,
                      layers_per_block=p.layers_per_block,
                      transformer_depths=p.transformer_depths,
                      context_dim=p.context_dim,
                      attention_head_dim=p.attention_head_dim)


class DDNMInpainter:
    def __init__(self, cfg=None, steps: int = 50, seed: int = 0):
        self.cfg = cfg or {}
        full = self.cfg.get("model_size", "tiny") == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if full else F32
        self.unet_cfg = ddnm_unet_config(full)
        with torch.device("meta"):
            self.unet = UNet2DCondition(self.unet_cfg)
        self.steps, self.seed = steps, seed
        self._ready = False
        self._calls = 0
        self._graphs: Dict[tuple, GraphedCall] = {}

    def models(self) -> Dict[str, nn.Module]:
        """The inpainter's model by kind (``weights.from_flax``'s name)."""
        return {"ddnm": self.unet}

    def init_params(self, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
        """Materialise the UNet on the device: from ``state`` when given,
        else seeded random weights, then ``cfg.weights_dir``'s checkpoint
        where there is one."""
        from genpc_tpu_torch.models.weights import load_ddnm, materialize
        self._graphs.clear()
        materialize(self.unet, self.device, self.dtype,
                    seed=None if state is not None else WEIGHT_SEED,
                    prefix="ddnm")
        if state is not None:
            self.unet.load_state_dict(state, strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_ddnm(weights_dir, self.unet)
        self._ready = True

    def release(self) -> None:
        """Free the parameters (back to the meta device), the step graphs
        and the allocator's cache; the next call materialises them anew."""
        with span("release", sync=self.device):
            self._graphs.clear()
            self.unet.to_empty(device="meta")
            self._ready = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def step(self, x, i, known, mask, ctx, sched: DDIM):
        """One DDNM step at the step index i ([1] tensor): the model's x0
        estimate, the known pixels pasted into it, the DDIM step with the
        noise it implies."""
        t = at(sched.timesteps, i)
        a_t = at(sched.a_t, i)
        eps = self.unet(x, t.to(F32), ctx)
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        x0 = mask * known + (1.0 - mask) * x0
        eps_hat = (x - torch.sqrt(a_t) * x0) / torch.sqrt(
            torch.clamp_min(1 - a_t, 1e-12))
        return sched.step(eps_hat, i, x)

    @torch.inference_mode()
    def inpaint_image(self, known, mask, noise) -> torch.Tensor:
        """Pure sampler: known [1, 3, H, W] in [-1, 1], mask [1, 1, H, W]
        (1: a known pixel), noise the N(0, 1) draw of known's shape ->
        [1, 3, H, W] in [-1, 1] with the known pixels kept."""
        sched = DDIM(self.steps, device=noise.device)
        ctx = torch.zeros((1, 1, self.unet_cfg.context_dim),
                          device=noise.device)
        x = noise
        for i in range(self.steps):
            idx = torch.tensor([i], device=noise.device)
            x = graphed_call(self._graphs, ("ddnm", self.steps),
                             lambda *a: self.step(*a, sched),
                             [x, idx, known, mask, ctx],
                             self.device).clone()
        return mask * known + (1.0 - mask) * x

    def paint_draws(self, shape) -> torch.Tensor:
        """The N(0, 1) start of this call: a generator keyed by the seed
        and the call counter."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed << 32) + self._calls)
        self._calls += 1
        return torch.randn(shape, generator=g, device=self.device)

    def inpaint(self, img: np.ndarray, hole_mask: np.ndarray) -> np.ndarray:
        """img [C, H, W] (or [H, W, C]) in [0, 1]; hole_mask [H, W] or with
        a channel axis (> 0.5: a hole) -> the painted image in img's
        layout."""
        x = np.asarray(img, np.float32)
        chw = x.ndim == 3 and x.shape[0] in (1, 3)
        if chw:
            x = x.transpose(1, 2, 0)
        m = np.asarray(hole_mask, np.float32)
        if m.ndim == 3:
            m = m.max(axis=0) if m.shape[0] in (1, 3) else m.max(axis=-1)
        if not self._ready:
            with span("init", sync=self.device):
                self.init_params()
        known = torch.from_numpy(np.ascontiguousarray(
            (x * 2 - 1).transpose(2, 0, 1))[None]).to(self.device)
        mask = torch.from_numpy((1.0 - (m > 0.5)).astype(np.float32))[
            None, None].to(self.device)
        noise = self.paint_draws(tuple(known.shape))
        with span("inpaint", sync=self.device):
            count("steps", self.steps)
            out = self.inpaint_image(known, mask, noise)
            out = torch.clamp(out[0] / 2 + 0.5, 0, 1).permute(1, 2, 0)
            out = out.cpu().numpy()
        return out.transpose(2, 0, 1) if chw else out

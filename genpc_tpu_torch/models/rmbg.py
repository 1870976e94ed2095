"""Background removal with RMBG-2.0 (BiRefNet) (counterpart of
genpc_tpu/models/rmbg.py).

``RMBGMatting(cfg, seed=0)`` builds ``birefnet.BiRefNet`` on
``cfg.device`` (the card by default) at ``cfg.model_size`` ("full":
Swin-v1-Large at 1024², bf16 weights; otherwise the tiny test preset in
fp32).  The weights are seeded random, or RMBG-2.0's from
``<cfg.weights_dir>/rmbg`` (``weights.load_matting``, strict).

A call keeps the reference's host steps (RMBG.py:46-52): the image is
resized to img_size² with Pillow's bilinear filter through uint8,
normalised as x - 0.5 (mean 0.5, std 1.0, not the ImageNet statistics),
matted on the device, and the matte is resized back to the input size
through uint8 and attached as the alpha channel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from genpc_tpu_torch.models.birefnet import BiRefNet, BiRefNetConfig
from genpc_tpu_torch.models.layers import BF16, F32
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import span

#: the random weights' seed (the reference initialises from its seed, 0)
WEIGHT_SEED = 0


class RMBGMatting:
    """callable(image [H, W, 3 or 4] in [0, 1]) -> RGBA [H, W, 4]."""

    def __init__(self, cfg=None, seed: int = 0):
        self.cfg = cfg or {}
        full = self.cfg.get("model_size", "tiny") == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if full else F32
        self.net_cfg = BiRefNetConfig.preset("full" if full else "tiny")
        self.seed = seed
        with torch.device("meta"):
            self.net = BiRefNet(self.net_cfg)
        self._ready = False

    def models(self) -> Dict[str, torch.nn.Module]:
        """The backend's model by kind (``weights.from_flax``'s name)."""
        return {"birefnet": self.net}

    def init_params(self, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
        """Materialise the network on the device: from ``state`` when
        given, else seeded random weights, then RMBG-2.0's checkpoint of
        ``cfg.weights_dir`` where it exists."""
        from genpc_tpu_torch.models.weights import load_matting, materialize
        seed = None if state is not None else WEIGHT_SEED + self.seed
        materialize(self.net, self.device, self.dtype, seed=seed,
                    prefix="birefnet")
        if state is not None:
            self.net.load_state_dict(state, strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_matting(weights_dir, self.net)
        self._ready = True

    def release(self) -> None:
        """Free the parameters (back to the meta device) and the
        allocator's cache; the next call materialises them anew."""
        with span("release", sync=self.device):
            self.net.to_empty(device="meta")
            self._ready = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    @torch.inference_mode()
    def matte(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, s, s] normalised (x - 0.5) -> matte [B, 1, s, s]."""
        return self.net(x)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        from PIL import Image
        if not self._ready:
            with span("init", sync=self.device):
                self.init_params()
        img = np.asarray(image, np.float32)
        if img.shape[-1] == 4:
            img = img[..., :3]
        h, w = img.shape[:2]
        s = self.net_cfg.img_size
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        resized = np.asarray(Image.fromarray(u8).resize(
            (s, s), Image.BILINEAR), np.float32) / 255.0
        x = torch.from_numpy(np.ascontiguousarray(
            (resized - 0.5).transpose(2, 0, 1))[None]).to(self.device)
        with span("matte", sync=self.device):
            matte = self.matte(x)[0, 0].cpu().numpy()
        m8 = (np.clip(matte, 0, 1) * 255).astype(np.uint8)
        matte = np.asarray(Image.fromarray(m8).resize(
            (w, h), Image.BILINEAR), np.float32) / 255.0
        return np.concatenate([img, matte[..., None]], axis=-1)

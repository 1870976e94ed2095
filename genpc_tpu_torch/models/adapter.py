"""T2I-Adapter conditioning (counterpart of genpc_tpu/models/adapter.py).

The adapter variant conditions the UNet by adding a pyramid of depth
features to the down path's activations, one tensor per resolution
level, in place of ControlNet's residual taps.

The reference has no checkpoint name map for its adapter, so the
parameters here are named after the reference's own module paths
(``conv_in``, ``down_1``, ``res_0a.conv1``...): ``weights.from_flax``
carries a reference tree across with transposes alone.  There is no
loader for a real TencentARC adapter checkpoint (ROADMAP, "Not to
port": the reference has no name map for one).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.models.layers import F32, Conv2d


class AdapterResBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int):
        super().__init__()
        self.conv1 = Conv2d(in_ch, channels)
        self.conv2 = Conv2d(channels, channels)
        self.skip = Conv2d(in_ch, channels, k=1) if in_ch != channels \
            else None

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class T2IAdapter(nn.Module):
    """Depth image [B,3,H,W] -> one additive fp32 feature map per UNet
    level; the first at the latent resolution (pixel-unshuffle by the VAE
    factor, then a conv)."""

    def __init__(self, channels: Sequence[int], downscale: int = 8):
        super().__init__()
        self.downscale = downscale
        self.n_levels = len(channels)
        self.conv_in = Conv2d(3 * downscale * downscale, channels[0])
        prev = channels[0]
        for i, ch in enumerate(channels):
            if i > 0:
                self.add_module(f"down_{i}", Conv2d(prev, ch, stride=2))
            self.add_module(f"res_{i}a", AdapterResBlock(ch, ch))
            self.add_module(f"res_{i}b", AdapterResBlock(ch, ch))
            prev = ch

    def forward(self, cond_image) -> List[torch.Tensor]:
        b, c, h, w = cond_image.shape
        f = self.downscale
        # pixel-unshuffle with the reference's NHWC channel order
        # (row offset, column offset, colour), not F.pixel_unshuffle's
        x = cond_image.reshape(b, c, h // f, f, w // f, f)
        x = x.permute(0, 3, 5, 1, 2, 4).reshape(b, f * f * c, h // f, w // f)
        x = self.conv_in(x)
        feats = []
        for i in range(self.n_levels):
            if i > 0:
                x = getattr(self, f"down_{i}")(x)
            x = getattr(self, f"res_{i}b")(getattr(self, f"res_{i}a")(x))
            feats.append(x.to(F32))
        return feats

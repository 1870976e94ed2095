"""Backend registry for the three generative stages (counterpart of
genpc_tpu/models/backends.py).

Every backend of the reference is ported, each built on ``cfg.device``:
the model-free synthetic backends; the depth->image generators (the SDXL
ControlNet 'controlnet' or T2I-Adapter 'adapter', Qwen-Image-Edit 'qwen'
and FLUX.1-Depth-dev 'flux'); RMBG-2.0 background removal ('RMBG' or
'rmbg'); and the image-to-3D backends ('instantmesh', 'trellis',
'trellis_2', 'sf3d').  An unknown name raises ValueError.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from portbench.reference.plain.models.synthetic import (
    SyntheticDepth2Image, SyntheticImage23D, SyntheticRembg)


def prep_rgb(image: np.ndarray, size: int) -> np.ndarray:
    """RGBA/RGB [H, W, *] in [0, 1] -> alpha-matted RGB [size, size, 3]:
    the matte every image-to-3D backend applies before encoding, resized
    with Pillow's bilinear filter."""
    from PIL import Image
    img = np.asarray(image, np.float32)
    if img.shape[-1] == 4:
        img = img[..., :3] * img[..., 3:4]
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return np.asarray(Image.fromarray(u8).resize((size, size),
                                                 Image.BILINEAR),
                      np.float32) / 255.0


def get_depth2image(name: str, cfg: Any = None):
    """Depth-conditioned image generator: .generate(depth, category, size)."""
    if name == "synthetic":
        return SyntheticDepth2Image(cfg)
    if name in ("controlnet", "adapter"):
        from portbench.reference.plain.models.controlnet_depth import ControlNetDepth
        return ControlNetDepth(cfg, adapter=name == "adapter")
    if name in ("qwen", "flux"):
        from portbench.reference.plain.models.dit_depth import DiTDepthEdit
        return DiTDepthEdit(cfg, variant=name)
    raise ValueError(
        f"unknown control_model {name!r}; use 'synthetic', 'controlnet', "
        f"'adapter', 'flux' or 'qwen'")


def get_rembg(name: str, cfg: Any = None):
    """Background removal: callable(image [H,W,3]) -> RGBA [H,W,4]."""
    if name in ("synthetic", "rembg"):
        return SyntheticRembg(cfg)
    if name in ("RMBG", "rmbg"):
        from portbench.reference.plain.models.rmbg import RMBGMatting
        return RMBGMatting(cfg)
    raise ValueError(f"unknown rembg_model {name!r}")


def get_image23d(name: str, cfg: Any = None):
    """Image-to-3D: callable(flag, image_nobg, partial_xyz=..., ...) ->
    (points, colours) or a Mesh."""
    if name == "synthetic":
        return SyntheticImage23D(cfg)
    if name == "instantmesh":
        from portbench.reference.plain.models.lrm import InstantMeshBackend
        return InstantMeshBackend(cfg)
    if name in ("trellis", "trellis_2"):
        from portbench.reference.plain.models.trellis import TrellisBackend
        return TrellisBackend(cfg, variant=name)
    if name == "sf3d":
        from portbench.reference.plain.models.sf3d import SF3DBackend
        return SF3DBackend(cfg)
    raise ValueError(f"unknown generative_model {name!r}")

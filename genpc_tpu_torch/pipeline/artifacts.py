"""Typed in-memory stage artifacts + optional workspace persistence
(counterpart of genpc_tpu/pipeline/artifacts.py).

Stages exchange one ``ObjectArtifacts`` record of host (numpy) arrays.
``Workspace`` persists the reference's file set per object
(``raw_depth.png``, ``depth.png``, ``mask.png``, ``img.png``,
``point_uv.npy``, ``viewpoint.npy``, ``img_sam.png``,
``color_point.ply``, ``<flag>_<model>.ply``, ``<flag>_fused.ply``) under
the same names, so a workspace written by either package loads in the
other, and can reload a record to resume a stage; a mesh completion is
``<flag>_<model>.glb`` (io/glb).  PNGs need Pillow, imported only when
one is read or written.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from genpc_tpu_torch.io.glb import Mesh, load_glb, save_glb
from genpc_tpu_torch.io.ply import load_ply, save_ply


@dataclass
class ObjectArtifacts:
    flag: str
    xyz: Optional[np.ndarray] = None            # [N,3] partial input
    rgb: Optional[np.ndarray] = None            # [N,3]
    # Stage 1 (depth prompting)
    point_uv: Optional[np.ndarray] = None       # [N,2] in [0,1]
    viewpoint: Optional[np.ndarray] = None      # [3] selected eye
    raw_depth: Optional[np.ndarray] = None      # [3,res,res]
    depth: Optional[np.ndarray] = None          # [3,res,res] inpainted
    mask: Optional[np.ndarray] = None           # [3,res,res]
    image: Optional[np.ndarray] = None          # [H,W,3] generated RGB
    # first Euler-step velocities of a diffusion paint and generation
    paint_v0: Optional[np.ndarray] = None       # [C,h,w] (FLUX inpainter)
    gen_v0: Optional[np.ndarray] = None         # [C,h,w] (a DiT backend)
    # Stage 2 (scale adapter)
    image_nobg: Optional[np.ndarray] = None     # [H,W,4] RGBA
    color_xyz: Optional[np.ndarray] = None      # colored partial cloud
    color_rgb: Optional[np.ndarray] = None
    complete_mesh: Optional[Mesh] = None        # image-to-3D output
    complete_xyz: Optional[np.ndarray] = None   # or a raw complete cloud
    complete_rgb: Optional[np.ndarray] = None
    complete_aligned: bool = False   # backend declared input-frame output
    # Stage 3 (registration & fusion)
    fused_xyz: Optional[np.ndarray] = None
    fused_rgb: Optional[np.ndarray] = None


def input_artifacts(flag: str, xyz: np.ndarray, rgb: np.ndarray,
                    n_in: int) -> ObjectArtifacts:
    """An object's input record: the scan drawn to n_in points, with
    replacement when it is shorter, by the reference's fixed draw (seed
    0), so that every stage sees one size."""
    rng = np.random.default_rng(0)
    idx = rng.choice(len(xyz), n_in, replace=len(xyz) < n_in)
    return ObjectArtifacts(flag=flag, xyz=xyz[idx], rgb=rgb[idx])


def _save_png(path: str, img: np.ndarray) -> None:
    """img: [C,H,W] or [H,W,C] float in [0,1] (or uint8)."""
    from PIL import Image
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[0] in (1, 3, 4) and a.shape[0] < a.shape[-1]:
        a = a.transpose(1, 2, 0)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    Image.fromarray(a).save(path)


def _load_png(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.float32) / 255.0


class Workspace:
    """Filesystem mirror of the reference's workspace/{flag}/ layout."""

    def __init__(self, root: str, generative_model: str = "synthetic"):
        self.root = root
        self.generative_model = generative_model

    def dir(self, flag: str) -> str:
        d = os.path.join(self.root, flag)
        os.makedirs(d, exist_ok=True)
        return d

    # --- stage 1 -----------------------------------------------------
    def save_stage1(self, art: ObjectArtifacts) -> None:
        d = self.dir(art.flag)
        if art.raw_depth is not None:
            _save_png(os.path.join(d, "raw_depth.png"), art.raw_depth)
        if art.depth is not None:
            _save_png(os.path.join(d, "depth.png"), art.depth)
        if art.mask is not None:
            _save_png(os.path.join(d, "mask.png"), art.mask)
        if art.image is not None:
            _save_png(os.path.join(d, "img.png"), art.image)
        if art.point_uv is not None:
            np.save(os.path.join(d, "point_uv.npy"), art.point_uv)
        if art.viewpoint is not None:
            np.save(os.path.join(d, "viewpoint.npy"), art.viewpoint)

    def load_stage1(self, flag: str, art: Optional[ObjectArtifacts] = None
                    ) -> ObjectArtifacts:
        d = self.dir(flag)
        art = art or ObjectArtifacts(flag)
        art.point_uv = np.load(os.path.join(d, "point_uv.npy"))
        art.viewpoint = np.load(os.path.join(d, "viewpoint.npy"))
        p = os.path.join(d, "depth.png")
        if os.path.exists(p):
            art.depth = _load_png(p).transpose(2, 0, 1)
        p = os.path.join(d, "img.png")
        if os.path.exists(p):
            art.image = _load_png(p)
        return art

    # --- stage 2 -----------------------------------------------------
    def save_stage2(self, art: ObjectArtifacts) -> None:
        d = self.dir(art.flag)
        if art.image_nobg is not None:
            _save_png(os.path.join(d, "img_sam.png"), art.image_nobg)
        if art.color_xyz is not None:
            save_ply(os.path.join(d, "color_point.ply"),
                     art.color_xyz, art.color_rgb)
        if art.complete_mesh is not None:
            save_glb(os.path.join(
                d, f"{art.flag}_{self.generative_model}.glb"),
                art.complete_mesh)
        elif art.complete_xyz is not None:
            save_ply(os.path.join(
                d, f"{art.flag}_{self.generative_model}.ply"),
                art.complete_xyz, art.complete_rgb)

    def load_stage2(self, flag: str, art: Optional[ObjectArtifacts] = None
                    ) -> ObjectArtifacts:
        d = self.dir(flag)
        art = art or ObjectArtifacts(flag)
        p = os.path.join(d, "color_point.ply")
        if os.path.exists(p):
            art.color_xyz, art.color_rgb = load_ply(p)
        p = os.path.join(d, f"{flag}_{self.generative_model}.glb")
        if os.path.exists(p):
            art.complete_mesh = load_glb(p)
        p = os.path.join(d, f"{flag}_{self.generative_model}.ply")
        if os.path.exists(p):
            art.complete_xyz, art.complete_rgb = load_ply(p)
        return art

    # --- stage 3 -----------------------------------------------------
    def save_fused(self, art: ObjectArtifacts) -> None:
        d = self.dir(art.flag)
        save_ply(os.path.join(d, f"{art.flag}_fused.ply"),
                 art.fused_xyz, art.fused_rgb)

    def fused_path(self, flag: str) -> str:
        return os.path.join(self.dir(flag), f"{flag}_fused.ply")

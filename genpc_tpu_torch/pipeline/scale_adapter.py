"""Stage 2 — Scale Adapter: background removal, point colouring,
image-to-3D (counterpart of genpc_tpu/pipeline/scale_adapter.py;
reference: ScaleAdapter.py:15-97).

``scale_adapter`` runs one object (``main.run_pipeline``,
``main_lidar.run_lidar``); ``scale_adapter_batch`` runs a batch: with
the synthetic backend its symmetry planning for all objects in two
nearest-neighbour launches, with a mesh-producing backend that has
``generate_meshes_batch`` (InstantMesh) its multiview denoise, decode
and density grids over chunks of ``cfg.image23d_batch`` objects (0: the
whole batch).  ``color_point`` samples the generated image at its true
resolution with one vectorised gather.
"""

from __future__ import annotations

import numpy as np

from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.models.backends import get_image23d, get_rembg
from genpc_tpu_torch.models.synthetic import SyntheticImage23D
from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts, Workspace
from genpc_tpu_torch.tracing import span


class ScaleAdapter:
    def __init__(self, cfg, rembg=None, image23d=None):
        self.cfg = cfg
        # backends the caller passes in stay the caller's to free
        self.owns_rembg = rembg is None
        self.owns_image23d = image23d is None
        self.rembg = rembg or get_rembg(cfg.rembg_model, cfg)
        self.image23d = image23d or get_image23d(cfg.generative_model, cfg)
        self.workspace = Workspace(cfg.output_path, cfg.generative_model)

    def remove_bg(self, art: ObjectArtifacts) -> ObjectArtifacts:
        art.image_nobg = np.asarray(self.rembg(art.image))
        return art

    def color_point(self, art: ObjectArtifacts) -> ObjectArtifacts:
        """Colour the partial cloud from the generated image at its UVs
        (reference: ScaleAdapter.py:46-68)."""
        img = np.asarray(art.image, np.float32)
        res = img.shape[0]
        # undo the paint-time vertical flip before sampling
        img = img[::-1, :, :]
        pix = (np.asarray(art.point_uv) * res).astype(np.int64)
        rows = np.clip(pix[:, 1], 0, res - 1)
        cols = np.clip(pix[:, 0], 0, res - 1)
        art.color_xyz = np.asarray(art.xyz, np.float32)
        art.color_rgb = img[rows, cols, :3].astype(np.float32)
        return art

    def img2shape(self, art: ObjectArtifacts) -> ObjectArtifacts:
        out = self.image23d(art.flag, art.image_nobg,
                            partial_xyz=art.color_xyz,
                            partial_rgb=art.color_rgb,
                            viewpoint=art.viewpoint)
        if isinstance(out, Mesh):
            art.complete_mesh = out
        else:
            art.complete_xyz, art.complete_rgb = out
        art.complete_aligned = bool(getattr(self.image23d,
                                            "output_aligned", False))
        return art

    def scale_adapter(self, art: ObjectArtifacts) -> ObjectArtifacts:
        """Full Stage 2 for one object (reference: ScaleAdapter.py:78-86)."""
        self.remove_bg(art)
        self.color_point(art)
        self.img2shape(art)
        if self.cfg.save:
            self.workspace.save_stage2(art)
        return art

    def scale_adapter_batch(self, arts) -> None:
        """Stage 2 for a batch: per-object matting/colouring (host), then
        batched symmetry planning (synthetic), batched mesh generation
        (``generate_meshes_batch``) or the per-object loop.  Spans
        (``tracing``): ``stage2_matte``, ``stage2_plan`` (synthetic),
        ``stage2_complete``."""
        with span("stage2_matte"):
            for art in arts:
                self.remove_bg(art)
                self.color_point(art)
        if isinstance(self.image23d, SyntheticImage23D):
            dev = self.image23d.device
            with span("stage2_plan", sync=dev):
                plans = SyntheticImage23D.plan_symmetry_batched(
                    [a.color_xyz for a in arts], device=dev)
            with span("stage2_complete", sync=dev):
                for art, plan in zip(arts, plans):
                    art.complete_xyz, art.complete_rgb = \
                        self.image23d.complete_with_plan(
                            art.flag, art.color_xyz, art.color_rgb,
                            art.viewpoint, plan)
                    art.complete_aligned = True
        elif hasattr(self.image23d, "generate_meshes_batch"):
            nb = int(self.cfg.get("image23d_batch", 0)) or len(arts)
            aligned = bool(getattr(self.image23d, "output_aligned", False))
            with span("stage2_complete"):
                for i in range(0, len(arts), nb):
                    chunk = arts[i:i + nb]
                    meshes = self.image23d.generate_meshes_batch(
                        [a.flag for a in chunk],
                        [a.image_nobg for a in chunk])
                    for art, m in zip(chunk, meshes):
                        art.complete_mesh = m
                        art.complete_aligned = aligned
        else:
            with span("stage2_complete"):
                for art in arts:
                    self.img2shape(art)
        if self.cfg.save:
            for art in arts:
                self.workspace.save_stage2(art)

    def scale_reg(self, art: ObjectArtifacts) -> ObjectArtifacts:
        """Stage 3 hand-off (reference: ScaleAdapter.py:74-75)."""
        from genpc_tpu_torch.pipeline.registration import reg
        return reg(self.cfg, art, cd_inv_weight=0.5, diff_init=True,
                   reg_fine_xyz=True)

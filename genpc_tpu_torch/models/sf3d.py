"""SF3D-class image-to-3D: one feed-forward triplane pass (counterpart
of genpc_tpu/models/sf3d.py).

``SF3DBackend(cfg, seed=0)`` builds ``SF3DNet`` on ``cfg.device`` (the
card by default) at ``cfg.model_size`` ("full": the InstantMesh LRM
widths, bf16 weights; otherwise the tiny test preset in fp32) from the
LRM layers of models/lrm.py: the DINO ViT over the input image, whose
per-layer adaLN input is a learned global embedding (SF3D has no
camera), the triplane transformer with its 2x deconvolution, the OSG
decoder heads over the concatenated triplane features, and SF3D's
material head (roughness, metallic).  No sampling: the SDF on the 96³
grid is cut at its median by marching tetrahedra (on the grid's device)
and the colour head is queried at the vertices.

No public Stable-Fast-3D checkpoint fits this architecture;
``weights.load_sf3d`` restores only checkpoints saved from it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.models.layers import BF16, F32, Linear, box
from genpc_tpu_torch.models.lrm import (
    DinoViT, LRMConfig, SynthesizerDecoder, TriplaneTransformer,
    grid_points, mesh_from_sdf, sample_triplane_concat)
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import span

#: the random weights' seed (the reference initialises from PRNGKey(0))
WEIGHT_SEED = 0


class SF3DNet(nn.Module):
    """Single-view triplane network: images [B, 3, H, W] in [-1, 1] ->
    triplanes, and the heads at points."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = box(model=DinoViT(cfg))
        self.transformer = TriplaneTransformer(cfg)
        self.synthesizer = SynthesizerDecoder(cfg)
        # the learned global conditioning in the camera embedding's slot
        self.global_embed = nn.Parameter(torch.empty(1, cfg.vit_dim))
        self.material_head = Linear(3 * cfg.triplane_dim, 2, compute=F32)

    def forward_planes(self, images):
        """images [B, 3, H, W] -> triplanes [B, 3, R, R, C]."""
        b = images.shape[0]
        tokens, _ = self.encoder.model(images,
                                       self.global_embed.expand(b, -1))
        return self.transformer(tokens)

    def query(self, planes, pts):
        """planes [3, R, R, C], pts [N, 3] in [-1, 1] -> (sdf [N], rgb [N,
        3], material [N, 2])."""
        feats = sample_triplane_concat(planes, pts)
        sdf, rgb, _, _ = self.synthesizer(feats)
        return sdf, rgb, torch.sigmoid(self.material_head(feats))

    def sdf_at(self, planes, pts):
        """The SDF head alone (``query``'s first output)."""
        return self.synthesizer.head(
            "net_sdf", sample_triplane_concat(planes, pts))[..., 0]

    def rgb_at(self, planes, pts):
        """The colour head alone (``query``'s second output)."""
        return torch.sigmoid(self.synthesizer.head(
            "net_rgb", sample_triplane_concat(planes, pts)))


class SF3DBackend:
    """image23d backend: a no-background image -> a coloured Mesh, one
    pass."""

    def __init__(self, cfg=None, seed: int = 0):
        self.cfg = cfg or {}
        full = self.cfg.get("model_size", "tiny") == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if full else F32
        self.net_cfg = LRMConfig.preset("full" if full else "tiny")
        with torch.device("meta"):
            self.net = SF3DNet(self.net_cfg)
        self._ready = False

    def models(self) -> Dict[str, nn.Module]:
        """The backend's model by kind (``weights.from_flax``'s name)."""
        return {"sf3d": self.net}

    def init_params(self, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
        """Materialise the network on the device: from ``state`` when
        given, else seeded random weights, then a checkpoint saved from
        this architecture in ``cfg.weights_dir`` where there is one."""
        from genpc_tpu_torch.models.weights import load_sf3d, materialize
        materialize(self.net, self.device, self.dtype,
                    seed=None if state is not None else WEIGHT_SEED,
                    prefix="sf3d")
        if state is not None:
            self.net.load_state_dict(state, strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_sf3d(weights_dir, self.net)
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
    def density_grid(self, images):
        """images [B, 3, s, s] in [-1, 1] -> (triplanes [B, 3, R, R, C],
        SDF grids [B, Rg, Rg, Rg])."""
        planes = self.net.forward_planes(images)
        r = self.net_cfg.grid_res
        pts = grid_points(r, self.device)
        sdf = torch.stack([self.net.sdf_at(p, pts).reshape(r, r, r)
                           for p in planes])
        return planes, sdf

    @torch.inference_mode()
    def vertex_colors(self, planes, verts: np.ndarray) -> np.ndarray:
        """The colour head at the vertices, clipped to [0, 1]."""
        pts = torch.from_numpy(verts).to(self.device)
        return np.clip(self.net.rgb_at(planes, pts).cpu().numpy(), 0,
                       1).astype(np.float32)

    def generate_meshes_batch(self, flags, images) -> List[Mesh]:
        """B no-background images -> B coloured meshes: the triplanes and
        the SDF grids run once over the [B, ...] batch."""
        from genpc_tpu_torch.models.backends import prep_rgb
        if not self._ready:
            with span("init", sync=self.device):
                self.init_params()
        imgs = np.stack([prep_rgb(im, self.net_cfg.img_size)
                         for im in images])
        with span("grid", sync=self.device):
            x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy())
            planes, sdf = self.density_grid(x.to(self.device) * 2 - 1)
        meshes = []
        for i in range(len(images)):
            with span("marching", sync=self.device):
                verts, faces = mesh_from_sdf(sdf[i])
            with span("colors", sync=self.device):
                rgb = self.vertex_colors(planes[i], verts)
            meshes.append(Mesh(verts, faces, rgb))
        return meshes

    def __call__(self, flag: str, image_nobg: np.ndarray,
                 partial_xyz=None, partial_rgb=None, viewpoint=None) -> Mesh:
        return self.generate_meshes_batch([flag], [image_nobg])[0]

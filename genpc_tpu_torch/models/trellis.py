"""TRELLIS-class image-to-3D: a two-stage structured-latent flow
(counterpart of genpc_tpu/models/trellis.py).

``TrellisBackend(cfg, variant, seed=0)`` builds, on ``cfg.device`` (the
card by default) at ``cfg.model_size`` ("full" at the reference's
widths, bf16 weights; otherwise the tiny test preset in fp32):
  * ``ImageEncoder``: a patch embedding and transformer blocks over the
    224² input (the DINO role) -> image tokens;
  * ``GridFlowTransformer`` twice: a rectified-flow transformer over the
    dense voxel tokens with cross-attention to the image tokens and one
    adaLN shift/scale after its out-norm; the structure flow generates
    an occupancy latent over 16³ voxels, the SLAT flow structured
    latents over 32³ (occupancy as an extra input channel);
  * ``SlatDecoder``: latents -> a 4³ sub-grid of signed distances and a
    colour a voxel, assembled into a dense 128³ SDF.
The surface is cut at the SDF's median by marching tetrahedra
(ops/marching.py, on the volume's device), and each vertex takes its
nearest voxel's colour.  ``trellis`` and ``trellis_2`` build the same
network (the reference stores the variant and reads it nowhere).

Sampling copies the reference: each flow runs ``FlowMatchEuler`` (shift
3.0) with the time embedded as ``timestep_embedding(t * 1000, 256)``, 25
steps at full size (12 otherwise); the structure is upsampled to the
SLAT grid by nearest repetition; the SLAT is multiplied by the soft
occupancy; inactive voxels get +1.  ``generate`` is pure: it takes its
N(0, 1) draws.  Each object draws from a generator of its own (seeded by
the backend's seed and a running count of objects), the structure noise
then the SLAT noise, so how objects are grouped into a batch changes no
mesh.  On the card each flow step is one CUDA graph replay.

No public TRELLIS checkpoint fits this architecture (the reference's is
of the same class, not a rebuild of the release);
``weights.load_trellis`` restores only checkpoints saved from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import (
    BF16, F32, Conv2d, LayerNorm, Linear, NORM_EPS, TransformerBlock,
    timestep_embedding)
from genpc_tpu_torch.models.lrm import mesh_from_sdf
from genpc_tpu_torch.models.schedulers import FlowMatchEuler, at
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import span

#: the random weights' seed (the reference initialises from PRNGKey(0)
#: whatever the backend's seed)
WEIGHT_SEED = 0


@dataclass(frozen=True)
class TrellisConfig:
    struct_res: int = 16          # structure grid resolution
    slat_res: int = 32            # latent grid resolution
    slat_dim: int = 8             # per-voxel structured latent channels
    hidden_dim: int = 768
    num_heads: int = 12
    struct_layers: int = 12
    slat_layers: int = 12
    dec_layers: int = 4
    img_dim: int = 384            # image encoder width
    img_layers: int = 6
    patch: int = 16
    img_size: int = 224
    sdf_cells: int = 4            # SDF samples per voxel edge at decode

    @classmethod
    def preset(cls, name: str) -> "TrellisConfig":
        if name == "tiny":
            return cls(struct_res=4, slat_res=8, slat_dim=4, hidden_dim=32,
                       num_heads=2, struct_layers=1, slat_layers=1,
                       dec_layers=1, img_dim=32, img_layers=1, patch=8,
                       img_size=32, sdf_cells=2)
        return cls()


def _add_blocks(module: nn.Module, n: int, *args, **kw) -> None:
    """Transformer blocks named ``block_0`` ... (the reference's paths)."""
    for i in range(n):
        module.add_module(f"block_{i}", TransformerBlock(*args, **kw))


class ImageEncoder(nn.Module):
    """DINO-role conditioning encoder: images [B, 3, s, s] in [-1, 1] ->
    patch tokens [B, T, img_dim] (fp32)."""

    def __init__(self, cfg: TrellisConfig):
        super().__init__()
        self.cfg = cfg
        t = (cfg.img_size // cfg.patch) ** 2
        self.patch_embed = Conv2d(3, cfg.img_dim, k=cfg.patch,
                                  stride=cfg.patch, padding=0)
        self.pos = nn.Parameter(torch.empty(1, t, cfg.img_dim))
        _add_blocks(self, cfg.img_layers, cfg.img_dim,
                    max(2, cfg.img_dim // 64))
        self.ln = LayerNorm(cfg.img_dim)

    def forward(self, img):
        x = self.patch_embed(img).flatten(2).transpose(1, 2) + self.pos
        for i in range(self.cfg.img_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.ln(x)


class GridFlowTransformer(nn.Module):
    """Rectified-flow transformer over dense voxel tokens: the velocity
    of ``channels`` per-voxel channels, cross-attending to the image
    tokens, with one adaLN shift/scale of the time after the out-norm
    (a LayerNorm with no scale and no bias)."""

    def __init__(self, cfg: TrellisConfig, channels: int, layers: int,
                 tokens: int, extra: int = 0):
        super().__init__()
        d = cfg.hidden_dim
        self.layers = layers
        self.in_proj = Linear(channels + extra, d)
        self.pos = nn.Parameter(torch.empty(1, tokens, d))
        self.time_in = Linear(256, d)
        self.ctx_proj = Linear(cfg.img_dim, d)
        self.mod = Linear(d, 2 * d)
        _add_blocks(self, layers, d, cfg.num_heads, context_dim=d)
        self.out_proj = Linear(d, channels, compute=F32)

    def forward(self, x, t, img_tokens, extra=None):
        """x [B, T, C] voxel tokens; t [B]; img_tokens [B, L, img_dim]."""
        h = self.in_proj(x if extra is None else torch.cat([x, extra], -1))
        h = h + self.pos
        vec = self.time_in(timestep_embedding(t * 1000.0, 256))
        ctx = self.ctx_proj(img_tokens)
        shift, scale = self.mod(F.silu(vec))[:, None, :].chunk(2, dim=-1)
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h, ctx)
        h = F.layer_norm(h.to(F32), h.shape[-1:], eps=NORM_EPS)
        return self.out_proj(h * (1 + scale) + shift)


class SlatDecoder(nn.Module):
    """Structured latents [B, T, C] -> (sdf [B, T, K³], rgb [B, T, 3]): a
    light transformer pass, then a K³ sub-grid of signed distances and a
    colour a voxel."""

    def __init__(self, cfg: TrellisConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.layers = cfg.dec_layers
        self.in_proj = Linear(cfg.slat_dim, d)
        self.pos = nn.Parameter(torch.empty(1, cfg.slat_res ** 3, d))
        _add_blocks(self, cfg.dec_layers, d, cfg.num_heads)
        self.ln = LayerNorm(d)
        self.sdf_head = Linear(d, cfg.sdf_cells ** 3, compute=F32)
        self.rgb_head = Linear(d, 3, compute=F32)

    def forward(self, slat):
        h = self.in_proj(slat) + self.pos
        for i in range(self.layers):
            h = getattr(self, f"block_{i}")(h)
        h = self.ln(h)
        return self.sdf_head(h), torch.sigmoid(self.rgb_head(h))


class TrellisNet(nn.Module):
    """The backend's four networks (the reference's four trees)."""

    def __init__(self, cfg: TrellisConfig):
        super().__init__()
        self.encoder = ImageEncoder(cfg)
        self.struct_flow = GridFlowTransformer(
            cfg, 1, cfg.struct_layers, cfg.struct_res ** 3)
        self.slat_flow = GridFlowTransformer(
            cfg, cfg.slat_dim, cfg.slat_layers, cfg.slat_res ** 3, extra=1)
        self.decoder = SlatDecoder(cfg)


def _repeat3(x: torch.Tensor, n: int) -> torch.Tensor:
    """Nearest upsampling of [B, R, R, R] by n along each grid axis."""
    for d in (1, 2, 3):
        x = x.repeat_interleave(n, dim=d)
    return x


class TrellisBackend:
    """image23d backend: a no-background image -> a coloured Mesh."""

    def __init__(self, cfg=None, variant: str = "trellis", seed: int = 0):
        self.cfg = cfg or {}
        self.variant = variant
        full = self.cfg.get("model_size", "tiny") == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if full else F32
        self.tc = TrellisConfig.preset("full" if full else "tiny")
        self.steps = 25 if full else 12     # the TRELLIS default: 25
        self.seed = seed
        with torch.device("meta"):
            self.net = TrellisNet(self.tc)
        self._ready = False
        self._objects = 0
        self._graphs: Dict[tuple, GraphedCall] = {}

    def models(self) -> Dict[str, nn.Module]:
        """The backend's model by kind (``weights.from_flax``'s name)."""
        return {"trellis": self.net}

    def init_params(self, state: Optional[Dict[str, torch.Tensor]] = None
                    ) -> None:
        """Materialise the networks on the device: from ``state`` when
        given, else seeded random weights, then a checkpoint saved from
        this architecture in ``cfg.weights_dir`` where there is one."""
        from genpc_tpu_torch.models.weights import load_trellis, materialize
        self._graphs.clear()
        materialize(self.net, self.device, self.dtype,
                    seed=None if state is not None else WEIGHT_SEED,
                    prefix="trellis")
        if state is not None:
            self.net.load_state_dict(state, strict=True)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_trellis(weights_dir, self.net)
        self._ready = True

    def release(self) -> None:
        """Free the parameters (back to the meta device), the step graphs
        and the allocator's cache; the next call materialises them anew."""
        with span("release", sync=self.device):
            self._graphs.clear()
            self.net.to_empty(device="meta")
            self._ready = False
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def draws(self, b: int):
        """N(0, 1) draws of b objects: (structure noise [b, S³, 1], SLAT
        noise [b, R³, C]), each object's from its own generator."""
        tc = self.tc
        struct, slat = [], []
        for _ in range(b):
            g = torch.Generator(device=self.device)
            g.manual_seed((self.seed << 32) + self._objects)
            self._objects += 1
            struct.append(torch.randn((1, tc.struct_res ** 3, 1),
                                      generator=g, device=self.device))
            slat.append(torch.randn((1, tc.slat_res ** 3, tc.slat_dim),
                                    generator=g, device=self.device))
        return torch.cat(struct), torch.cat(slat)

    @staticmethod
    def flow_step(model, x, i, tok, extra, sched: FlowMatchEuler):
        """One Euler step of a flow at the step index i ([1] tensor)."""
        t = at(sched.timesteps, i).expand(x.shape[0])
        return sched.step(model(x, t, tok, extra), i, x)

    def _flow(self, name: str, x, tok, extra, sched: FlowMatchEuler):
        """A flow's loop: eagerly on the CPU, one CUDA graph replay a step
        on the card."""
        model = getattr(self.net, f"{name}_flow")
        tensors = [x, None, tok] + ([] if extra is None else [extra])
        for i in range(sched.num_steps):
            tensors[0] = x
            tensors[1] = torch.tensor([i], device=x.device)
            x = graphed_call(
                self._graphs, (name, sched.num_steps),
                lambda x, i, tok, *e: self.flow_step(
                    model, x, i, tok, e[0] if e else None, sched),
                tensors, self.device).clone()
        return x

    @torch.inference_mode()
    def generate(self, imgs, struct_noise, slat_noise):
        """The device program, pure: imgs [B, 3, s, s] in [-1, 1] and the
        draws -> (sdf [B, RK, RK, RK], rgb [B, R³, 3], occupancy [B, R,
        R, R])."""
        tc = self.tc
        b, r, k = imgs.shape[0], tc.slat_res, tc.sdf_cells
        sched = FlowMatchEuler(self.steps, device=imgs.device)
        with span("encode", sync=self.device):
            tok = self.net.encoder(imgs)
        with span("struct", sync=self.device):
            occ_lat = self._flow("struct", struct_noise, tok, None, sched)
        s = tc.struct_res
        occ = _repeat3(torch.sigmoid(occ_lat[..., 0]).reshape(b, s, s, s),
                       r // s)
        occ_tok = occ.reshape(b, -1, 1)
        with span("slat", sync=self.device):
            slat = self._flow("slat", slat_noise, tok, occ_tok, sched)
        with span("decode", sync=self.device):
            sdf_loc, rgb = self.net.decoder(slat * occ_tok)
            sdf = sdf_loc.reshape(b, r, r, r, k, k, k).permute(
                0, 1, 4, 2, 5, 3, 6).reshape(b, r * k, r * k, r * k)
            sdf = torch.where(_repeat3(occ < 0.5, k), 1.0, sdf)
        return sdf, rgb, occ

    def vertex_colors(self, verts: np.ndarray, rgb_vox: np.ndarray
                      ) -> np.ndarray:
        """Each vertex's nearest voxel colour (the grid index rounded half
        to even, as jax's ``round``), clipped to [0, 1]."""
        r = self.tc.slat_res
        c = (verts + np.float32(1.0)) * np.float32(0.5) * np.float32(r - 1)
        idx = np.clip(np.round(c).astype(np.int32), 0, r - 1)
        flat = idx[:, 0] * r * r + idx[:, 1] * r + idx[:, 2]
        return np.clip(rgb_vox[flat], 0, 1).astype(np.float32)

    def generate_meshes_batch(self, flags, images) -> List[Mesh]:
        """B no-background images -> B coloured meshes: the encoder, both
        flows, the decode and the SDF assembly run once over the [B, ...]
        batch; marching and colouring loop over the objects."""
        from genpc_tpu_torch.models.backends import prep_rgb
        if not self._ready:
            with span("init", sync=self.device):
                self.init_params()
        imgs = np.stack([prep_rgb(im, self.tc.img_size) for im in images])
        x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()).to(
            self.device) * 2 - 1
        struct_noise, slat_noise = self.draws(len(images))
        sdf, rgb, _ = self.generate(x, struct_noise, slat_noise)
        rgb = rgb.cpu().numpy()
        meshes = []
        for i in range(len(images)):
            with span("marching", sync=self.device):
                verts, faces = mesh_from_sdf(sdf[i])
            with span("colors", sync=self.device):
                cols = self.vertex_colors(verts, rgb[i])
            meshes.append(Mesh(verts, faces, cols))
        return meshes

    def __call__(self, flag: str, image_nobg: np.ndarray,
                 partial_xyz=None, partial_rgb=None, viewpoint=None) -> Mesh:
        return self.generate_meshes_batch([flag], [image_nobg])[0]

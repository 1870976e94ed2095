"""Image-to-3D: zero123plus multiview diffusion and the InstantMesh
triplane LRM (counterpart of genpc_tpu/models/lrm.py).

``InstantMeshBackend(cfg, seed=0)`` builds, on ``cfg.device`` (the card
by default; the CPU only when asked) and at ``cfg.model_size`` ("tiny"
for tests, "full" for the published widths):
  * the zero123plus UNet (SD2 layout, ``UNetConfig.preset("sd2")``), the
    VAE, the SD2 CLIP text tower and a CLIP ViT-H vision tower;
  * ``TriplaneLRM``, the InstantMesh ``lrm_generator``: a DINO ViT-B/16
    whose every layer is modulated by the camera (adaLN, four chunks, no
    gates), a triplane transformer (learned queries; cross-attention to
    the image tokens, self-attention, MLP; a 2x2 stride-2 transposed
    convolution from 32² to 64² planes) and the four-head OSG decoder.
Parameter names are the checkpoints' (InstantMesh's ``lrm_generator.``
keys with the prefix stripped, diffusers' and HF's), so real weights load
by name (``weights.load_instantmesh``); without them the weights are
seeded random.  Parameters are fp32 at the test presets and bf16 at full
size, with the reference's per-layer compute types: bf16 dense layers,
fp32 norms, heads, camera MLP and deconvolution.

A multiview step (``mv_step``) is a WRITE pass of the UNet over the
noise-matched condition latents (negative = black image, positive = the
input) recording every self-attention's tokens (``layers.RefBank``), then
a READ pass over the sample with those tokens appended to attn1's keys
and values, classifier-free guidance 4.0, and an Euler-ancestral step
(trailing spacing, v-prediction).  ``denoise_latents`` is pure: it takes
its N(0, 1) draws.  On the card each step is one CUDA graph replay.  The
six 320² views are decoded as a 3x2 grid; the LRM's SDF on a 96³ grid is
cut at its median by marching tetrahedra (ops/marching.py, on the card),
and the vertex colours are queried at the vertices.

Two behaviours of the reference are kept for parity (ROADMAP queue 3):
the transposed convolution flips its kernel against torch's
``ConvTranspose2d`` (flax's ``ConvTranspose`` computes it so, and the
reference grafts a checkpoint's kernel unflipped), and no zero123plus
latent scale or shift is applied around the VAE.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.models.graphs import GraphedCall, graphed_call
from genpc_tpu_torch.models.layers import (
    BF16, F32, Conv2d, LayerNorm, Linear, RefBank, attention, box,
    gelu_tanh)
from genpc_tpu_torch.models.schedulers import EulerAncestral, at, cfg_combine
from genpc_tpu_torch.models.text_encoder import (
    CLIPTextConfig, CLIPTextModel, CLIPVisionConfig, CLIPVisionModel,
    clip_preprocess, make_tokenizer)
from genpc_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from genpc_tpu_torch.ops.marching import marching_tetrahedra
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import count, span

#: the random weights' seed (the reference initialises from PRNGKey(0)
#: whatever the backend's seed)
WEIGHT_SEED = 0


@dataclass(frozen=True)
class LRMConfig:
    # DINO ViT encoder (facebook/dino-vitb16 layout)
    vit_dim: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    patch: int = 16
    img_size: int = 320              # zero123plus view size
    # triplane transformer
    dec_dim: int = 1024
    dec_layers: int = 16
    dec_heads: int = 16
    triplane_low_res: int = 32
    triplane_dim: int = 80
    # OSG decoder heads
    mlp_dim: int = 64
    mlp_layers: int = 4
    grid_res: int = 96               # density grid for extraction
    num_views: int = 6

    @property
    def triplane_res(self) -> int:   # after the 2x deconv
        return self.triplane_low_res * 2

    @property
    def view_size(self) -> int:
        return self.img_size

    @classmethod
    def preset(cls, name: str) -> "LRMConfig":
        if name == "tiny":
            return cls(vit_dim=32, vit_layers=1, vit_heads=2, patch=8,
                       img_size=32, dec_dim=32, dec_layers=1, dec_heads=2,
                       triplane_low_res=4, triplane_dim=8, mlp_dim=16,
                       mlp_layers=2, grid_res=24)
        return cls()


# ------------------------------------------------------------ DINO ViT

class DinoLayer(nn.Module):
    """HF ViTLayer with InstantMesh's camera adaLN (4 chunks, no gates)."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        d = cfg.vit_dim
        self.heads = cfg.vit_heads
        self.attention = box(
            attention=box(query=Linear(d, d), key=Linear(d, d),
                          value=Linear(d, d)),
            output=box(dense=Linear(d, d)))
        self.intermediate = box(dense=Linear(d, 4 * d))
        self.output = box(dense=Linear(4 * d, d))
        self.layernorm_before = LayerNorm(d)
        self.layernorm_after = LayerNorm(d)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(d, 4 * d, compute=F32))

    def forward(self, x, adaln_input):
        mod = self.adaLN_modulation(adaln_input.to(F32))[:, None, :]
        s_msa, sc_msa, s_mlp, sc_mlp = mod.chunk(4, dim=-1)
        h = self.layernorm_before(x) * (1 + sc_msa) + s_msa
        sa = self.attention.attention
        att = attention(sa.query(h), sa.key(h), sa.value(h), self.heads)
        x = x + self.attention.output.dense(att)
        h = self.layernorm_after(x) * (1 + sc_mlp) + s_mlp
        h = gelu_tanh(self.intermediate.dense(h))
        return x + self.output.dense(h)


class _DinoEmbeddings(nn.Module):
    def __init__(self, cfg: LRMConfig):
        super().__init__()
        d = cfg.vit_dim
        t = (cfg.img_size // cfg.patch) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, d))
        self.position_embeddings = nn.Parameter(torch.empty(1, 1 + t, d))
        self.patch_embeddings = box(projection=Conv2d(
            3, d, k=cfg.patch, stride=cfg.patch, padding=0))

    def forward(self, imgs):
        x = self.patch_embeddings.projection(imgs).flatten(2).transpose(1, 2)
        # the concatenation promotes, as jnp.concatenate does
        dt = torch.promote_types(x.dtype, self.cls_token.dtype)
        cls = self.cls_token.to(dt).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x.to(dt)], dim=1) + self.position_embeddings


class DinoViT(nn.Module):
    """facebook/dino-vitb16 with camera modulation: images [B, 3, H, W]
    and adaLN input [B, D] -> (tokens [B, 1 + T, D], pooled [B, D])."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        self.embeddings = _DinoEmbeddings(cfg)
        self.encoder = box(layer=nn.ModuleList(
            [DinoLayer(cfg) for _ in range(cfg.vit_layers)]))
        self.layernorm = LayerNorm(cfg.vit_dim)
        self.pooler = box(dense=Linear(cfg.vit_dim, cfg.vit_dim,
                                       compute=F32))

    def forward(self, imgs, adaln_input):
        x = self.embeddings(imgs)
        for layer in self.encoder.layer:
            x = layer(x, adaln_input)
        x = self.layernorm(x)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


class CameraEmbedder(nn.Sequential):
    """InstantMesh DinoWrapper's camera MLP: 16 -> D -> D, fp32."""

    def __init__(self, cfg: LRMConfig):
        d = cfg.vit_dim
        super().__init__(Linear(16, d, compute=F32), nn.SiLU(),
                         Linear(d, d, compute=F32))


# ------------------------------------------------ triplane transformer

class _CrossAttn(nn.Module):
    """torch nn.MultiheadAttention's parameters with kdim != embed_dim:
    separate q/k/v weights, one fused bias."""

    def __init__(self, d: int, kdim: int, heads: int):
        super().__init__()
        self.heads, self.compute = heads, BF16
        self.q_proj_weight = nn.Parameter(torch.empty(d, d))
        self.k_proj_weight = nn.Parameter(torch.empty(d, kdim))
        self.v_proj_weight = nn.Parameter(torch.empty(d, kdim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, x, ctx):
        c = self.compute
        bq, bk, bv = self.in_proj_bias.to(c).chunk(3)
        q = F.linear(x.to(c), self.q_proj_weight.to(c), bq)
        k = F.linear(ctx.to(c), self.k_proj_weight.to(c), bk)
        v = F.linear(ctx.to(c), self.v_proj_weight.to(c), bv)
        return self.out_proj(attention(q, k, v, self.heads))


class _SelfAttn(nn.Module):
    """torch nn.MultiheadAttention's parameters: fused in_proj."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads, self.compute = heads, BF16
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, x):
        c = self.compute
        ws = self.in_proj_weight.to(c).chunk(3)
        bs = self.in_proj_bias.to(c).chunk(3)
        xc = x.to(c)
        q, k, v = (F.linear(xc, w, b) for w, b in zip(ws, bs))
        return self.out_proj(attention(q, k, v, self.heads))


class TriplaneBlock(nn.Module):
    """InstantMesh BasicTransformerBlock: cross-attention to the image
    tokens, self-attention, MLP, each pre-LayerNorm."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        d = cfg.dec_dim
        self.norm1 = LayerNorm(d)
        self.cross_attn = _CrossAttn(d, cfg.vit_dim, cfg.dec_heads)
        self.norm2 = LayerNorm(d)
        self.self_attn = _SelfAttn(d, cfg.dec_heads)
        self.norm3 = LayerNorm(d)
        self.mlp = nn.Sequential(Linear(d, 4 * d), nn.Identity(),
                                 Linear(4 * d, d))

    def forward(self, x, ctx):
        x = x + self.cross_attn(self.norm1(x), ctx)
        x = x + self.self_attn(self.norm2(x))
        return x + self.mlp[2](gelu_tanh(self.mlp[0](self.norm3(x))))


class TriplaneTransformer(nn.Module):
    """Image tokens [B, T, D_vit] -> triplanes [B, 3, R, R, C]."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        self.cfg = cfg
        low, dd = cfg.triplane_low_res, cfg.dec_dim
        self.pos_embed = nn.Parameter(torch.empty(1, 3 * low * low, dd))
        self.layers = nn.ModuleList([TriplaneBlock(cfg)
                                     for _ in range(cfg.dec_layers)])
        self.norm = LayerNorm(dd)
        # ConvTranspose2d layout (in, out, kh, kw)
        self.deconv = box()
        self.deconv.weight = nn.Parameter(
            torch.empty(dd, cfg.triplane_dim, 2, 2))
        self.deconv.bias = nn.Parameter(torch.empty(cfg.triplane_dim))

    def forward(self, img_tokens):
        cfg = self.cfg
        b, low = img_tokens.shape[0], cfg.triplane_low_res
        x = self.pos_embed.expand(b, -1, -1)
        for layer in self.layers:
            x = layer(x, img_tokens)
        x = self.norm(x)                                      # fp32
        x = x.reshape(b * 3, low, low, cfg.dec_dim).permute(0, 3, 1, 2)
        # flax's ConvTranspose: torch's with the kernel flipped
        w = self.deconv.weight.to(F32).flip(2, 3)
        x = F.conv_transpose2d(x, w, self.deconv.bias.to(F32), stride=2)
        r = cfg.triplane_res
        return x.permute(0, 2, 3, 1).reshape(b, 3, r, r, cfg.triplane_dim)


# ----------------------------------------------------- triplane lookup

def _bilerp(plane, u, v):
    """Bilinear lookup of plane [R, R, C] at fractional (u, v) [N]; the
    cell index clipped to [0, R - 2], the fraction not."""
    r = plane.shape[0]
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, r - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, r - 2)
    fu = (u - u0)[:, None]
    fv = (v - v0)[:, None]
    return ((1 - fu) * (1 - fv) * plane[u0, v0]
            + (1 - fu) * fv * plane[u0, v0 + 1]
            + fu * (1 - fv) * plane[u0 + 1, v0]
            + fu * fv * plane[u0 + 1, v0 + 1])


def _plane_feats(planes, pts):
    c = (pts + 1.0) * 0.5 * (planes.shape[1] - 1)
    return (_bilerp(planes[0], c[:, 0], c[:, 1]),
            _bilerp(planes[1], c[:, 0], c[:, 2]),
            _bilerp(planes[2], c[:, 1], c[:, 2]))


def sample_triplane(planes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Summed bilinear triplane lookup: planes [3,R,R,C], pts [N,3] in
    [-1, 1] -> [N, C]."""
    f_xy, f_xz, f_yz = _plane_feats(planes, pts)
    return f_xy + f_xz + f_yz


def sample_triplane_concat(planes: torch.Tensor, pts: torch.Tensor
                           ) -> torch.Tensor:
    """Concatenated per-plane features [N, 3C] (the OSG decoder's input)."""
    return torch.cat(_plane_feats(planes, pts), dim=-1)


# ------------------------------------------------------------- decoder

HEADS = (("net_sdf", 1), ("net_rgb", 3), ("net_deformation", 3),
         ("net_weight", 21))


class SynthesizerDecoder(nn.Module):
    """InstantMesh OSGDecoder (FlexiCubes variant): four fp32 MLP heads
    over the concatenated triplane features."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        heads = {}
        for name, out in HEADS:
            mods, d = [], 3 * cfg.triplane_dim
            for _ in range(cfg.mlp_layers - 1):
                mods += [Linear(d, cfg.mlp_dim, compute=F32), nn.ReLU()]
                d = cfg.mlp_dim
            heads[name] = nn.Sequential(*mods, Linear(d, out, compute=F32))
        self.decoder = box(**heads)

    def head(self, name: str, feats):
        return getattr(self.decoder, name)(feats)

    def forward(self, feats):
        return (self.head("net_sdf", feats)[..., 0],
                torch.sigmoid(self.head("net_rgb", feats)),
                self.head("net_deformation", feats),
                self.head("net_weight", feats))


class TriplaneLRM(nn.Module):
    """InstantMesh lrm_generator: encoder, transformer, synthesizer."""

    def __init__(self, cfg: LRMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = box(model=DinoViT(cfg),
                           camera_embedder=CameraEmbedder(cfg))
        self.transformer = TriplaneTransformer(cfg)
        self.synthesizer = SynthesizerDecoder(cfg)

    def forward_planes(self, views, cameras):
        """views [B, V, 3, H, W] in [0, 1]; cameras [B, V, 16] ->
        triplanes [B, 3, R, R, C]."""
        b, v = views.shape[:2]
        cam = self.encoder.camera_embedder(cameras.reshape(b * v, 16))
        tokens, _ = self.encoder.model(views.flatten(0, 1), cam)
        return self.transformer(tokens.reshape(b, -1, tokens.shape[-1]))

    def query(self, planes, pts):
        """planes [3, R, R, C], pts [N, 3] -> (sdf, rgb, deformation,
        weight)."""
        return self.synthesizer(sample_triplane_concat(planes, pts))

    def sdf_at(self, planes, pts):
        """The SDF head alone (``query``'s first output)."""
        return self.synthesizer.head(
            "net_sdf", sample_triplane_concat(planes, pts))[..., 0]

    def rgb_at(self, planes, pts):
        """The colour head alone (``query``'s second output)."""
        return torch.sigmoid(self.synthesizer.head(
            "net_rgb", sample_triplane_concat(planes, pts)))


def zero123plus_cameras(num_views: int = 6, radius: float = 4.0
                        ) -> np.ndarray:
    """The 6 fixed zero123plus input cameras as 16-d embeddings
    (flattened 3x4 extrinsic + 4 intrinsics, the InstantMesh convention)."""
    azimuths = np.deg2rad([30, 90, 150, 210, 270, 330][:num_views])
    elevations = np.deg2rad([20, -10, 20, -10, 20, -10][:num_views])
    cams = []
    fov = math.radians(30.0)
    fx = 0.5 / math.tan(fov / 2)
    for az, el in zip(azimuths, elevations):
        eye = radius * np.array([np.cos(el) * np.cos(az),
                                 np.cos(el) * np.sin(az),
                                 np.sin(el)])
        z = eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.stack([x, y, z, eye], axis=1)          # 3x4
        cams.append(np.concatenate([c2w.reshape(-1),
                                    [fx, fx, 0.5, 0.5]]))
    return np.asarray(cams, np.float32)


def grid_points(res: int, device) -> torch.Tensor:
    """A density grid's points [res³, 3] in [-1, 1], ij order."""
    g = torch.from_numpy(np.linspace(-1.0, 1.0, res,
                                     dtype=np.float32)).to(device)
    return torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def mesh_from_sdf(sdf) -> Tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra at the grid's median (numpy's, a surface at any
    weights) on the grid's device, with the reference's one-triangle
    stand-in when nothing crosses: (vertices [V,3] float32, faces [F,3]
    int32)."""
    host = sdf.cpu().numpy() if isinstance(sdf, torch.Tensor) \
        else np.asarray(sdf)
    verts, faces = marching_tetrahedra(sdf, level=float(np.median(host)))
    if len(verts) == 0:
        verts = np.zeros((3, 3), np.float32)
        faces = np.asarray([[0, 1, 2]], np.int32)
    return verts.astype(np.float32), faces.astype(np.int32)


# ------------------------------------------------------------- backend

class InstantMeshBackend:
    """image23d backend: a no-background image -> a coloured Mesh."""

    def __init__(self, cfg=None, seed: int = 0):
        self.cfg = cfg or {}
        full = self.cfg.get("model_size", "tiny") == "full"
        self.device = resolve_device(self.cfg.get("device", "cuda"))
        self.dtype = BF16 if full else F32
        self.lrm_cfg = LRMConfig.preset("full" if full else "tiny")
        # no micro-conditioning: the tiny preset's add_embedding is never
        # called here, so the reference's (lazily built) tree has none
        self.unet_cfg = replace(UNetConfig.preset("sd2" if full else "tiny"),
                                addition_embed_dim=0)
        self.vae_cfg = VAEConfig.preset("full" if full else "tiny")
        self.txt_cfg = CLIPTextConfig.preset("clip_sd2" if full else "tiny")
        self.vis_cfg = CLIPVisionConfig.preset("vit_h" if full else "tiny")
        self.factor = self.vae_cfg.spatial_factor
        self.mv_steps = 75 if full else 4   # the reference's 75 steps
        self.mv_guidance = 4.0              # zero123plus pipeline default
        with torch.device("meta"):
            self.lrm = TriplaneLRM(self.lrm_cfg)
            self.unet = UNet2DCondition(self.unet_cfg)
            self.vae = AutoencoderKL(self.vae_cfg)
            self.clip_text = CLIPTextModel(self.txt_cfg)
            self.clip_vision = CLIPVisionModel(self.vis_cfg)
        self.tokenizer = make_tokenizer(self.cfg.get("weights_dir"),
                                        self.txt_cfg.vocab_size,
                                        self.txt_cfg.max_len)
        #: zero123plus's per-token ramping coefficients: pipeline
        #: configuration, linspace(0, 1, 77) unless a checkpoint ships them
        self.ramping: Optional[torch.Tensor] = None
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._graphs: Dict[tuple, GraphedCall] = {}

    # ------------------------------------------------------------------
    def models(self) -> Dict[str, nn.Module]:
        """The backend's models by kind (``weights.from_flax``'s names)."""
        return {"lrm": self.lrm, "unet": self.unet, "vae": self.vae,
                "clip_text": self.clip_text, "clip_vision": self.clip_vision}

    def init_params(self, state: Optional[Dict[str, dict]] = None) -> None:
        """Materialise every model on the device: from ``state`` (kind ->
        state dict) when given, else seeded random weights, then the
        checkpoints of ``cfg.weights_dir`` where they exist."""
        from genpc_tpu_torch.models.weights import (load_instantmesh,
                                                    materialize)
        self._graphs.clear()
        for kind, mod in self.models().items():
            materialize(mod, self.device, self.dtype,
                        seed=None if state is not None else WEIGHT_SEED,
                        prefix=kind)
            if state is not None:
                mod.load_state_dict(state[kind], strict=True)
        ramp = np.linspace(0.0, 1.0, self.txt_cfg.max_len).astype(np.float32)
        self.ramping = torch.from_numpy(ramp).to(self.device, self.dtype)
        weights_dir = self.cfg.get("weights_dir")
        if weights_dir:
            load_instantmesh(weights_dir, self)

    @property
    def ready(self) -> bool:
        return self.ramping is not None

    def release(self) -> None:
        """Free the parameters of every model (back to the meta device),
        the step graphs and the allocator's cache; the next call
        materialises them anew."""
        with span("release", sync=self.device):
            self._graphs.clear()
            for mod in self.models().values():
                mod.to_empty(device="meta")
            self.ramping = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    def grid_hw(self) -> Tuple[int, int]:
        """The latent grid of the 3x2 views."""
        vs = self.lrm_cfg.view_size
        return 3 * vs // self.factor, 2 * vs // self.factor

    def prep_image(self, image_nobg) -> np.ndarray:
        """RGBA/RGB [H, W, *] in [0, 1] -> alpha-matted [vs, vs, 3]."""
        from genpc_tpu_torch.models.backends import prep_rgb
        return prep_rgb(image_nobg, self.lrm_cfg.view_size)

    @torch.inference_mode()
    def encode_context(self, imgs01: np.ndarray) -> torch.Tensor:
        """imgs01 [B, vs, vs, 3] in [0, 1] -> context [B, 2, 77, D]: per
        object (negative, positive), the empty prompt's SD2 text embedding
        and that plus ramping x the CLIP-H image embedding."""
        ids = torch.as_tensor(self.tokenizer(""), dtype=torch.long,
                              device=self.device)[None]
        txt, _, _ = self.clip_text(ids)
        pix = np.concatenate([clip_preprocess(i, self.vis_cfg.image_size)
                              for i in imgs01])
        pix = torch.from_numpy(pix.transpose(0, 3, 1, 2).copy()).to(
            self.device)
        _, img_emb = self.clip_vision(pix)
        ramp = self.ramping[: txt.shape[1]]
        pos = txt + ramp[None, :, None] * img_emb[:, None, :]
        return torch.stack([txt.expand_as(pos), pos], dim=1)

    @torch.inference_mode()
    def encode_condition(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, vs, vs] in [-1, 1] -> condition latents [B, 2, C,
        h, w]: per object (black image, the input)."""
        pos = self.vae.encode(images)
        neg = self.vae.encode(-torch.ones_like(images[:1]))
        return torch.stack([neg.expand_as(pos), pos], dim=1)

    def mv_step(self, latents, cond_pair, ctx, i, cond_noise, step_noise,
                sched: EulerAncestral):
        """One multiview step for B objects.  latents [B, C, gh, gw];
        cond_pair, cond_noise [B, 2, C, h, w]; ctx [B, 2, 77, D]; i a
        [1] step index; step_noise [B, C, gh, gw]."""
        b = latents.shape[0]
        t = at(sched.timesteps, i).expand(2 * b)
        noisy = sched.scale_model_input(
            sched.add_noise(cond_pair, cond_noise, i), i).flatten(0, 1)
        ctx2 = ctx.flatten(0, 1)
        bank = RefBank("w")
        self.unet(noisy, t, ctx2, ref=bank)
        lat = sched.scale_model_input(latents, i).repeat_interleave(2, 0)
        out = self.unet(lat, t, ctx2, ref=RefBank("r", bank.tokens))
        out = out.unflatten(0, (b, 2))
        v = cfg_combine(out[:, 0], out[:, 1], self.mv_guidance)
        return sched.step(v, i, latents, step_noise)

    def _step(self, sched, tensors):
        """``mv_step`` as the loop runs it: eagerly on the CPU; on the card
        through a CUDA graph captured at the first call with these shapes
        (a returned tensor is overwritten by the next call)."""
        return graphed_call(self._graphs, (sched.num_steps,),
                            lambda *a: self.mv_step(*a, sched), tensors,
                            self.device)

    @torch.inference_mode()
    def denoise_latents(self, cond_pair, ctx, latents, cond_noises,
                        step_noises) -> torch.Tensor:
        """The multiview loop, pure: ``latents`` [B, C, gh, gw],
        ``cond_noises`` [steps, B, 2, C, h, w] and ``step_noises`` [steps,
        B, C, gh, gw] are N(0, 1) draws."""
        sched = EulerAncestral(len(step_noises), spacing="trailing",
                               prediction="v", device=latents.device)
        x = latents * sched.init_noise_sigma
        for i in range(len(step_noises)):
            idx = torch.tensor([i], device=latents.device)
            x = self._step(sched, [x, cond_pair, ctx, idx, cond_noises[i],
                                   step_noises[i]]).clone()
        return x

    @torch.inference_mode()
    def decode(self, latents) -> torch.Tensor:
        """latents [B, C, gh, gw] -> views [B, 6, 3, vs, vs] in [0, 1],
        the 3x2 grid in row-major order."""
        grid = torch.clamp(self.vae.decode(latents) / 2 + 0.5, 0, 1)
        b, vs = grid.shape[0], self.lrm_cfg.view_size
        views = grid.reshape(b, 3, 3, vs, 2, vs).permute(0, 2, 4, 1, 3, 5)
        return views.reshape(b, 6, 3, vs, vs)

    def cameras(self, b: int) -> torch.Tensor:
        cams = torch.from_numpy(zero123plus_cameras(self.lrm_cfg.num_views))
        return cams.to(self.device).expand(b, -1, -1)

    @torch.inference_mode()
    def density_grid(self, views, cameras):
        """views [B, 6, 3, vs, vs], cameras [B, 6, 16] -> (triplanes [B, 3,
        R, R, C], SDF grids [B, Rg, Rg, Rg])."""
        planes = self.lrm.forward_planes(views, cameras)
        r = self.lrm_cfg.grid_res
        pts = grid_points(r, self.device)
        sdf = torch.stack([self.lrm.sdf_at(p, pts).reshape(r, r, r)
                           for p in planes])
        return planes, sdf

    @torch.inference_mode()
    def vertex_colors(self, planes, verts: np.ndarray) -> np.ndarray:
        """The colour head at the vertices, clipped to [0, 1]."""
        pts = torch.from_numpy(verts).to(self.device)
        return np.clip(self.lrm.rgb_at(planes, pts).cpu().numpy(), 0,
                       1).astype(np.float32)

    def draws(self, b: int):
        """N(0, 1) draws of one call for b objects: (latents, condition
        noises, step noises), from the backend's generator."""
        gh, gw = self.grid_hw()
        c = self.unet_cfg.in_channels
        h = self.lrm_cfg.view_size // self.factor
        n = self.mv_steps

        def randn(*shape):
            return torch.randn(shape, generator=self.generator,
                               device=self.device)

        return (randn(b, c, gh, gw), randn(n, b, 2, c, h, h),
                randn(n, b, c, gh, gw))

    # ------------------------------------------------------------------
    def generate_meshes_batch(self, flags, images) -> List[Mesh]:
        """B no-background images -> B coloured meshes: the context, the
        condition latents, the multiview loop, the decode and the density
        grids each run once over the [B, ...] batch."""
        if not self.ready:
            with span("init", sync=self.device):
                self.init_params()
        imgs01 = np.stack([self.prep_image(im) for im in images])
        with span("context", sync=self.device):
            ctx = self.encode_context(imgs01)
            x = torch.from_numpy(imgs01.transpose(0, 3, 1, 2).copy())
            cond = self.encode_condition(x.to(self.device) * 2 - 1)
        latents, cond_noises, step_noises = self.draws(len(images))
        with span("denoise", sync=self.device):
            count("steps", len(step_noises))
            lat = self.denoise_latents(cond, ctx, latents, cond_noises,
                                       step_noises)
        with span("decode", sync=self.device):
            views = self.decode(lat)
        with span("grid", sync=self.device):
            planes, sdf = self.density_grid(views,
                                            self.cameras(len(images)))
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

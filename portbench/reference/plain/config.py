"""Attribute-style config (counterpart of genpc_tpu/config.py).

``DEFAULTS`` equal the reference's key for key, except ``device``: in the
reference it is informational ("tpu"), here it selects the torch device
of a run ("cuda" or "cpu").  PyYAML is imported only when a YAML path is
given, so keyword-only configs need no YAML package.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping


class Config(dict):
    """dict with attribute access and deep-copy-on-merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_dict(v) if isinstance(v, Mapping) else v
        return out

    def merged(self, other: Mapping[str, Any]) -> "Config":
        out = copy.deepcopy(self)
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
                out[k] = Config.from_dict(out[k]).merged(v)
            else:
                out[k] = copy.deepcopy(v)
        return out


#: The reference's defaults (genpc_tpu/config.py), with a real device key.
DEFAULTS: Dict[str, Any] = dict(
    # Experiment
    output_path="workspace",
    save=True,
    dataset="redwood",            # redwood, pcn, scannet, kitti
    device="cuda",                # torch device of a run: 'cuda' | 'cpu'
    seed=0,
    # Depth Prompting
    coords_scale=0.5,
    distance=1.6,
    fovy=49.1,
    point_size=1,
    mask_pixel_rate=3,
    downsample_num=10000,
    removal_radius=10000,
    camera_distribution="fibonacci_sphere",
    cam_res=256,
    view_num=1024,
    camera_base="jax",
    # inpaint
    res=256,
    edge_point_size=2,
    generate_res=512,
    # crop and rescale
    rescale=True,
    padding=0.15,
    mask_ratio_thresh=0.82,
    # backends
    inpainter="jax",              # the diffusion fill; the name is the reference's
    rembg_model="synthetic",
    control_model="synthetic",
    generative_model="synthetic",
    visibility="zbuffer",
    select_coarse_points=2500,
    select_topk=48,
    metric_points=16384,
    fused_points=20000,
    glb_sample_points=163840,
    pose_iters=200,
    pose_lr=0.01,
    pose_render_size=224,
    pose_coarse_frac=0.7,
    pose_starts=4,
    pose_prune_starts=0,
    emd_eps=0.005,
    emd_iters=50,
    denoise_neighbors=20,
    denoise_std=2.5,
    input_points=65536,
    trust_aligned_completion=False,
    weights_dir=None,
    model_size="tiny",
    quant_bits=None,
    tower_quant_bits=None,
    mesh_shape=None,
    image23d_batch=0,
    final_refine="anisotropic",
)


def load_config(path: str | None = None, **overrides: Any) -> Config:
    """Load a YAML config merged over DEFAULTS (+ keyword overrides)."""
    cfg = Config.from_dict(DEFAULTS)
    if path is not None:
        import yaml
        with open(path, "r") as f:
            data = yaml.safe_load(f.read()) or {}
        cfg = cfg.merged(data)
    if overrides:
        cfg = cfg.merged(overrides)
    return cfg

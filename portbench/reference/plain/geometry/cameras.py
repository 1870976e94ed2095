"""Pinhole camera math (counterpart of genpc_tpu/geometry/cameras.py).

A camera rig is one struct of tensors; projection of a cloud through
every view is one batched einsum.

Conventions (the reference's): right-handed world, cameras look at the
origin with ``up`` aligned to world +y; camera space x=right, y=up,
z=-forward; ``transform_points`` returns (u, v, depth) with u, v in NDC
and depth the distance along the viewing axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def fibonacci_sphere(samples: int, radius: float = 2.0) -> np.ndarray:
    """Evenly distributed viewpoints (reference: dataUtils.py:334-360)."""
    i = np.arange(samples, dtype=np.float64)
    phi = math.pi * (3.0 - math.sqrt(5.0))
    y = 1.0 - (i / (samples - 1)) * 2.0 if samples > 1 else np.zeros(1)
    r_y = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([np.cos(theta) * r_y, y, np.sin(theta) * r_y], axis=1)
    return pts * radius


def calculate_up_vector(eye, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Up vector aligning world +y (reference: camera_utils.py:104-113)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    gaze = target - eye
    world_up = np.array([0.0, 1.0, 0.0])
    side = np.cross(gaze, world_up)
    if np.allclose(side, 0):
        return np.array([0.0, 0.0, 1.0])
    up = np.cross(side, gaze)
    return up / np.linalg.norm(up)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def look_at_rotation(eye: torch.Tensor, at: torch.Tensor,
                     up: torch.Tensor) -> torch.Tensor:
    """World->camera rotation rows (right, true_up, -forward): [...,3,3]."""
    fwd = _unit(at - eye)
    right = _unit(torch.linalg.cross(fwd, up, dim=-1))
    true_up = torch.linalg.cross(right, fwd, dim=-1)
    return torch.stack([right, true_up, -fwd], dim=-2)


@dataclass
class Camera:
    """Batched pinhole cameras: all fields carry a leading view axis [V,...]."""
    eye: torch.Tensor      # [V,3]
    rot: torch.Tensor      # [V,3,3] world->camera
    fov: torch.Tensor      # [V] vertical fov, radians
    res: int               # image resolution (square)

    def __len__(self):
        return self.eye.shape[0]

    def __getitem__(self, i) -> "Camera":
        sel = (lambda a: a[i][None]) if isinstance(i, int) else (lambda a: a[i])
        return Camera(sel(self.eye), sel(self.rot), sel(self.fov), self.res)

    @classmethod
    def from_eyes(cls, eyes, fovy_deg: float, res: int,
                  at=(0.0, 0.0, 0.0), ups=None,
                  device: torch.device | str = "cpu") -> "Camera":
        eyes = np.atleast_2d(np.asarray(eyes, np.float64))
        if ups is None:
            ups = np.stack([calculate_up_vector(e, np.asarray(at))
                            for e in eyes])
        else:
            ups = np.atleast_2d(np.asarray(ups, np.float64))
        f32 = dict(dtype=torch.float32, device=device)
        eye_t = torch.as_tensor(eyes, **f32)
        at_t = torch.as_tensor(np.asarray(at, np.float64), **f32) \
            .expand(len(eyes), 3)
        rot = look_at_rotation(eye_t, at_t, torch.as_tensor(ups, **f32))
        fov = torch.full((len(eyes),), math.pi * fovy_deg / 180.0, **f32)
        return cls(eye_t, rot, fov, res)


def transform_points(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """Project points [N,3] with every camera -> [V,N,3] = (u, v, depth)."""
    pts = points.to(torch.float32)
    rel = pts[None, :, :] - cam.eye[:, None, :]             # [V,N,3]
    cam_pts = torch.einsum("vij,vnj->vni", cam.rot, rel)    # [V,N,3]
    depth = -cam_pts[..., 2]
    inv_tan = 1.0 / torch.tan(cam.fov * 0.5)
    safe = torch.clamp_min(depth, 1e-8)
    u = cam_pts[..., 0] / safe * inv_tan[:, None]
    v = cam_pts[..., 1] / safe * inv_tan[:, None]
    return torch.stack([u, v, depth], dim=-1)


def rescale_uvs(transformed: torch.Tensor, padding: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max-rescale projected uvs like the reference
    (DepthPrompting.py:247-261): centre, scale by the larger uv span,
    shrink by (1-2·padding), shift to [0,1].  transformed [V,N,3] ->
    (uvs [V,N,2], depths [V,N])."""
    uv = transformed[..., :2]
    lo = uv.amin(dim=1, keepdim=True)
    hi = uv.amax(dim=1, keepdim=True)
    center = (lo + hi) / 2.0
    scale = (hi - lo).amax(dim=2, keepdim=True)
    out = (uv - center) / torch.clamp_min(scale, 1e-12)
    out = out * (1.0 - 2.0 * padding) + 0.5
    return out, transformed[..., 2]


_CANONICAL_6 = np.array([
    [0, 0, -1.0], [0, 0, 1.0], [0, -1.0, 0],
    [0, 1.0, 0], [-1.0, 0, 0], [1.0, 0, 0],
])
_CANONICAL_6_UPS = np.array([
    [0, 1.0, 0], [0, 1.0, 0], [0, 0, 1.0],
    [0, 0, 1.0], [0, 1.0, 0], [0, 1.0, 0],
])


def create_cameras(num_views: int = 1024, distance: float = 1.6,
                   fovy: float = 49.1, res: int = 256,
                   distribution: str = "fibonacci_sphere",
                   device: torch.device | str = "cpu",
                   ) -> Tuple[Camera, np.ndarray]:
    """Camera rig + eye positions (reference: camera_utils.py:115-160).

    num_views == 6 selects the canonical orthogonal rig; otherwise a
    fibonacci sphere."""
    if num_views == 6:
        eyes = _CANONICAL_6 * distance
        cam = Camera.from_eyes(eyes, fovy, res, ups=_CANONICAL_6_UPS,
                               device=device)
        return cam, eyes
    eyes = fibonacci_sphere(num_views, distance)
    return Camera.from_eyes(eyes, fovy, res, device=device), eyes

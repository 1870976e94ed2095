"""Rotation parameterisations and rigid/similarity transforms in torch
(counterpart of genpc_tpu/geometry/transforms.py).

The 6D layout is pytorch3d's: the first two COLUMNS of R stacked
[r00, r10, r20, r01, r11, r21].  ``rotation_6d_to_matrix`` keeps the
reference's ``+1e-12`` in both normalisations.  Every function takes a
leading batch of any shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1, keepdim=True))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D -> rotation matrix via Gram-Schmidt: [...,6] -> [...,3,3]."""
    a1 = d6[..., 0:3]
    a2 = d6[..., 3:6]
    b1 = a1 / (_norm(a1) + 1e-12)
    a2p = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = a2p / (_norm(a2p) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)   # columns


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """First two columns of R, column-major flattened."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula; axis_angle [...,3] with |v| = angle."""
    v = torch.as_tensor(axis_angle, dtype=torch.float32)
    angle = _norm(v)
    safe = torch.where(angle > 1e-12, angle, 1.0)
    k = v / safe
    z = torch.zeros_like(k[..., 0])
    K = torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    R = eye + s * K + (1 - c) * (K @ K)
    return torch.where(angle[..., None] > 1e-12, R, eye)


def rot6d_from_axis_angle(axis: str, angle_deg: float,
                          device: torch.device | str = "cpu") -> torch.Tensor:
    """6D init rotation about a named axis (reference: diff_obj_pose.py:470-493)."""
    unit = {"x": [1.0, 0, 0], "y": [0, 1.0, 0], "z": [0, 0, 1.0]}[axis]
    v = torch.tensor(unit, dtype=torch.float32, device=device) \
        * math.radians(angle_deg)
    return matrix_to_rotation_6d(axis_angle_to_matrix(v))


def get_rotate_matrix(axis: str, angle_deg: float) -> np.ndarray:
    """Numpy rotation matrix (reference: utils/dataUtils.py:455-471)."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError("axis should be x, y or z")


def build_transform(R: torch.Tensor, t: torch.Tensor, scale) -> torch.Tensor:
    """4x4 [s·R | t] (reference: diff_obj_pose.py:464-468); R [...,3,3],
    t [...,3], scale a scalar or [...]."""
    R = torch.as_tensor(R, dtype=torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=R.device)
    T = torch.eye(4, dtype=torch.float32, device=R.device).expand(
        R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R * scale[..., None, None]
    T[..., :3, 3] = torch.as_tensor(t, dtype=torch.float32, device=R.device)
    return T


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a 4x4 (general, via LU — handles scaled blocks too)."""
    return torch.linalg.inv(torch.as_tensor(T, dtype=torch.float32))


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 T [...,4,4] to points [...,N,3]."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    T = torch.as_tensor(T, dtype=torch.float32, device=pts.device)
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]

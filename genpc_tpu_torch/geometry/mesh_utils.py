"""Mesh post-processing (counterpart of genpc_tpu/geometry/mesh_utils.py;
reference: utils/mesh_utils.py, which wraps open3d/pymeshlab):
  * ``weld_vertices``, ``decimate_mesh`` (vertex clustering),
    ``remove_small_components`` and ``clean_mesh``: numpy, as in the
    reference;
  * ``estimate_normals``: local PCA plane fits over each point's k
    nearest neighbours (``ops/knn.knn`` on ``device``), oriented outward;
  * ``poisson_reconstruct``: a screened-poisson stand-in: signed offsets
    along the normals splatted into a grid and smoothed on the host
    (scipy's ``gaussian_filter``), the zero level set extracted by
    ``ops/marching`` on ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.ops.knn import knn
from genpc_tpu_torch.ops.marching import marching_tetrahedra


def weld_vertices(mesh: Mesh, tol: float = 1e-6) -> Mesh:
    key = np.round(mesh.vertices / max(tol, 1e-12)).astype(np.int64)
    _, uniq, inv = np.unique(key, axis=0, return_index=True,
                             return_inverse=True)
    faces = inv[mesh.faces]
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    cols = (mesh.vertex_colors[uniq]
            if mesh.vertex_colors is not None else None)
    return Mesh(mesh.vertices[uniq], faces[ok].astype(np.int32), cols)


def decimate_mesh(mesh: Mesh, target_faces: int) -> Mesh:
    """Vertex-clustering decimation toward a face budget."""
    if len(mesh.faces) <= target_faces:
        return mesh
    span = (mesh.vertices.max(0) - mesh.vertices.min(0)).max()
    # grid resolution ~ sqrt relation between cells and faces
    res = max(4, int(np.sqrt(target_faces)))
    cell = span / res
    key = np.floor((mesh.vertices - mesh.vertices.min(0)) / cell).astype(
        np.int64)
    _, uniq, inv = np.unique(key, axis=0, return_index=True,
                             return_inverse=True)
    # cluster centroid per cell
    verts = np.zeros((len(uniq), 3))
    counts = np.zeros(len(uniq))
    np.add.at(verts, inv, mesh.vertices.astype(np.float64))
    np.add.at(counts, inv, 1)
    verts = (verts / counts[:, None]).astype(np.float32)
    cols = None
    if mesh.vertex_colors is not None:
        cols = np.zeros((len(uniq), 3))
        np.add.at(cols, inv, mesh.vertex_colors.astype(np.float64))
        cols = (cols / counts[:, None]).astype(np.float32)
    faces = inv[mesh.faces]
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = np.unique(np.sort(faces[ok], axis=1), axis=0)
    return Mesh(verts, faces.astype(np.int32), cols)


def remove_small_components(mesh: Mesh, min_faces: int = 10) -> Mesh:
    """Keep connected components with >= min_faces faces (union-find)."""
    parent = np.arange(len(mesh.vertices))

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for f in mesh.faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(v) for v in range(len(mesh.vertices))])
    face_root = roots[mesh.faces[:, 0]]
    keep_roots = {r for r, c in zip(*np.unique(face_root, return_counts=True))
                  if c >= min_faces}
    keep = np.array([r in keep_roots for r in face_root])
    faces = mesh.faces[keep]
    used = np.unique(faces)
    remap = np.full(len(mesh.vertices), -1, np.int64)
    remap[used] = np.arange(len(used))
    cols = mesh.vertex_colors[used] if mesh.vertex_colors is not None else None
    return Mesh(mesh.vertices[used], remap[faces].astype(np.int32), cols)


def clean_mesh(mesh: Mesh, weld_tol: float = 1e-6,
               min_component_faces: int = 10) -> Mesh:
    """Weld + drop degenerates + remove dust (reference: mesh_utils.py:88-147)."""
    return remove_small_components(weld_vertices(mesh, weld_tol),
                                   min_component_faces)


def estimate_normals(points: np.ndarray, k: int = 16,
                     device: torch.device | str = "cuda") -> np.ndarray:
    """Per-point normals by local PCA plane fit, oriented outward."""
    p = torch.as_tensor(np.asarray(points, np.float32), device=device)
    idx = knn(p, p, k)[1].cpu().numpy()
    nbrs = points[idx]                             # [N,k,3]
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]                        # smallest eigenvector
    centroid = points.mean(0)
    flip = np.sum(normals * (points - centroid), axis=1) < 0
    normals[flip] *= -1
    return normals.astype(np.float32)


def poisson_reconstruct(points: np.ndarray, grid_res: int = 96,
                        smooth_sigma: float = 1.5,
                        colors: Optional[np.ndarray] = None,
                        device: torch.device | str = "cuda") -> Mesh:
    """Surface reconstruction from an oriented point cloud (reference:
    mesh_utils.py:5-41 wraps o3d): splat signed offsets along the
    estimated normals into a grid, smooth, extract the zero level set."""
    pts = np.asarray(points, np.float64)
    center = (pts.max(0) + pts.min(0)) / 2
    scale = (pts.max(0) - pts.min(0)).max() * 0.6
    p = (pts - center) / scale                       # within [-0.85, 0.85]
    normals = estimate_normals(pts.astype(np.float32), device=device)
    R = grid_res
    grid = np.zeros((R, R, R))
    wgt = np.zeros((R, R, R))
    step = 2.0 / (R - 1)
    for off in (-1.0, 0.0, 1.0):                     # inside/on/outside
        q = p + normals * (off * step)
        idx = np.clip(((q + 1) / 2 * (R - 1)).round().astype(int), 0, R - 1)
        np.add.at(grid, (idx[:, 0], idx[:, 1], idx[:, 2]), -off)
        np.add.at(wgt, (idx[:, 0], idx[:, 1], idx[:, 2]), 1.0)
    field = np.where(wgt > 0, grid / np.maximum(wgt, 1), 0.0)
    # fill empty cells with a distance-decayed outside prior
    from scipy.ndimage import gaussian_filter
    field = gaussian_filter(field, smooth_sigma)
    # bias far-from-data cells outside
    occ = gaussian_filter((wgt > 0).astype(float), smooth_sigma * 2)
    field = field - 0.05 * (occ < 0.01)
    v, f = marching_tetrahedra(torch.as_tensor(field, device=device), 0.0)
    v = v * scale + center
    vc = None
    if colors is not None and len(v):
        f32 = dict(dtype=torch.float32, device=device)
        nn_idx = knn(torch.as_tensor(v, **f32), torch.as_tensor(pts, **f32),
                     1)[1].cpu().numpy()
        vc = np.asarray(colors)[nn_idx[:, 0]].astype(np.float32)
    return Mesh(v.astype(np.float32), f, vc)

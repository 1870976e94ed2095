"""Iso-surface extraction: marching tetrahedra over a density grid
(counterpart of genpc_tpu/ops/marching.py), on the host in numpy, as in
the reference: the same vertices and faces, in the same order (the weld's
``np.unique`` order).  Every cube splits into 6 tetrahedra, and every
tetrahedron's case resolves with array operations over a 16-case table
derived from first principles; the reference's image-to-3D path runs it
on the LRM's SDF grid in place of CUDA FlexiCubes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# the 6-tetrahedra decomposition of a unit cube (corner indices 0..7,
# corner c = (x, y, z) bits: x = c&1, y = (c>>1)&1, z = (c>>2)&1)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], np.int32)

# tet edges (pairs of local tet vertices 0..3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                      np.int32)


def _build_tet_tris() -> np.ndarray:
    """Derive the 16-case triangle table from first principles.

    A crossing edge has exactly one endpoint inside.  One vertex in (or
    out) -> its 3 incident crossing edges form a triangle.  Two-in-two-out
    -> the 4 crossing edges form a quad; walking it as (a,c),(a,d),(b,d),
    (b,c) (a,b inside; c,d outside) yields a planar-cycle split into two
    triangles.
    """
    edge_id = {tuple(sorted(e)): i for i, e in enumerate(_TET_EDGES.tolist())}
    table = np.full((16, 2, 3), -1, np.int32)
    for case in range(1, 15):
        inside = [v for v in range(4) if case >> v & 1]
        outside = [v for v in range(4) if not (case >> v & 1)]
        if len(inside) in (1, 3):
            apex = inside[0] if len(inside) == 1 else outside[0]
            others = [v for v in range(4) if v != apex]
            tri = [edge_id[tuple(sorted((apex, o)))] for o in others]
            table[case, 0] = tri
        else:
            a, b = inside
            c, d = outside
            quad = [edge_id[tuple(sorted((a, c)))],
                    edge_id[tuple(sorted((a, d)))],
                    edge_id[tuple(sorted((b, d)))],
                    edge_id[tuple(sorted((b, c)))]]
            table[case, 0] = [quad[0], quad[1], quad[2]]
            table[case, 1] = [quad[0], quad[2], quad[3]]
    return table


_TET_TRIS = _build_tet_tris()


def marching_tetrahedra(density: np.ndarray, level: float = 0.0,
                        origin=(-1.0, -1.0, -1.0), spacing: float = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface density == level.

    density: [R,R,R] (or [Rx,Ry,Rz]) scalar field; inside = density > level.
    Returns (vertices [V,3] float32 in world coords, faces [F,3] int32).
    """
    d = np.asarray(density, np.float64) - level
    rx, ry, rz = d.shape
    if spacing is None:
        spacing = 2.0 / (max(rx, ry, rz) - 1)
    origin = np.asarray(origin, np.float64)

    # gather the 8 corner values / coords of every cube: [ncubes, 8]
    cx, cy, cz = np.meshgrid(np.arange(rx - 1), np.arange(ry - 1),
                             np.arange(rz - 1), indexing="ij")
    base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # [nc,3]
    corner_bits = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                            for c in range(8)], np.int64)          # [8,3]
    corner_idx = base[:, None, :] + corner_bits[None, :, :]        # [nc,8,3]
    vals = d[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    coords = origin + corner_idx * spacing                          # [nc,8,3]

    # skip cubes with uniform sign early
    inside = vals > 0
    active = (inside.any(axis=1)) & (~inside.all(axis=1))
    vals, coords, inside = vals[active], coords[active], inside[active]
    if len(vals) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # expand into tets: [na, 6, 4]
    tv = vals[:, _TETS]            # [na,6,4]
    tc = coords[:, _TETS]          # [na,6,4,3]
    ti = inside[:, _TETS]          # [na,6,4]
    case = (ti[..., 0] * 1 + ti[..., 1] * 2
            + ti[..., 2] * 4 + ti[..., 3] * 8)   # [na,6]

    # edge interpolation points for all 6 tet edges: [na,6,6,3]
    a = tv[..., _TET_EDGES[:, 0]]
    b = tv[..., _TET_EDGES[:, 1]]
    denom = a - b
    tparam = np.where(np.abs(denom) > 1e-12, a / np.where(
        np.abs(denom) > 1e-12, denom, 1.0), 0.5)
    tparam = np.clip(tparam, 0.0, 1.0)[..., None]
    pa = tc[:, :, _TET_EDGES[:, 0], :]
    pb = tc[:, :, _TET_EDGES[:, 1], :]
    epts = pa + tparam * (pb - pa)                  # [na,6,6,3]

    tris = _TET_TRIS[case]                          # [na,6,2,3] edge ids
    valid = tris[..., 0] >= 0                       # [na,6,2]
    na = epts.shape[0]
    ai = np.arange(na)[:, None, None, None]
    ti6 = np.arange(6)[None, :, None, None]
    edge_sel = np.maximum(tris, 0)                  # [na,6,2,3]
    verts = epts[ai, ti6, edge_sel]                 # [na,6,2,3,3]
    verts = verts[valid]                            # [ntri,3,3]

    flat = verts.reshape(-1, 3)
    # weld duplicate vertices on a quantized grid (row-wise unique; hashing
    # rows collides and silently merges unrelated vertices)
    key = np.round(flat / (spacing * 1e-4)).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True,
                                 return_inverse=True)
    vertices = flat[uniq_idx].astype(np.float32)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return vertices, faces[ok]

"""Iso-surface extraction: marching tetrahedra over a density grid
(counterpart of genpc_tpu/ops/marching.py), with the reference's
vertices and faces in the same order, computed in torch on the device of
the density (the card for a CUDA tensor, the host's threads for a numpy
array or a CPU tensor).  Every cube splits into 6 tetrahedra, and every
tetrahedron's case resolves with array operations over a 16-case table
derived from first principles; the reference's image-to-3D path runs it
on the LRM's SDF grid in place of CUDA FlexiCubes.

The reference computes in float64 numpy; the same float64 operations in
the same order give the same bits on either device (each is one IEEE
operation, with no fused multiply-add across them).  Its weld is
``np.unique`` over quantised rows with the first occurrence of each row;
here one int64 code a row, which orders as the rows do, goes through a
stable sort.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def _unique_rows(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``np.unique(key, axis=0, return_index=True, return_inverse=True)``
    of int64 rows [N, 3] -> (first index of each unique row in the rows'
    lexicographic order, inverse), by stable sorts: of one code a row
    when the rows' ranges fit in an int64, else of each column from the
    last."""
    lo = key.min(dim=0).values
    span = key.max(dim=0).values - lo + 1
    if float(span[0]) * float(span[1]) * float(span[2]) < 2.0 ** 62:
        code = ((key[:, 0] - lo[0]) * span[1] + (key[:, 1] - lo[1])) \
            * span[2] + (key[:, 2] - lo[2])
        code, perm = torch.sort(code, stable=True)
    else:
        perm = torch.arange(len(key), device=key.device)
        for c in (2, 1, 0):
            _, order = torch.sort(key[perm, c], stable=True)
            perm = perm[order]
        code = key[perm]
    new = torch.ones(len(perm), dtype=torch.bool, device=key.device)
    new[1:] = (code[1:] != code[:-1]).reshape(len(perm) - 1, -1).any(dim=1)
    inv = torch.empty_like(perm)
    inv[perm] = torch.cumsum(new, 0) - 1
    return perm[new], inv


def marching_tetrahedra(density, level: float = 0.0,
                        origin=(-1.0, -1.0, -1.0), spacing: float = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface density == level.

    density: [R,R,R] (or [Rx,Ry,Rz]) scalar field, a numpy array or a
    tensor (computed on its device); inside = density > level.
    Returns (vertices [V,3] float32 in world coords, faces [F,3] int32),
    numpy.
    """
    f64 = torch.float64
    d = torch.as_tensor(density).to(f64) - level
    dev = d.device
    rx, ry, rz = d.shape
    if spacing is None:
        spacing = 2.0 / (max(rx, ry, rz) - 1)
    origin = torch.tensor(origin, dtype=f64, device=dev)
    tets = torch.as_tensor(_TETS, dtype=torch.long, device=dev)
    tet_edges = torch.as_tensor(_TET_EDGES, dtype=torch.long, device=dev)
    tet_tris = torch.as_tensor(_TET_TRIS, dtype=torch.long, device=dev)

    # the 8 corner values of every cube: [ncubes, 8]
    base = torch.stack(torch.meshgrid(
        *(torch.arange(n - 1, device=dev) for n in (rx, ry, rz)),
        indexing="ij"), dim=-1).reshape(-1, 3)
    corner_bits = torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                                for c in range(8)], device=dev)
    corner_idx = base[:, None, :] + corner_bits[None, :, :]        # [nc,8,3]
    vals = d[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]

    # skip cubes with uniform sign early
    inside = vals > 0
    active = inside.any(dim=1) & ~inside.all(dim=1)
    vals, inside = vals[active], inside[active]
    if len(vals) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    coords = origin + corner_idx[active].to(f64) * spacing          # [na,8,3]

    # each tet's case: [na, 6]
    ti = inside[:, tets].long()                                     # [na,6,4]
    case = ti[..., 0] * 1 + ti[..., 1] * 2 + ti[..., 2] * 4 + ti[..., 3] * 8

    # the triangles, in (cube, tet, slot) order, and each corner's edge:
    # its two cube corners
    tris = tet_tris[case]                           # [na,6,2,3] edge ids
    valid = tris[..., 0] >= 0
    cube, tet, _ = valid.nonzero(as_tuple=True)
    edges = tris[valid]                             # [ntri,3]
    c0 = tets[tet[:, None], tet_edges[edges, 0]]    # [ntri,3]
    c1 = tets[tet[:, None], tet_edges[edges, 1]]
    cube = cube[:, None]

    # the edge interpolation point of each triangle corner
    a = vals[cube, c0]
    b = vals[cube, c1]
    denom = a - b
    safe = denom.abs() > 1e-12
    tparam = torch.where(safe, a / torch.where(safe, denom, 1.0), 0.5)
    tparam = torch.clamp(tparam, 0.0, 1.0)[..., None]
    pa = coords[cube, c0]
    pb = coords[cube, c1]
    flat = (pa + tparam * (pb - pa)).reshape(-1, 3)  # [ntri*3,3]

    # weld duplicate vertices on a quantized grid (row-wise unique; hashing
    # rows collides and silently merges unrelated vertices)
    key = torch.round(flat / (spacing * 1e-4)).to(torch.int64)
    uniq_idx, inv = _unique_rows(key)
    vertices = flat[uniq_idx].to(torch.float32)
    faces = inv.reshape(-1, 3).to(torch.int32)
    # drop degenerate faces
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return vertices.cpu().numpy(), faces[ok].cpu().numpy()

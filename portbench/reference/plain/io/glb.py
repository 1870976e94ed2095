"""Minimal GLB (binary glTF 2.0) mesh IO and surface sampling, pure numpy
(counterpart of genpc_tpu/io/glb.py).

``load_glb`` reads a GLB's triangle primitives into one ``Mesh``
(POSITION, COLOR_0, TEXCOORD_0, node transforms, a base-colour factor
and, for colour lookup, an embedded PNG/JPEG base-colour texture, which
needs Pillow, imported only then); ``save_glb`` writes a ``Mesh`` with
its vertex colours; ``sample_mesh_surface`` draws area-weighted surface
points with barycentric colours from ``numpy.random.default_rng(0)``
unless given a generator, the same draws as the reference, so the
samples are bit-equal; ``glb_to_points`` chains the two.  A GLB written
by either package loads in the other.
"""

from __future__ import annotations

import io as _io
import json
import os
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class Mesh:
    """A triangle mesh with optional per-vertex colors (float in [0,1])."""
    vertices: np.ndarray                       # [V,3] float32
    faces: np.ndarray                          # [F,3] int32
    vertex_colors: Optional[np.ndarray] = None  # [V,3] float in [0,1]
    uvs: Optional[np.ndarray] = None            # [V,2]
    texture: Optional[np.ndarray] = None        # [H,W,3] float in [0,1]

    def with_baked_colors(self) -> "Mesh":
        """Bake texture into vertex colors (≈ trimesh visual.to_color())."""
        if self.vertex_colors is not None or self.texture is None or self.uvs is None:
            if self.vertex_colors is None:
                return Mesh(self.vertices, self.faces,
                            np.full((len(self.vertices), 3), 0.5, np.float32))
            return self
        h, w = self.texture.shape[:2]
        u = np.clip(self.uvs[:, 0] % 1.0, 0, 1) * (w - 1)
        v = np.clip(self.uvs[:, 1] % 1.0, 0, 1) * (h - 1)
        cols = self.texture[v.astype(int), u.astype(int), :3]
        return Mesh(self.vertices, self.faces, cols.astype(np.float32))

    def face_areas(self) -> np.ndarray:
        tri = self.vertices[self.faces]
        return 0.5 * np.linalg.norm(
            np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)


def _read_accessor(gltf: dict, bin_chunk: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    item = np.dtype(dtype).itemsize * ncomp
    if stride and stride != item:
        raw = np.frombuffer(bin_chunk, dtype=np.uint8,
                            count=stride * count, offset=offset)
        raw = raw.reshape(count, stride)[:, :item].copy()
        arr = raw.view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(bin_chunk, dtype=dtype, count=count * ncomp,
                            offset=offset).reshape(count, ncomp)
    if acc.get("normalized") and dtype != np.float32:
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return arr


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4).T
    T = np.eye(4)
    if "translation" in node:
        T[:3, 3] = node["translation"]
    R = np.eye(4)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        R[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
    S = np.eye(4)
    if "scale" in node:
        S[:3, :3] = np.diag(node["scale"])
    return T @ R @ S


def _decode_image(blob: bytes) -> Optional[np.ndarray]:
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(blob)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
    except Exception:
        return None


def load_glb(path: str) -> Mesh:
    """Load a GLB file and concatenate all mesh primitives into one Mesh."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version, _length = struct.unpack("<III", data[:12])
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    gltf, bin_chunk = None, b""
    while off < len(data):
        clen, ctype = struct.unpack("<II", data[off:off + 8])
        chunk = data[off + 8: off + 8 + clen]
        if ctype == 0x4E4F534A:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:
            bin_chunk = chunk
        off += 8 + clen + (-clen) % 4

    # resolve world transform per node
    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    world = {}

    def visit(node_idx, parent):
        node = gltf["nodes"][node_idx]
        M = parent @ _node_transform(node)
        if "mesh" in node:
            world.setdefault(node["mesh"], M)
        for c in node.get("children", []):
            visit(c, M)

    for n in scene.get("nodes", range(len(gltf.get("nodes", [])))):
        visit(n, np.eye(4))

    all_v, all_f, all_c, all_uv = [], [], [], []
    texture = None
    voff = 0
    for mi, mesh in enumerate(gltf.get("meshes", [])):
        M = world.get(mi, np.eye(4))
        for prim in mesh["primitives"]:
            if prim.get("mode", 4) != 4:
                continue
            pos = _read_accessor(gltf, bin_chunk, prim["attributes"]["POSITION"])
            pos = pos.astype(np.float64) @ M[:3, :3].T + M[:3, 3]
            if "indices" in prim:
                faces = _read_accessor(gltf, bin_chunk, prim["indices"])
                faces = faces.reshape(-1, 3).astype(np.int64)
            else:
                faces = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
            colors = None
            if "COLOR_0" in prim["attributes"]:
                c = _read_accessor(gltf, bin_chunk, prim["attributes"]["COLOR_0"])
                colors = np.asarray(c, np.float32)[:, :3]
                if colors.max(initial=0.0) > 1.0 + 1e-5:
                    colors = colors / 255.0
            uv = None
            if "TEXCOORD_0" in prim["attributes"]:
                uv = _read_accessor(gltf, bin_chunk,
                                    prim["attributes"]["TEXCOORD_0"]).astype(np.float32)
            if colors is None and "material" in prim:
                mat = gltf["materials"][prim["material"]]
                pbr = mat.get("pbrMetallicRoughness", {})
                if "baseColorTexture" in pbr and texture is None:
                    tex = gltf["textures"][pbr["baseColorTexture"]["index"]]
                    img = gltf["images"][tex["source"]]
                    if "bufferView" in img:
                        view = gltf["bufferViews"][img["bufferView"]]
                        o = view.get("byteOffset", 0)
                        texture = _decode_image(bin_chunk[o:o + view["byteLength"]])
                if "baseColorFactor" in pbr:
                    colors = np.tile(np.asarray(pbr["baseColorFactor"][:3],
                                                np.float32), (len(pos), 1))
            all_v.append(pos.astype(np.float32))
            all_f.append(faces + voff)
            all_c.append(colors)
            all_uv.append(uv)
            voff += len(pos)

    if not all_v:
        raise ValueError(f"no triangle meshes in {path}")
    vertices = np.concatenate(all_v, axis=0)
    faces = np.concatenate(all_f, axis=0).astype(np.int32)
    if all(c is not None for c in all_c):
        vcols = np.concatenate(all_c, axis=0)
    else:
        vcols = None
    uvs = np.concatenate(all_uv, axis=0) if all(u is not None for u in all_uv) else None
    return Mesh(vertices, faces, vcols, uvs, texture)


def save_glb(path: str, mesh: Mesh) -> None:
    """Write a Mesh (with optional vertex colors) as a minimal valid GLB."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    v = np.ascontiguousarray(mesh.vertices, np.float32)
    f = np.ascontiguousarray(mesh.faces, np.uint32).reshape(-1)
    chunks = [v.tobytes(), f.tobytes()]
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(chunks[0]), "target": 34962},
        {"buffer": 0, "byteOffset": len(chunks[0]), "byteLength": len(chunks[1]),
         "target": 34963},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3",
         "min": v.min(0).tolist(), "max": v.max(0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": len(f), "type": "SCALAR"},
    ]
    attributes = {"POSITION": 0}
    if mesh.vertex_colors is not None:
        c = np.ascontiguousarray(np.clip(mesh.vertex_colors, 0, 1), np.float32)
        if c.shape[1] == 3:
            c = np.concatenate([c, np.ones((len(c), 1), np.float32)], axis=1)
        off = sum(len(b) for b in chunks)
        chunks.append(c.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(chunks[-1]),
                      "target": 34962})
        accessors.append({"bufferView": 2, "componentType": 5126, "count": len(c),
                          "type": "VEC4"})
        attributes["COLOR_0"] = 2
    binary = b"".join(chunks)
    binary += b"\x00" * ((-len(binary)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "genpc_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attributes, "indices": 1,
                                     "mode": 4}]}],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf, separators=(",", ":")).encode("utf-8")
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(binary)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2, total))
        fh.write(struct.pack("<II", len(js), 0x4E4F534A))
        fh.write(js)
        fh.write(struct.pack("<II", len(binary), 0x004E4942))
        fh.write(binary)


def sample_mesh_surface(mesh: Mesh, num_points: int,
                        rng: Optional[np.random.Generator] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling with barycentric color interpolation.

    Equivalent of trimesh ``mesh.sample`` + the barycentric color blend in
    the reference (utils/dataUtils.py:226-247).
    Returns (points [N,3] float32, colors [N,3] float32 in [0,1]).
    """
    rng = rng or np.random.default_rng(0)
    mesh = mesh.with_baked_colors()
    areas = mesh.face_areas()
    probs = areas / max(areas.sum(), 1e-12)
    face_idx = rng.choice(len(mesh.faces), size=num_points, p=probs)
    tri = mesh.vertices[mesh.faces[face_idx]]            # [N,3,3]
    col = mesh.vertex_colors[mesh.faces[face_idx]]       # [N,3,3]
    r1, r2 = rng.random((2, num_points, 1)).astype(np.float32)
    s1 = np.sqrt(r1)
    bary = np.concatenate([1 - s1, s1 * (1 - r2), s1 * r2], axis=1)  # [N,3]
    pts = np.einsum("nk,nkd->nd", bary, tri)
    cols = np.clip(np.einsum("nk,nkd->nd", bary, col), 0, 1)
    return pts.astype(np.float32), cols.astype(np.float32)


def glb_to_points(path: str, num_points: int = 16384,
                  down_sample: Optional[float] = None,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """GLB -> sampled colored point cloud (reference: utils/dataUtils.py:217-250)."""
    mesh = load_glb(path)
    pts, cols = sample_mesh_surface(mesh, num_points,
                                    np.random.default_rng(seed))
    if down_sample:
        from portbench.reference.plain.ops.voxel import voxel_down_sample
        pts, cols = voxel_down_sample(pts, down_sample, colors=cols)
    return pts, cols

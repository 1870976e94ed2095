"""PLY point-cloud IO in pure numpy (counterpart of genpc_tpu/io/ply.py).

Covers what the reference uses open3d for: reading the redwood/waymo
binary-double clouds (reference: utils/dataUtils.py:174-189 ``load_xyz``)
and writing fused/colored clouds (reference: utils/dataUtils.py:162-171
``save_ply_xyzrgb``/``save_ply_xyz``).  Output format matches open3d's
writer (binary_little_endian, double coordinates, uchar colors) so files
round-trip between the two frameworks.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Tuple

import numpy as np

from portbench.reference.plain.ops.voxel import voxel_down_sample

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f) -> Tuple[dict, str]:
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype_str)])
    cur = None
    while True:
        line = f.readline().decode("ascii").strip()
        if line == "end_header":
            break
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "comment":
            continue
        elif parts[0] == "element":
            cur = (parts[1], int(parts[2]), [])
            elements.append(cur)
        elif parts[0] == "property":
            if parts[1] == "list":
                cur[2].append((parts[-1], ("list", parts[2], parts[3])))
            else:
                cur[2].append((parts[-1], parts[1]))
    return {"elements": elements}, fmt


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY point cloud -> (points float64 [N,3], colors [N,3] in [0,1] or None)."""
    with open(path, "rb") as f:
        header, fmt = _parse_header(f)
        body = f.read()
    vert = next(e for e in header["elements"] if e[0] == "vertex")
    _, count, props = vert
    names = [p[0] for p in props]
    if any(isinstance(p[1], tuple) for p in props):
        raise ValueError("list properties on vertex element are unsupported")
    if fmt == "ascii":
        txt = body.decode("ascii").split()
        ncol = len(props)
        arr = np.array(txt[: count * ncol], dtype=np.float64).reshape(count, ncol)
        cols = {n: arr[:, i] for i, n in enumerate(names)}
    else:
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(n, endian + _PLY_DTYPES[t]) for n, t in props])
        rec = np.frombuffer(body, dtype=dtype, count=count)
        cols = {n: rec[n] for n in names}
    pts = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    colors = None
    if all(k in cols for k in ("red", "green", "blue")):
        colors = np.stack([cols["red"], cols["green"], cols["blue"]], axis=1).astype(np.float64)
        # uchar colors -> [0,1]
        tname = dict(props)["red"]
        if _PLY_DTYPES.get(tname, "f8").startswith(("u", "i")):
            colors = colors / 255.0
    return pts, colors


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Write a binary_little_endian PLY (double xyz [+ uchar rgb]), open3d-compatible."""
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = _io.BytesIO()
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        "comment Created by genpc_tpu_torch",
        f"element vertex {n}",
        "property double x",
        "property double y",
        "property double z",
    ]
    if colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    buf.write(("\n".join(lines) + "\n").encode("ascii"))
    if colors is None:
        buf.write(points.astype("<f8").tobytes())
    else:
        colors = np.asarray(colors, dtype=np.float64)
        if colors.max(initial=0.0) <= 1.0 + 1e-6:
            colors = colors * 255.0
        cu8 = np.clip(np.round(colors), 0, 255).astype("u1")
        rec = np.empty(n, dtype=[("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
                                 ("r", "u1"), ("g", "u1"), ("b", "u1")])
        rec["x"], rec["y"], rec["z"] = points.T
        rec["r"], rec["g"], rec["b"] = cu8.T
        buf.write(rec.tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_xyz(path: str, down_sample: Optional[float] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Load points + colors; coordinate-derived fallback colors like the reference.

    Mirrors reference utils/dataUtils.py:174-189: if the file has no (or
    all-zero) colors, synthesize colors from normalized coordinates.
    Optional voxel downsample mirrors the ``down_sample`` argument.
    """
    pts, colors = load_ply(path)
    if down_sample:
        pts, colors = voxel_down_sample(pts, down_sample, colors=colors)
    if colors is None or np.allclose(colors, 0):
        span = pts.max(axis=0) - pts.min(axis=0) + 1e-8
        colors = np.clip((pts - pts.min(axis=0)) / span, 0, 1)
    return pts.astype(np.float32), colors.astype(np.float32)

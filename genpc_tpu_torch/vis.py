"""Headless debug visualization: point clouds, meshes, boxes, arrows -> PNG
(counterpart of genpc_tpu/vis.py; numpy and matplotlib on the host).

A stand-in for the reference's VTK debug toolkit
(reference: utils/vtk_basic.py — ``vis_actors_vtk`` :172,
``get_colorful_pc_actor_vtk`` :431, ``get_pc_actor_vtk`` :488,
``get_mesh_actor_vtk`` :531, ``get_bbox_line_actor`` :797,
``get_arrow_actors`` :876, multi-renderer grids ``vis_renderers`` :317).
That module drives an interactive OpenGL window; here the same
actor-composition API renders through matplotlib's Agg backend (imported
when a scene is drawn) to PNG files instead.  The API mirrors the
reference's shape: build actors, pass them to ``vis_actors`` (optionally
a grid of scenes via ``vis_scenes``), get an image.

Only for debugging/inspection — nothing in the pipeline imports this.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ----------------------------------------------------------------- actors

@dataclass
class PointsActor:
    xyz: np.ndarray                       # [N,3]
    colors: Optional[np.ndarray] = None   # [N,3] in [0,1] or a single color
    point_size: float = 3.0
    opacity: float = 0.8
    colormap: str = "viridis"             # used when colors is None


@dataclass
class MeshActor:
    vertices: np.ndarray                  # [V,3]
    faces: np.ndarray                     # [F,3]
    vertex_colors: Optional[np.ndarray] = None
    color: Tuple[float, float, float] = (0.75, 0.75, 0.78)
    opacity: float = 1.0


@dataclass
class BoxActor:
    """Axis-aligned or z-rotated box (reference xyzwhl+theta convention,
    vtk_basic.py:797 get_bbox_line_actor box=[x,y,z,w,h,l,theta])."""
    box: np.ndarray                       # [7] or [6]
    color: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    width: float = 1.5


@dataclass
class ArrowActor:
    start: np.ndarray                     # [3]
    vector: np.ndarray                    # [3]
    color: Tuple[float, float, float] = (1.0, 0.0, 0.0)


def colorful_pc_actor(pc: np.ndarray, point_colors=None, point_size=3.0,
                      opacity=0.3, colormap="crest") -> PointsActor:
    """get_colorful_pc_actor_vtk parity: height-colored cloud by default."""
    cmap = {"crest": "viridis", "crest_r": "viridis_r"}.get(colormap,
                                                            colormap)
    return PointsActor(np.asarray(pc), point_colors, point_size, opacity,
                       colormap=cmap)


def pc_actor(pc: np.ndarray, color=(0, 0, 1), opacity=1.0,
             point_size=7.0) -> PointsActor:
    """get_pc_actor_vtk parity: single-color cloud."""
    col = np.broadcast_to(np.asarray(color, np.float32), (len(pc), 3))
    return PointsActor(np.asarray(pc), col.copy(), point_size, opacity)


def _box_corners(box: np.ndarray) -> np.ndarray:
    box = np.asarray(box, np.float64)
    c = box[:3]
    w, h, l = box[3:6]
    theta = box[6] if len(box) > 6 else 0.0
    dx = np.array([-1, 1, 1, -1, -1, 1, 1, -1]) * w / 2
    dy = np.array([-1, -1, 1, 1, -1, -1, 1, 1]) * h / 2
    dz = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * l / 2
    pts = np.stack([dx, dy, dz], axis=1)
    rot = np.array([[np.cos(theta), -np.sin(theta), 0],
                    [np.sin(theta), np.cos(theta), 0],
                    [0, 0, 1]])
    return pts @ rot.T + c


_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
              (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]


# ------------------------------------------------------------------ scene

def _draw_scene(ax, actors: Sequence, title: Optional[str] = None):
    all_pts = []
    for a in actors:
        if isinstance(a, PointsActor):
            p = np.asarray(a.xyz)
            all_pts.append(p)
            if a.colors is not None:
                c = np.asarray(a.colors, np.float32)
                if c.ndim == 1:
                    c = np.broadcast_to(c, (len(p), 3))
                ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=np.clip(c, 0, 1),
                           s=a.point_size, alpha=a.opacity, linewidths=0)
            else:
                ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=p[:, 2],
                           cmap=a.colormap, s=a.point_size,
                           alpha=a.opacity, linewidths=0)
        elif isinstance(a, MeshActor):
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection
            v = np.asarray(a.vertices)
            f = np.asarray(a.faces, np.int64)
            all_pts.append(v)
            tris = v[f]
            if a.vertex_colors is not None:
                fc = np.clip(np.asarray(a.vertex_colors)[f].mean(1), 0, 1)
            else:
                fc = np.clip(np.asarray(a.color), 0, 1)
            coll = Poly3DCollection(tris, facecolors=fc, alpha=a.opacity,
                                    edgecolors="none")
            ax.add_collection3d(coll)
        elif isinstance(a, BoxActor):
            corners = _box_corners(a.box)
            all_pts.append(corners)
            for i, j in _BOX_EDGES:
                ax.plot(*zip(corners[i], corners[j]), color=a.color,
                        linewidth=a.width)
        elif isinstance(a, ArrowActor):
            s = np.asarray(a.start, np.float64)
            v = np.asarray(a.vector, np.float64)
            ax.quiver(s[0], s[1], s[2], v[0], v[1], v[2], color=a.color)
            all_pts.append(np.stack([s, s + v]))
        else:
            raise TypeError(f"unknown actor type {type(a).__name__}")
    if all_pts:
        pts = np.concatenate(all_pts)
        lo, hi = pts.min(0), pts.max(0)
        center = (lo + hi) / 2
        r = max(float((hi - lo).max()) / 2, 1e-6)
        ax.set_xlim(center[0] - r, center[0] + r)
        ax.set_ylim(center[1] - r, center[1] + r)
        ax.set_zlim(center[2] - r, center[2] + r)
    ax.set_box_aspect((1, 1, 1))
    if title:
        ax.set_title(title, fontsize=9)


def vis_actors(actors: Sequence, save_path: Optional[str] = None,
               info: Optional[str] = None, elev: float = 20.0,
               azim: float = -60.0, figsize: float = 6.0) -> np.ndarray:
    """vis_actors_vtk parity: render one scene, return an RGB uint8 image
    (and write it to save_path if given)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(figsize, figsize), dpi=110)
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elev, azim=azim)
    _draw_scene(ax, actors, title=info)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return img


def vis_scenes(scenes: Sequence[Sequence], save_path: Optional[str] = None,
               titles: Optional[Sequence[str]] = None, cols: int = 3,
               elev: float = 20.0, azim: float = -60.0) -> np.ndarray:
    """vis_renderers parity: a grid of scenes side by side."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    n = len(scenes)
    cols = min(cols, max(n, 1))
    rows = -(-n // cols)
    fig = plt.figure(figsize=(4 * cols, 4 * rows), dpi=110)
    for i, actors in enumerate(scenes):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        ax.view_init(elev=elev, azim=azim)
        _draw_scene(ax, actors,
                    title=titles[i] if titles and i < len(titles) else None)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    if save_path:
        fig.savefig(save_path)
    plt.close(fig)
    return img

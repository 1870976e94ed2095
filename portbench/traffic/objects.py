"""Seeded synthetic partial/GT object pairs in the Redwood file layout.

Frozen copy of ``genpc_tpu_torch/io/synthetic_data.py`` (``make_object``
and ``write_dataset``, at commit 15bea8d), so that the benchmark's inputs
stay the same whatever later changes make to the port's generator.  The
LiDAR scans of the original are left out: no cell uses them yet.

Each object is a mirror-symmetric compound shape (a box body, a top
part, four legs, two side arms), surface-sampled by area, normalised into
[-0.5, 0.5]³ and turned about the vertical axis by a random angle.  Its
GT is the full surface sample; its partial is the GT cut by a random
vertical half-space (55-75 % of the points kept), the way a single scan
misses the far side.  Colours are per part, from the seed.

``write_dataset`` writes ``<flag>.ply`` and ``GT/<flag>.ply`` per flag,
which ``run_batched`` reads like the Redwood scans.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from portbench.reference.plain.io.ply import save_ply


def _box(rng, n, c, h):
    """n points uniform on the surface of the box centre c, half-size h."""
    areas = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]] * 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    u = rng.uniform(-1, 1, (n, 3)) * h
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    u[np.arange(n), axis] = sign * h[axis]
    return u + c


def _sphere(rng, n, c, r):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True) * r + c


def _cylinder(rng, n, c, r, hh):
    """Side surface of a vertical cylinder (axis y), half-height hh."""
    a = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(a), rng.uniform(-hh, hh, n),
                     r * np.sin(a)], 1) + c


def make_object(seed: int, n_gt: int = 163840
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(partial, partial_rgb, gt, gt_rgb), float32, symmetric about a
    vertical plane."""
    rng = np.random.default_rng(seed)
    hx, hy, hz = rng.uniform([0.25, 0.10, 0.15], [0.40, 0.22, 0.30])
    parts = [("box", (np.zeros(3), np.array([hx, hy, hz])))]
    top = rng.uniform(0.08, 0.16)
    if rng.random() < 0.5:
        parts.append(("sphere", (np.array([0.0, hy + top, 0.0]), top)))
    else:
        parts.append(("box", (np.array([0.0, hy + top, -hz * 0.5]),
                              np.array([hx * 0.8, top, 0.03]))))
    leg_r, leg_h = rng.uniform(0.02, 0.05), rng.uniform(0.12, 0.25)
    for sx in (-1, 1):          # mirror pairs across x = 0
        for sz in (-1, 1):
            parts.append(("cyl", (np.array([sx * hx * 0.8, -hy - leg_h,
                                            sz * hz * 0.8]), leg_r, leg_h)))
        arm = np.array([0.04, rng.uniform(0.05, 0.1), hz * 0.9])
        parts.append(("box", (np.array([sx * (hx + arm[0]), hy, 0.0]), arm)))

    def area(kind, args):
        if kind == "box":
            h = args[1]
            return 8 * (h[0] * h[1] + h[1] * h[2] + h[0] * h[2])
        if kind == "sphere":
            return 4 * np.pi * args[1] ** 2
        return 4 * np.pi * args[1] * args[2]

    areas = np.array([area(k, a) for k, a in parts])
    counts = rng.multinomial(n_gt, areas / areas.sum())
    pts, cols = [], []
    for (kind, args), n in zip(parts, counts):
        fn = {"box": _box, "sphere": _sphere, "cyl": _cylinder}[kind]
        p = fn(rng, n, *args)
        base = rng.uniform(0.2, 0.9, 3)
        pts.append(p)
        cols.append(np.clip(base + rng.normal(0, 0.03, (n, 3)), 0, 1))
    gt = np.concatenate(pts)
    gt_rgb = np.concatenate(cols)
    # normalise into [-0.5, 0.5]^3, then turn about the vertical axis
    gt -= (gt.max(0) + gt.min(0)) / 2
    gt /= (gt.max(0) - gt.min(0)).max()
    th = rng.uniform(0, np.pi)
    rot = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                    [np.sin(th), 0, np.cos(th)]])
    gt = gt @ rot.T
    # the scan: a vertical half-space keeps 55-75 % of the surface
    phi = rng.uniform(0, 2 * np.pi)
    proj = gt @ np.array([np.cos(phi), 0.0, np.sin(phi)])
    keep = proj <= np.quantile(proj, rng.uniform(0.55, 0.75))
    return (gt[keep].astype(np.float32), gt_rgb[keep].astype(np.float32),
            gt.astype(np.float32), gt_rgb.astype(np.float32))


def write_dataset(root: str, flags: List[str], seed: int = 0,
                  n_gt: int = 163840) -> None:
    """Write ``root/<flag>.ply`` (partial) and ``root/GT/<flag>.ply``."""
    for i, flag in enumerate(flags):
        part, part_rgb, gt, gt_rgb = make_object(seed * 1000 + i, n_gt)
        save_ply(os.path.join(root, f"{flag}.ply"), part, part_rgb)
        save_ply(os.path.join(root, "GT", f"{flag}.ply"), gt, gt_rgb)


def write(root: str, traffic: dict, seed: int) -> List[str]:
    """The benchmark's call (not part of the frozen copy): the traffic
    mix's ``objects`` objects with ``gt_points`` GT points each, flags
    ``00000``, ``00001``, ..., written under ``root``; returns the flags."""
    flags = [f"{i:05d}" for i in range(int(traffic["objects"]))]
    write_dataset(root, flags, seed=seed, n_gt=int(traffic["gt_points"]))
    return flags

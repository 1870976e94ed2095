"""Deterministic model-free backends for the three generative stages
(counterpart of genpc_tpu/models/synthetic.py).

  * ``SyntheticDepth2Image`` — depth -> a shaded pseudo-RGB photo (the
    depth map as a lit height field tinted by a category hue);
  * ``SyntheticRembg`` — background matte from the near-black background;
  * ``SyntheticImage23D`` — completion by symmetry: find the object's
    vertical mirror plane by sweeping azimuths and offsets (every plane's
    mirror-to-cloud nearest-neighbour search is one batched launch of
    kernel K1), mirror the cloud, keep mirrored points inside the scan's
    visual hull, densify by jitter.  Its output lives in the input frame.

Host parts are numpy, with the reference's ``np.random.default_rng``
draws kept byte-identical so both packages see the same inputs.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch

from portbench.reference.plain.categories import get_category
from portbench.reference.plain.ops.chamfer import _nn, nearest_neighbor
from portbench.reference.plain.runtime import resolve_device


def _device(cfg) -> torch.device:
    return resolve_device(cfg.get("device", "cpu") if cfg is not None
                          else "cpu")


def _sweep_planes_batched(p, normals, offsets, new_thresh2, k: int,
                          device: torch.device | str = "cpu"):
    """Score every (azimuth, offset) mirror plane of every object.

    p [B,N,3]; normals [B,A,3]; offsets [B,A,O]; new_thresh2 [B].
    Returns (scores [B,A,O] = mean of the k smallest NN distances of
    mirror(p) into p, new_counts [B,A,O] = mirrored points farther than
    sqrt(new_thresh2) from p)."""
    f32 = dict(dtype=torch.float32, device=device)
    P = torch.as_tensor(np.asarray(p), **f32)                 # [B,S,3]
    nrm = torch.as_tensor(np.asarray(normals), **f32)         # [B,A,3]
    off = torch.as_tensor(np.asarray(offsets), **f32)         # [B,A,O]
    thr = torch.as_tensor(np.asarray(new_thresh2), **f32)     # [B]
    B, S, _ = P.shape
    A, O = off.shape[1], off.shape[2]
    dots = (P[:, None, :, 0] * nrm[:, :, None, 0]
            + P[:, None, :, 1] * nrm[:, :, None, 1]
            + P[:, None, :, 2] * nrm[:, :, None, 2])          # [B,A,S]
    d = dots[:, :, None, :] - off[..., None]                  # [B,A,O,S]
    mir = P[:, None, None] - (2.0 * d)[..., None] * nrm[:, :, None, None, :]
    y_index = torch.arange(B, dtype=torch.int32, device=device) \
        .repeat_interleave(A * O)
    d2, _ = _nn(mir.reshape(B * A * O, S, 3), P, y_index)
    d2 = d2.reshape(B, A, O, S)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    score = torch.topk(dist, k, dim=-1, largest=False,
                       sorted=True).values.mean(-1)
    new = (d2 > thr[:, None, None, None]).sum(-1)
    return score, new


def _category_hue(flag: str) -> np.ndarray:
    h = int(hashlib.sha1(get_category(flag).encode()).hexdigest()[:6], 16)
    rgb = np.array([(h >> 16) & 255, (h >> 8) & 255, h & 255], np.float32)
    return 0.35 + 0.6 * rgb / 255.0


def _resize_uint8_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H,W] -> uint8 [size,size], bilinear (half-pixel centres,
    antialiased when shrinking), in place of the reference's PIL resize."""
    t = torch.from_numpy(img.astype(np.float32))[None, None]
    r = torch.nn.functional.interpolate(t, size=(size, size),
                                        mode="bilinear", align_corners=False,
                                        antialias=True)
    return np.clip(np.round(r[0, 0].numpy()), 0, 255).astype(np.uint8)


class SyntheticDepth2Image:
    """Depth image [3,H,W] -> plausible RGB [H,W,3] (deterministic)."""

    def __init__(self, cfg=None):
        self.cfg = cfg

    def generate(self, depth: np.ndarray, category_or_flag: str,
                 size: int = 512) -> np.ndarray:
        d = np.asarray(depth, np.float32)
        if d.ndim == 3:
            d = d.mean(axis=0)
        if d.shape[0] != size:
            d = _resize_uint8_bilinear((d * 255).astype(np.uint8),
                                       size).astype(np.float32) / 255.0
        gy, gx = np.gradient(d)
        normal_z = 1.0 / np.sqrt(gx ** 2 + gy ** 2 + 1.0)
        light = np.clip(0.25 + 0.75 * normal_z, 0, 1)
        shade = light * (0.3 + 0.7 * d)
        hue = _category_hue(category_or_flag)
        img = shade[..., None] * hue[None, None, :]
        img = np.where(d[..., None] > 0.02, img, 0.0)
        return np.clip(img, 0, 1).astype(np.float32)


class SyntheticRembg:
    """RGB [H,W,3] -> RGBA [H,W,4]: near-black background becomes alpha 0."""

    def __init__(self, cfg=None, threshold: float = 0.04):
        self.threshold = threshold

    def __call__(self, image: np.ndarray) -> np.ndarray:
        img = np.asarray(image, np.float32)
        if img.shape[-1] == 4:
            return img
        lum = img.max(axis=-1)
        alpha = (lum > self.threshold).astype(np.float32)
        return np.concatenate([img, alpha[..., None]], axis=-1)


class SyntheticImage23D:
    """Partial cloud + viewpoint -> complete cloud by constrained mirroring.

    Mirrored candidates survive only if their projection through the
    Stage-1 camera lands inside the (dilated) silhouette of the partial
    cloud, so geometry the captured view proves empty is never added."""

    #: this backend's completion lives in the input cloud's frame
    output_aligned = True

    def __init__(self, cfg=None, num_points: int | None = None,
                 jitter: float = 0.004, sil_res: int = 128,
                 sil_dilate: int = 2):
        if num_points is None:
            num_points = (int(cfg.get("glb_sample_points", 163840))
                          if cfg is not None else 163840)
        self.num_points = num_points
        self.jitter = jitter
        self.sil_res = sil_res
        self.sil_dilate = sil_dilate
        self.fovy = float(cfg.get("fovy", 49.1)) if cfg is not None else 49.1
        self.device = _device(cfg)

    def _visual_hull_mask(self, partial: np.ndarray, candidates: np.ndarray,
                          viewpoint: np.ndarray) -> np.ndarray:
        """True for candidates projecting inside the partial's silhouette."""
        from portbench.reference.plain.geometry.cameras import Camera, transform_points
        cam = Camera.from_eyes(np.asarray(viewpoint, np.float64)[None],
                               self.fovy, self.sil_res, device=self.device)
        both = torch.as_tensor(np.concatenate([partial, candidates]),
                               dtype=torch.float32, device=self.device)
        t = transform_points(cam, both)[0].cpu().numpy()
        uv = t[:, :2]
        # normalize by the PARTIAL's uv bounds (stage-1 rescale convention)
        np_part = len(partial)
        lo = uv[:np_part].min(0)
        hi = uv[:np_part].max(0)
        span = max((hi - lo).max(), 1e-9)
        px = np.clip(((uv[:, 0] - lo[0]) / span * (self.sil_res - 1)),
                     -1, self.sil_res).astype(np.int64)
        py = np.clip(((uv[:, 1] - lo[1]) / span * (self.sil_res - 1)),
                     -1, self.sil_res).astype(np.int64)
        sil = np.zeros((self.sil_res + 2, self.sil_res + 2), bool)
        sil[py[:np_part] + 1, px[:np_part] + 1] = True
        # dilate the silhouette a few pixels
        for _ in range(self.sil_dilate):
            s = sil.copy()
            s[1:] |= sil[:-1]
            s[:-1] |= sil[1:]
            s[:, 1:] |= sil[:, :-1]
            s[:, :-1] |= sil[:, 1:]
            sil = s
        cx = np.clip(px[np_part:] + 1, 0, self.sil_res + 1)
        cy = np.clip(py[np_part:] + 1, 0, self.sil_res + 1)
        inside_img = (px[np_part:] >= 0) & (px[np_part:] < self.sil_res) \
            & (py[np_part:] >= 0) & (py[np_part:] < self.sil_res)
        return sil[cy, cx] & inside_img

    @staticmethod
    def plan_symmetry_batched(pts_list, n_azimuths: int = 24,
                              sample: int = 4096, trim: float = 0.5,
                              accept_ratio: float = 0.008,
                              device: torch.device | str = "cpu"):
        """Find (normal, offset) symmetry planes for a BATCH of clouds.

        All objects' coarse sweeps (24 azimuths × 13 offsets each) run as
        one nearest-neighbour launch, then all fine sweeps as a second.
        Score(plane) = mean of the smallest ``trim`` fraction of
        NN(mirror(partial) -> partial) distances; acceptance is floored at
        1.5x the cloud's own sampling spacing.  Among acceptable planes the
        one GENERATING the most new geometry wins.  Returns a list of
        (n [3], c) or None per object."""
        from portbench.reference.plain.ops.knn import knn
        B = len(pts_list)
        rng = np.random.default_rng(0)
        ps, cents, exts = [], [], []
        for pts in pts_list:
            idx = rng.choice(len(pts), min(sample, len(pts)), replace=False)
            p = pts[idx]
            if len(p) < sample:   # pad by repetition to the fixed size
                pad = rng.integers(0, len(p), sample - len(p))
                p = np.concatenate([p, p[pad]])
            ps.append(p.astype(np.float32))
            cents.append(pts.mean(axis=0))
            exts.append(float((pts.max(0) - pts.min(0)).max()))
        P = np.stack(ps)                                  # [B,S,3]
        k_keep = max(1, int(sample * trim))

        Pt = torch.as_tensor(P, device=device)
        d_self = np.stack([knn(a, a, 2)[0].cpu().numpy() for a in Pt])
        spacing = np.median(np.sqrt(d_self[:, :, 1]), axis=1)
        accept = np.maximum(accept_ratio * np.asarray(exts), 1.5 * spacing)
        thr2 = (0.02 * np.asarray(exts)) ** 2

        def make_planes(thetas_b):
            """thetas_b [B,A] -> (normals [B,A,3], offsets [B,A,O])."""
            normals = np.stack([np.cos(thetas_b),
                                np.zeros_like(thetas_b),
                                np.sin(thetas_b)], axis=-1)
            base = np.einsum("bad,bd->ba", normals, np.stack(cents))
            offsets = base[..., None] + (np.linspace(-0.15, 0.15, 13)[None,
                                         None, :]
                                         * np.asarray(exts)[:, None, None])
            return normals, offsets

        def sweep(normals, offsets):
            s, n = _sweep_planes_batched(P, normals, offsets, thr2, k_keep,
                                         device)
            return s.cpu().numpy(), n.cpu().numpy()

        thetas = np.tile(np.linspace(0, np.pi, n_azimuths,
                                     endpoint=False)[None], (B, 1))
        normals, offsets = make_planes(thetas)
        scores, news = sweep(normals, offsets)

        jbest = scores.argmin(axis=2)                      # [B,A]
        s_az = np.take_along_axis(scores, jbest[..., None], 2)[..., 0]
        ok = s_az < accept[:, None]
        n_az = np.take_along_axis(news, jbest[..., None], 2)[..., 0]
        gain = np.where(ok, n_az, -1)
        i0 = gain.argmax(axis=1)                           # [B]
        any_ok = ok.any(axis=1)

        # fine azimuth refinement around each winner, re-searching offsets
        th0 = thetas[np.arange(B), i0]
        fine = th0[:, None] + np.linspace(-np.pi / n_azimuths,
                                          np.pi / n_azimuths, 9)[None]
        fnormals, foffsets = make_planes(fine)
        fs, _ = sweep(fnormals, foffsets)
        jf = fs.argmin(axis=2)                             # [B,9]
        fmin = np.take_along_axis(fs, jf[..., None], 2)[..., 0]
        iaz = fmin.argmin(axis=1)                          # [B]
        score = fmin[np.arange(B), iaz]

        plans = []
        for b in range(B):
            if not any_ok[b] or score[b] > accept[b]:
                plans.append(None)
            else:
                plans.append((fnormals[b, iaz[b]],
                              float(foffsets[b, iaz[b], jf[b, iaz[b]]])))
        return plans

    def _apply_mirror(self, pts, cols, plan):
        """Mirror the full cloud across the plan's plane, drop duplicates."""
        if plan is None:
            return None, None
        n, c = plan
        extent = float((pts.max(0) - pts.min(0)).max())
        d = (pts @ n) - c
        mirrored = pts - 2.0 * d[:, None] * n[None, :]
        f32 = dict(dtype=torch.float32, device=self.device)
        d2, _ = nearest_neighbor(torch.as_tensor(mirrored, **f32),
                                 torch.as_tensor(pts, **f32))
        new = d2.cpu().numpy() > (0.01 * extent) ** 2
        return mirrored[new].astype(np.float32), cols[new]

    def complete_with_plan(self, flag: str, partial_xyz, partial_rgb,
                           viewpoint, plan) -> Tuple[np.ndarray, np.ndarray]:
        """Assemble the completion from a precomputed symmetry plan."""
        pts = np.asarray(partial_xyz, np.float32)
        cols = (np.asarray(partial_rgb, np.float32)
                if partial_rgb is not None else np.full_like(pts, 0.6))
        if viewpoint is None:
            viewpoint = pts.mean(axis=0) + np.array([0, 0, 1], np.float32)
        mirrored, mir_cols = self._apply_mirror(pts, cols, plan)
        return self._assemble(flag, pts, cols, mirrored, mir_cols, viewpoint)

    def __call__(self, flag: str, image_nobg: np.ndarray,
                 partial_xyz: np.ndarray | None = None,
                 partial_rgb: np.ndarray | None = None,
                 viewpoint: np.ndarray | None = None,
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """One object's completion (the per-object stage 2): its own
        symmetry search, then the mirror and the visual-hull filter."""
        if partial_xyz is None:
            raise ValueError("synthetic image23d needs the partial cloud")
        pts = np.asarray(partial_xyz, np.float32)
        plan = self.plan_symmetry_batched([pts], device=self.device)[0]
        return self.complete_with_plan(flag, pts, partial_rgb, viewpoint,
                                       plan)

    def _assemble(self, flag, pts, cols, mirrored, mir_cols, viewpoint
                  ) -> Tuple[np.ndarray, np.ndarray]:
        if mirrored is not None and len(mirrored):
            keep = self._visual_hull_mask(pts, mirrored,
                                          np.asarray(viewpoint, np.float64))
            mirrored, mir_cols = mirrored[keep], mir_cols[keep]
        if mirrored is None or len(mirrored) == 0:
            mirrored = pts[:0]
            mir_cols = cols[:0]
        all_pts = np.concatenate([pts, mirrored], axis=0)
        all_cols = np.concatenate([cols, mir_cols], axis=0)
        rng = np.random.default_rng(
            int(hashlib.sha1(flag.encode()).hexdigest()[:8], 16))
        if len(all_pts) < self.num_points:
            extra = self.num_points - len(all_pts)
            idx = rng.integers(0, len(all_pts), extra)
            scale = float(np.abs(all_pts - all_pts.mean(0)).max())
            noise = rng.normal(0, self.jitter * scale,
                               (extra, 3)).astype(np.float32)
            all_pts = np.concatenate([all_pts, all_pts[idx] + noise], axis=0)
            all_cols = np.concatenate([all_cols, all_cols[idx]], axis=0)
        else:
            idx = rng.choice(len(all_pts), self.num_points, replace=False)
            all_pts, all_cols = all_pts[idx], all_cols[idx]
        return all_pts.astype(np.float32), np.clip(all_cols, 0, 1)

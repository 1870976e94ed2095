"""Stage 3 — registration & fusion of one object (counterpart of
genpc_tpu/pipeline/registration.py; reference: reg_xyz.py:99-225).

``reg``:
  1. optional differentiable pose init (``registration/pose_optim``: 4
     starts of Adam through the slot renderer, kernels K4/K5, with
     Chamfer terms, K1, and two FPS subsamples, K2), inverted;
  2. normalise the generated complete cloud to range 0.5;
  3. coarse isotropic scale sweep, 11 scales × ICP (K1);
  4. fine per-axis 10×10×10 scale grid, then ICP at the winner (K1);
  5. undo every transform back into the input frame, in the reference's
     order;
  6. the final refine in the input frame (anisotropic ICP by default);
  7. fuse: NN dedup at squared distance 1e-4 (K1), concat, FPS 20,000
     (K2), statistical denoise std 2.5.

Host preparation (voxel downsamples, ``resample_fixed`` with its fixed
seed, the undo chain) is numpy in the reference's order, so both
packages hand the same clouds to every device step.  The work runs on
``cfg.device``.  Weights: none; the pose optimiser starts from its four
fixed rotations.  A mesh-producing backend's completion (a
``complete_mesh``) is sampled on its surface first (io/glb), and an
InstantMesh completion is turned into the input's axes (x 90°, then y
90°) after the partial's statistical outliers are removed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from portbench.reference.plain.geometry.normalize import normalize_points
from portbench.reference.plain.geometry.transforms import get_rotate_matrix
from portbench.reference.plain.io.glb import sample_mesh_surface
from portbench.reference.plain.ops.outliers import remove_statistical_outliers
from portbench.reference.plain.ops.voxel import voxel_down_sample
from portbench.reference.plain.pipeline.artifacts import ObjectArtifacts, Workspace
from portbench.reference.plain.registration import icp as _icp
from portbench.reference.plain.registration.fusion import fuse_clouds
from portbench.reference.plain.registration.pose_optim import object_pose_optimization
from portbench.reference.plain.runtime import resolve_device

# fixed sizes of the device steps' inputs; overridable per config
# (pose_partial_points / pose_complete_points / icp_points)
POSE_PARTIAL_N = 2048
POSE_COMPLETE_N = 2048
ICP_N = 2048


def resample_fixed(pts: np.ndarray, n: int,
                   cols: Optional[np.ndarray] = None, seed: int = 0
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Exact-size resampling.

    Growing keeps EVERY original point and pads with resampled duplicates
    (plain choice-with-replacement silently drops ~1/e of the unique
    points); shrinking is choice without replacement.
    """
    pts = np.asarray(pts)
    rng = np.random.default_rng(seed)
    if len(pts) == n:
        return pts, cols
    if len(pts) < n:
        idx = np.concatenate([np.arange(len(pts)),
                              rng.integers(0, len(pts), n - len(pts))])
    else:
        idx = rng.choice(len(pts), n, replace=False)
    return pts[idx], (None if cols is None else np.asarray(cols)[idx])


def _apply(T: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)


_REFINE = {"anisotropic": _icp.anisotropic_icp, "affine": _icp.affine_icp,
           "similarity": _icp.similarity_icp}


def reg(cfg, art: ObjectArtifacts, cd_inv_weight: float = 0.5,
        diff_init: bool = True, reg_fine_xyz: bool = False,
        verbose: bool = True) -> ObjectArtifacts:
    if art.color_xyz is None:
        raise FileNotFoundError(
            f"{art.flag}: color_point missing — run Stage 2 first "
            f"(reference parity: reg_xyz.py:103-105)")
    if art.complete_mesh is None and art.complete_xyz is None:
        raise FileNotFoundError(
            f"{art.flag}: generated complete shape missing "
            f"(reference parity: reg_xyz.py:106-108)")
    device = resolve_device(cfg.device)

    src = np.asarray(art.color_xyz, np.float32)
    src_rgb = (np.asarray(art.color_rgb, np.float32)
               if art.color_rgb is not None else np.full_like(src, 0.5))

    n_samples = int(cfg.get("glb_sample_points", 163840))
    if art.complete_mesh is not None:
        tgt, tgt_rgb = sample_mesh_surface(art.complete_mesh, n_samples)
    else:
        tgt, tgt_rgb = resample_fixed(art.complete_xyz, n_samples,
                                      art.complete_rgb)
        tgt = tgt.astype(np.float32)
        tgt_rgb = (tgt_rgb.astype(np.float32) if tgt_rgb is not None
                   else np.full_like(tgt, 0.5))
    fused_n = int(cfg.get("fused_points", 20000))

    # a completion its backend declares aligned skips registration when
    # the config trusts the declaration (no reference counterpart)
    if art.complete_aligned and bool(cfg.get("trust_aligned_completion",
                                             False)):
        fused, fused_rgb = fuse_clouds(
            src, tgt, src_rgb, tgt_rgb, num_points=fused_n,
            distance_threshold=1e-4, denoise_std_ratio=2.5, device=device)
        art.fused_xyz = fused.astype(np.float32)
        art.fused_rgb = fused_rgb
        if cfg.save:
            Workspace(cfg.output_path, cfg.generative_model).save_fused(art)
        return art

    pose_partial_n = int(cfg.get("pose_partial_points", POSE_PARTIAL_N))
    pose_complete_n = int(cfg.get("pose_complete_points", POSE_COMPLETE_N))
    icp_n = int(cfg.get("icp_points", ICP_N))
    fine_steps = int(cfg.get("fine_scale_steps", 10))

    # 1. differentiable pose init (reference: reg_xyz.py:109-122)
    diff_transform = np.eye(4, dtype=np.float32)
    if diff_init:
        pv, pvc = voxel_down_sample(src, 0.02, src_rgb)
        t120, t120c = resample_fixed(tgt, min(120000, len(tgt)), tgt_rgb)
        cv, cvc = voxel_down_sample(t120, 0.02, t120c)
        pv, pvc = resample_fixed(pv, pose_partial_n, pvc)
        cv, cvc = resample_fixed(cv, pose_complete_n, cvc)
        T = object_pose_optimization(
            cv, cvc, pv, pvc, radius=0.02,
            lr=float(cfg.get("pose_lr", 0.01)),
            iters=int(cfg.get("pose_iters", 200)),
            render_size=int(cfg.get("pose_render_size", 224)),
            coarse_frac=float(cfg.get("pose_coarse_frac", 0.7)),
            prune_to=int(cfg.get("pose_prune_starts", 0)), device=device)
        diff_transform = np.linalg.inv(T).astype(np.float32)

    src_w = _apply(diff_transform, src)

    # 2. normalise the complete cloud; backend orientation fix
    tgt_n, _, _ = normalize_points(tgt, range=0.5)
    tgt_n = np.asarray(tgt_n, np.float32)
    if cfg.generative_model in ("instantmesh",):
        src_w_f, src_rgb_f = remove_statistical_outliers(
            src_w, src_rgb, nb_neighbors=20, std_ratio=1.5, device=device)
        src_w, src_rgb = src_w_f.astype(np.float32), src_rgb_f
        tgt_n = (tgt_n @ get_rotate_matrix("x", 90).T).astype(np.float32)
        tgt_n = (tgt_n @ get_rotate_matrix("y", 90).T).astype(np.float32)

    # 3. coarse isotropic sweep on voxel-0.03 downsamples
    src_d, _ = voxel_down_sample(src_w, 0.03)
    tgt_d, _ = voxel_down_sample(tgt_n, 0.03)
    src_d, _ = resample_fixed(src_d, icp_n)
    tgt_d, _ = resample_fixed(tgt_d, icp_n)
    best_scale, coarse_T, coarse_loss = _icp.coarse_scale_sweep(
        src_d.astype(np.float32), tgt_d.astype(np.float32),
        cd_inv_weight=cd_inv_weight, device=device)
    if verbose:
        print(f"  [{art.flag}] coarse scale {best_scale:.2f} "
              f"loss {coarse_loss:.4f}")

    # 4. fine per-axis grid (reference: reg_xyz.py:176-191)
    if reg_fine_xyz:
        src_w = _apply(coarse_T, src_w)
        if cfg.dataset in ("pcn", "kitti"):
            fine_src, _ = resample_fixed(src_w, icp_n)
            td, _ = voxel_down_sample(tgt_n, 0.04)
            fine_tgt, _ = resample_fixed(td, icp_n)
        else:  # redwood and everything else
            sd, _ = voxel_down_sample(src_w, 0.03)
            fine_src, _ = resample_fixed(sd, icp_n)
            td, _ = voxel_down_sample(tgt_n, 0.03)
            fine_tgt, _ = resample_fixed(td, icp_n)
        S, fine_loss, fine_T = _icp.iterative_scale_search(
            fine_src.astype(np.float32), fine_tgt.astype(np.float32),
            scale_ranges=((0.8, 1.2), (0.8, 1.2), (0.8, 1.2)),
            scale_steps=fine_steps, cd_inv_weight=cd_inv_weight,
            device=device)
        if verbose:
            print(f"  [{art.flag}] fine scales {np.diag(S)[:3].round(3)} "
                  f"loss {fine_loss:.4f}")
        # undo (reference order: inv(S), then inv(fine_T); reg_xyz.py:194-199)
        tgt_n = _apply(np.linalg.inv(S), tgt_n)
        tgt_n = _apply(np.linalg.inv(fine_T), tgt_n)
        src_w = _apply(np.linalg.inv(coarse_T), src_w)

    # 5. back to the input frame (reg_xyz.py:201-206)
    tgt_n = _apply(np.linalg.inv(coarse_T), tgt_n)
    tgt_n = _apply(np.linalg.inv(diff_transform), tgt_n)
    src_w = _apply(np.linalg.inv(diff_transform), src_w)

    # 5b. final snap partial -> complete in the input frame (no reference
    # counterpart): removes the scale grids' few-percent residual
    if bool(cfg.get("final_icp_refine", True)):
        fn = _REFINE[str(cfg.get("final_refine", "anisotropic"))]
        sd, _ = voxel_down_sample(src_w, 0.03)
        td, _ = voxel_down_sample(tgt_n, 0.03)
        sd, _ = resample_fixed(sd, icp_n)
        td, _ = resample_fixed(td, icp_n)
        f32 = dict(dtype=torch.float32, device=device)
        Tr = fn(torch.as_tensor(sd, **f32)[None],
                torch.as_tensor(td, **f32)[None], 0.05)[0].cpu().numpy()
        tgt_n = _apply(np.linalg.inv(Tr), tgt_n)

    # 6. fuse (reg_xyz.py:210-223)
    fused, fused_rgb = fuse_clouds(
        src_w, tgt_n, src_rgb, tgt_rgb, num_points=fused_n,
        distance_threshold=1e-4, denoise_std_ratio=2.5, device=device)
    art.fused_xyz = fused.astype(np.float32)
    art.fused_rgb = fused_rgb
    if cfg.save:
        Workspace(cfg.output_path, cfg.generative_model).save_fused(art)
    return art

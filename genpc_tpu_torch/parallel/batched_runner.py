"""Object-batched pipeline execution (counterpart of
genpc_tpu/parallel/batched_runner.py).

``run_batched`` loads the objects, runs stage 1 over the whole batch
(``make_stage1_core``), generates images, runs stage 2, registers each
completion to its partial and fuses the two (``batched_reg``), and
scores every object with CD-ℓ1 and auction EMD after FPS to
``metric_points``.  ``run_batched_lidar`` runs the same stages over
Waymo-layout LiDAR scans, which have no GT: it scores each object by
the partial->fused unidirectional Hausdorff distance (UHD), and with
``holdout_wedge_deg`` withholds an azimuthal wedge of each scan and
scores the held-out points against the fused cloud.  With
``inpainter`` 'flux', 'DDNM' or 'cv2' stage 1 paints each object's
depth with that inpainter (both runners free a FLUX or DDNM inpainter
once stage 1 is done), and the RMBG matting backend is freed after stage
2 with the image-to-3D backend.

Stage 3 registers by default (``trust_aligned_completion=False``, the
reference's headline path): batched pose optimisation (4 starts × 200
Adam steps through the slot renderer, kernels K4/K5, and Chamfer terms,
K1), the coarse ICP sweep over 11 scales, the 10³ per-axis fine grid,
the anisotropic final refine, then dedup, FPS to ``fused_points`` (K2)
and the outlier mask.  With ``trust_aligned_completion=True`` a
completion that its backend declares aligned skips registration (the
fast path).  Kernels K1 (Chamfer NN), K2 (FPS), K3 (EMD bid), K4/K5
(slot splat) carry the hot loops.  Host preparation (voxel downsample,
fixed resampling, the undo chain of transforms) is numpy, as in the
reference.

A mesh-producing image-to-3D backend's completion (InstantMesh) is
sampled on its surface, ``glb_sample_points`` points (io/glb), before
registration.

With a device mesh (``cfg.mesh_shape``, ``parallel.mesh.get_mesh``) the
object axis is split over ``dp``: both runners pad the batch to a
multiple of dp with copies of the last object (whose results are
dropped), stage 1, every registration step, the fusion and the metric's
FPS, chamfer and EMD (or the UHD) run shard by shard on the dp devices,
each step's shards enqueued before the host reads any of them
(``mesh.run_sharded``).
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from genpc_tpu_torch.geometry.normalize import normalize_points
from genpc_tpu_torch.io.glb import sample_mesh_surface
from genpc_tpu_torch.io.ply import load_xyz
from genpc_tpu_torch.metrics.metric import uhd
from genpc_tpu_torch.ops.chamfer import _nn, chamfer_nn, nearest_neighbor
from genpc_tpu_torch.ops.emd import emd_auction
from genpc_tpu_torch.ops.fps import pad_repeat
from genpc_tpu_torch.ops.fps_kernel import fps_batched
from genpc_tpu_torch.ops.rowsum import mean_dims
from genpc_tpu_torch.ops.voxel import voxel_down_sample
from genpc_tpu_torch.parallel.mesh import (dp_devices, dp_sharded, dp_size,
                                           gather, get_mesh, run_sharded,
                                           split)
from genpc_tpu_torch.pipeline.artifacts import (ObjectArtifacts,
                                                input_artifacts)
from genpc_tpu_torch.pipeline.depth_prompting import (
    DepthPrompting, make_inpainter, paint_depth)
from genpc_tpu_torch.pipeline.registration import _apply, resample_fixed
from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
from genpc_tpu_torch.registration import icp as _icp
from genpc_tpu_torch.registration.fusion import fuse_clouds_batched
from genpc_tpu_torch.registration.pose_optim import (
    POSE_CHUNK, optimize_all_starts, pick_transforms)
from genpc_tpu_torch.runtime import resolve_device
from genpc_tpu_torch.tracing import recording, span

POSE_N = 2048
ICP_N = 2048


# ------------------------------------------------------------ batched ops

def batched_fps(pts: torch.Tensor, k: int) -> torch.Tensor:
    """[B,N,3] -> FPS indices [B,k] (kernel K2 on CUDA)."""
    return fps_batched(pts, k)


def batched_fps_gather(pts: torch.Tensor, num_points: int = 16384
                       ) -> torch.Tensor:
    """[B,N,3] -> FPS-selected [B,num_points,3]."""
    idx = batched_fps(pts, num_points).long()
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))


def batched_metric_sampled(p: torch.Tensor, g: torch.Tensor,
                           emd_eps: float = 0.005, emd_iters: int = 50,
                           with_emd: bool = True):
    """Already-FPS-sampled pred/gt [B,n,3] -> (cd [B], emd [B]); each
    object's means summed alone on the card (``ops/rowsum``), so a dp
    shard scores an object as the whole batch does."""
    d1, d2, _, _ = chamfer_nn(p, g)
    cd = (mean_dims(torch.sqrt(torch.clamp_min(d1, 0)), (1,))
          + mean_dims(torch.sqrt(torch.clamp_min(d2, 0)), (1,))) / 2
    if with_emd:
        de, _ = emd_auction(p, g, eps=emd_eps, iters=emd_iters)
        emd = mean_dims(torch.sqrt(torch.clamp_min(de, 0)), (1,))
    else:
        emd = torch.full_like(cd, float("nan"))
    return cd, emd


def batched_pose_optim(comp, comp_col, part, part_col, radius: float,
                       lr: float, iters: int, render_size: int,
                       chunk: int | None = None, coarse_frac: float = 0.7,
                       coarse_res: int | None = None,
                       prune_to: int = 1) -> torch.Tensor:
    """Pose of each object's completion onto its partial (inputs
    [B,N,3]); returns the best 4x4 per object [B,4,4].  Coarse-to-fine
    and start pruning as in ``pose_optim.optimize_all_starts``."""
    carry = optimize_all_starts(
        comp, comp_col, part, part_col, radius, lr, iters, render_size,
        chunk=chunk or POSE_CHUNK, coarse_frac=coarse_frac,
        coarse_res=coarse_res, prune_to=prune_to)
    return pick_transforms(carry)


def batched_coarse_sweep(src: torch.Tensor, tgt: torch.Tensor,
                         scales: torch.Tensor, cd_inv_weight: float):
    """src/tgt [B,N,3]; scales [S] -> (best T [B,4,4], best loss [B]):
    icp_with_scaling for every (object, scale) problem at once, the
    lowest two-sided score per object (first index on ties)."""
    b, n_s = src.shape[0], scales.shape[0]
    obj = torch.arange(b, dtype=torch.int32,
                       device=src.device).repeat_interleave(n_s)
    cds, Ts = _icp._coarse_one(scales.to(torch.float32).repeat(b), src, tgt,
                               cd_inv_weight, obj_index=obj)
    cds = cds.reshape(b, n_s)
    k = torch.argmin(cds, dim=1)
    rows = torch.arange(b, device=src.device)
    return Ts.reshape(b, n_s, 4, 4)[rows, k], cds[rows, k]


def batched_fine_search(src: torch.Tensor, tgt: torch.Tensor,
                        cd_inv_weight: float = 0.5, scale_steps: int = 10,
                        chunk: int = 250) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis scale grid over a batch: returns (S [B,4,4], T [B,4,4]).

    Every candidate is scored chamfer-only on the scaled-but-unregistered
    source (the reference's semantics, see icp._fine_score); the grid is
    built in float64 and scored in float32 chunks, the first minimum of a
    chunk wins and a strict '<' decides across chunks; then one 15-step
    ICP per object at its winner."""
    axes = [np.linspace(0.8, 1.2, scale_steps)] * 3
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    b = src.shape[0]
    best_cd = np.full(b, np.inf)
    best_scales = np.ones((b, 3))
    rows = np.arange(b)
    for i in range(0, len(grid), chunk):
        g = torch.as_tensor(grid[i:i + chunk], dtype=torch.float32,
                            device=src.device)
        cds = _icp._fine_score(g, src, tgt, cd_inv_weight).cpu().numpy()
        j = cds.argmin(axis=1)
        better = cds[rows, j] < best_cd
        best_cd = np.where(better, cds[rows, j], best_cd)
        best_scales[better] = grid[i:i + chunk][j][better]
    best_T = _fine_icp_batch(torch.as_tensor(best_scales, dtype=torch.float32,
                                             device=src.device), src, tgt)
    S = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    S[:, 0, 0], S[:, 1, 1], S[:, 2, 2] = best_scales.T
    return S, best_T.cpu().numpy()


def _fine_icp_batch(scales3: torch.Tensor, src: torch.Tensor,
                    tgt: torch.Tensor) -> torch.Tensor:
    """15-step ICP per object at its winning per-axis scales -> [B,4,4]."""
    T, _, _ = _icp.icp(src * scales3[:, None], tgt, 0.075, iters=15)
    return T


def batched_similarity_refine(src: torch.Tensor, tgt: torch.Tensor,
                              mode: str = "anisotropic") -> torch.Tensor:
    """[B,N,3] partials -> [B,4,4] final-refine transforms onto the
    completions.  mode: 'anisotropic' (R·diag(s), default), 'affine'
    (general A) or 'similarity' (Umeyama c·R)."""
    fn = {"anisotropic": _icp.anisotropic_icp, "affine": _icp.affine_icp,
          "similarity": _icp.similarity_icp}[mode]
    return fn(src, tgt, 0.05)


# GT device-upload cache for repeated evals over the same object set
_GT_DEVICE_CACHE: Dict[str, tuple] = {}


# ----------------------------------------------------------------- runner

def _downsample_fixed(pts, n: int) -> np.ndarray:
    """voxel 0.03 then fixed-size resample (the ICP inputs)."""
    d, _ = voxel_down_sample(pts, 0.03)
    return resample_fixed(d, n)[0].astype(np.float32)


def _fuse_sharded(sources, targets, source_colors, target_colors, devices,
                  **kw) -> list:
    """``fuse_clouds_batched`` over the objects' dp shards, shard i on
    devices[i] (one FPS launch a shard), the results in object order."""
    k = len(sources) // len(devices)
    fused = []
    for i, d in enumerate(devices):
        sl = slice(i * k, (i + 1) * k)
        fused += fuse_clouds_batched(sources[sl], targets[sl],
                                     source_colors[sl], target_colors[sl],
                                     device=d, **kw)
    return fused


def _fuse_aligned(cfg, arts, devices) -> None:
    """Fuse the aligned completions with their partials (one FPS launch
    over each shard of the batch): spans ``reg_prep`` (the resample) and
    ``reg_fusion``."""
    tgts, tgt_rgbs = [], []
    with span("reg_prep", sync=devices[0]):
        for art in arts:
            tgt, tgt_rgb = resample_fixed(
                art.complete_xyz, int(cfg.get("glb_sample_points", 163840)),
                art.complete_rgb)
            tgts.append(tgt.astype(np.float32))
            tgt_rgbs.append(np.asarray(tgt_rgb, np.float32)
                            if tgt_rgb is not None else None)
    with span("reg_fusion", sync=devices[0]):
        fused = _fuse_sharded(
            [np.asarray(a.color_xyz, np.float32) for a in arts], tgts,
            [np.asarray(a.color_rgb, np.float32) for a in arts], tgt_rgbs,
            devices, num_points=int(cfg.get("fused_points", 20000)))
    for art, (pts, cols) in zip(arts, fused):
        art.fused_xyz, art.fused_rgb = pts, cols


def batched_reg(cfg, arts: List[ObjectArtifacts], cd_inv_weight: float = 0.5,
                mesh=None, fusion_debug: Optional[Dict[str, dict]] = None
                ) -> None:
    """Stage 3 for a batch of objects; writes fused clouds into arts.

    With ``trust_aligned_completion`` the completions their backend
    declares aligned are resampled and fused directly; every other
    completion is registered: pose optimisation, coarse sweep, fine
    grid, the reference's undo chain back into the input frame, the
    final refine, then dedup + concat per object, one FPS launch over the
    batch and the outlier masks (``fusion.fuse_clouds_batched``).
    Spans (``tracing``): reg_prep, reg_pose, reg_coarse, reg_fine,
    reg_refine, reg_fusion, each waiting for the device at its end while
    a recorder is on; the aligned completions' fusion gives reg_prep and
    reg_fusion alone.  fusion_debug (optional dict) receives per
    registered flag the attribution of the partial->fused UHD across the
    fusion's steps (``_fusion_report``).
    With a mesh each step runs over the dp shards of the objects; the
    mesh is dropped when the registered objects do not split evenly
    (reference: batched_runner.py:362-364)."""
    device = resolve_device(cfg.device, mesh)

    def shard_devices(n):
        # the run's device alone when n objects do not split over dp
        return dp_devices(mesh if n % dp_size(mesh) == 0 else None, device)

    if bool(cfg.get("trust_aligned_completion", False)):
        aligned = [a for a in arts if a.complete_aligned]
        _fuse_aligned(cfg, aligned, shard_devices(len(aligned)))
        arts = [a for a in arts if not a.complete_aligned]
        if not arts:
            return
    devs = shard_devices(len(arts))

    def stack(arrays):
        return np.stack(arrays).astype(np.float32)

    B = len(arts)
    pose_n = int(cfg.get("pose_complete_points", POSE_N))
    icp_n = int(cfg.get("icp_points", ICP_N))
    glb_n = int(cfg.get("glb_sample_points", 163840))
    # host prep: voxel downsample + fixed resample per object
    pose_c, pose_cc, pose_p, pose_pc = [], [], [], []
    tgts, tgt_rgbs, srcs, src_rgbs = [], [], [], []
    with span("reg_prep", sync=device):
        for art in arts:
            src = np.asarray(art.color_xyz, np.float32)
            src_rgb = (np.asarray(art.color_rgb, np.float32)
                       if art.color_rgb is not None
                       else np.full_like(src, 0.5))
            if art.complete_xyz is None and art.complete_mesh is not None:
                # a mesh-producing backend: sample the surface, as the
                # per-object path does (reference: reg_xyz.py:125
                # glb2point)
                art.complete_xyz, art.complete_rgb = sample_mesh_surface(
                    art.complete_mesh, glb_n)
            tgt, tgt_rgb = resample_fixed(art.complete_xyz, glb_n,
                                          art.complete_rgb)
            tgt = tgt.astype(np.float32)
            tgt_rgb = (np.asarray(tgt_rgb, np.float32)
                       if tgt_rgb is not None else np.full_like(tgt, 0.5))
            srcs.append(src)
            src_rgbs.append(src_rgb)
            tgts.append(tgt)
            tgt_rgbs.append(tgt_rgb)
            pv, pvc = voxel_down_sample(src, 0.02, src_rgb)
            t120, t120c = resample_fixed(tgt, min(120000, len(tgt)), tgt_rgb)
            cv, cvc = voxel_down_sample(t120, 0.02, t120c)
            pv, pvc = resample_fixed(pv, pose_n, pvc)
            cv, cvc = resample_fixed(cv, pose_n, cvc)
            pose_p.append(pv), pose_pc.append(pvc)
            pose_c.append(cv), pose_cc.append(cvc)

    with span("reg_pose", sync=device):
        T = run_sharded(lambda c, cc, p, pc: batched_pose_optim(
            c, cc, p, pc, 0.02, float(cfg.get("pose_lr", 0.01)),
            int(cfg.get("pose_iters", 200)),
            int(cfg.get("pose_render_size", 224)),
            coarse_frac=float(cfg.get("pose_coarse_frac", 0.7)),
            prune_to=int(cfg.get("pose_prune_starts", 0))), devs,
            stack(pose_c), stack(pose_cc), stack(pose_p), stack(pose_pc))
        diff_T = np.linalg.inv(T).astype(np.float32)

    with span("reg_coarse", sync=device):
        # normalise targets, transform sources into the pose frame (host)
        src_w = [_apply(diff_T[i], srcs[i]) for i in range(B)]
        tgt_n = [normalize_points(t, range=0.5)[0] for t in tgts]
        # coarse sweep on fixed-size voxel downsamples
        scales = torch.as_tensor(np.linspace(1.5, 0.8, 11),
                                 dtype=torch.float32)
        coarse_T, _ = run_sharded(lambda s, t: batched_coarse_sweep(
            s, t, scales.to(s.device), cd_inv_weight), devs,
            stack([_downsample_fixed(s, icp_n) for s in src_w]),
            stack([_downsample_fixed(t, icp_n) for t in tgt_n]))

    with span("reg_fine", sync=device):
        # fine per-axis grid
        src_w = [_apply(coarse_T[i], src_w[i]) for i in range(B)]
        S, fine_T = run_sharded(lambda s, t: batched_fine_search(
            s, t, cd_inv_weight=cd_inv_weight,
            scale_steps=int(cfg.get("fine_scale_steps", 10))), devs,
            stack([_downsample_fixed(s, icp_n) for s in src_w]),
            stack([_downsample_fixed(t, icp_n) for t in tgt_n]))

    with span("reg_refine", sync=device):
        # undo chain (reference order) back into the input frame
        final_s, final_t = [], []
        with span("reg_undo"):
            for i in range(B):
                t = tgt_n[i]
                t = _apply(np.linalg.inv(S[i]), t)
                t = _apply(np.linalg.inv(fine_T[i]), t)
                s = _apply(np.linalg.inv(coarse_T[i]), src_w[i])
                t = _apply(np.linalg.inv(coarse_T[i]), t)
                t = _apply(np.linalg.inv(diff_T[i]), t)
                s = _apply(np.linalg.inv(diff_T[i]), s)
                final_s.append(s)
                final_t.append(t)
        # final snap in the input frame (partial -> complete, the inverse
        # applied to the complete)
        if bool(cfg.get("final_icp_refine", True)):
            Tr = run_sharded(lambda s, t: batched_similarity_refine(
                s, t, mode=str(cfg.get("final_refine", "anisotropic"))),
                devs,
                stack([_downsample_fixed(s, icp_n) for s in final_s]),
                stack([_downsample_fixed(t, icp_n) for t in final_t]))
            for i in range(B):
                final_t[i] = _apply(np.linalg.inv(Tr[i]), final_t[i])

    with span("reg_fusion", sync=device):
        # dedup + concat + fps + denoise (one FPS launch over each shard)
        prov = [] if fusion_debug is not None else None
        fused = _fuse_sharded(
            final_s, final_t, src_rgbs, tgt_rgbs, devs,
            num_points=int(cfg.get("fused_points", 20000)),
            denoise_neighbors=int(cfg.get("denoise_neighbors", 20)),
            denoise_std_ratio=float(cfg.get("denoise_std", 2.5)),
            provenance=prov)
        for art, (pts, cols) in zip(arts, fused):
            art.fused_xyz, art.fused_rgb = pts, cols
        if fusion_debug is not None:
            for i, art in enumerate(arts):
                fusion_debug[art.flag] = _fusion_report(
                    art, final_s[i], final_t[i], prov[i], device)


def _fusion_report(art: ObjectArtifacts, s: np.ndarray, t: np.ndarray,
                   prov: dict, device) -> dict:
    """One object's fusion attribution (the reference's PED diagnosis):
    how far the registered completion sits from the partial, the UHD
    from the partial to the concatenation, to the FPS sample and to the
    fused cloud, and which share of the partial's and of the generated
    points the FPS and the outlier mask kept."""
    part = np.asarray(art.xyz, np.float32) if art.xyz is not None else s
    ds, _ = nearest_neighbor(torch.as_tensor(s, device=device),
                             torch.as_tensor(t, device=device))
    fp, mask = prov["from_partial"], prov["mask"]
    return {
        "reg_residual_cd_x100": round(float(np.sqrt(np.maximum(
            ds.cpu().numpy(), 0)).mean()) * 100, 3),
        "uhd_x100_partial_to_concat": round(
            uhd(part, prov["concat"], device=device) * 100, 3),
        "uhd_x100_partial_to_postfps": round(
            uhd(part, prov["sampled"], device=device) * 100, 3),
        "uhd_x100_partial_to_fused": round(
            uhd(part, art.fused_xyz, device=device) * 100, 3),
        "partial_frac_after_fps": round(float(fp.mean()), 4),
        "partial_kept_by_outlier_mask": round(float(mask[fp].mean()), 4)
        if fp.any() else None,
        "generated_kept_by_outlier_mask": round(float(mask[~fp].mean()), 4)
        if (~fp).any() else None,
    }


def _release_backend(owner, attr: str) -> None:
    """Free a stage's generative backend at a stage boundary — only when
    the owner built it: a backend the caller passed in is the caller's,
    and stays untouched."""
    if not getattr(owner, f"owns_{attr}", False):
        return
    backend = getattr(owner, attr, None)
    if backend is not None and hasattr(backend, "release"):
        backend.release()
    setattr(owner, attr, None)
    gc.collect()


def _generate_images(cfg, dp, arts) -> None:
    """Depth->image for a list of objects: a backend with a batched path
    (the DiT's ``generate_batch``) denoises the objects together, in
    chunks of ``cfg.generate_obj_batch`` (0: all in one); the others run
    the reference's per-object loop."""
    from genpc_tpu_torch.categories import get_category
    size = int(cfg.generate_res)
    gen = dp.depth2image
    if hasattr(gen, "generate_batch") and len(arts) > 1:
        ob = int(cfg.get("generate_obj_batch", 0) or 0) or len(arts)
        for lo in range(0, len(arts), ob):
            grp = arts[lo:lo + ob]
            imgs = gen.generate_batch([a.depth for a in grp],
                                      [a.flag for a in grp], size=size)
            v0 = getattr(gen, "first_velocity", None)
            for j, (art, img) in enumerate(zip(grp, imgs)):
                art.image = np.asarray(img)
                art.gen_v0 = None if v0 is None else v0[j]
        return
    for art in arts:
        art.image = np.asarray(gen.generate(
            art.depth, get_category(art.flag), size=size))
        v0 = getattr(gen, "first_velocity", None)
        art.gen_v0 = None if v0 is None else v0[0]


def _pad_to_dp(arts: List[ObjectArtifacts], mesh) -> List[ObjectArtifacts]:
    """The batch padded to a multiple of dp with copies of the last
    object's record as it stands (flags ``_pad<i>``; reference:
    batched_runner.py:617-624).  The device stages run them, and their
    results are dropped.  The runners pad before stage 1 and pad again
    after stage 2, so a pad carries the last object's generated image and
    completion instead of running the generators (the reference copies
    the image and runs stage 2 on the pads)."""
    pad = (-len(arts)) % dp_size(mesh)
    return arts + [dataclasses.replace(arts[-1], flag=f"_pad{i}")
                   for i in range(pad)]


def _pad_rows(a: np.ndarray, k: int) -> np.ndarray:
    """a [B,...] padded along B to a multiple of k with its last row."""
    pad = (-len(a)) % k
    return np.concatenate([a] + [a[-1:]] * pad) if pad else a


def run_batched(cfg, flags: List[str], data_dir: str,
                gt_dir: Optional[str] = None, with_emd: bool = True,
                batch: Optional[int] = None,
                timings: Optional[Dict[str, float]] = None,
                dp: Optional[DepthPrompting] = None
                ) -> Dict[str, Dict[str, float]]:
    """Full pipeline with batched stages + batched metrics, on cfg.device.

    The pass runs in six spans (``tracing``), each ending in a device
    synchronisation whatever is on: load, stage1, generate, stage2,
    stage3 (``batched_reg``'s reg_* spans inside), metric.  timings
    (optional dict): the pass runs inside a recorder and the dict
    receives ``Recorder.flat()``: each span's summed wall in seconds
    under its bare name, and its counters as ``"<span>:<counter>"``
    (``pose_coarse:steps``, ``stage3:syncs``; the table in ``tracing``'s
    docstring).  dp (optional) injects a pre-built DepthPrompting.  With
    cfg.mesh_shape every stage splits the objects over dp (the module
    docstring)."""
    if timings is None:
        return _run_batched(cfg, flags, data_dir, gt_dir, with_emd, batch,
                            dp)
    with recording() as rec:
        results = _run_batched(cfg, flags, data_dir, gt_dir, with_emd,
                               batch, dp)
    timings.update(rec.flat())
    return results


def _run_batched(cfg, flags, data_dir, gt_dir, with_emd, batch, dp):
    mesh = get_mesh(cfg)
    device = resolve_device(cfg.device, mesh)
    with span("load", sync=device, barrier=True):
        gt_dir = gt_dir or os.path.join(data_dir, "GT")
        dp = dp if dp is not None else DepthPrompting(cfg)
        sa = ScaleAdapter(cfg)
        n_in = int(cfg.get("input_points", 65536))

        arts = []
        for flag in flags:
            xyz, rgb = load_xyz(os.path.join(data_dir, f"{flag}.ply"))
            arts.append(input_artifacts(flag, xyz, rgb, n_in))
        real_arts, arts = arts, _pad_to_dp(arts, mesh)
    with span("stage1", sync=device, barrier=True):
        batched_stage1(cfg, arts, dp.viewpoints, dp=dp, mesh=mesh)
        # the inpainter is done once every depth is painted: free it
        # before the generator loads (the reference keeps it resident)
        _release_backend(dp, "inpainter")
    with span("generate", sync=device, barrier=True):
        _generate_images(cfg, dp, real_arts)
        _release_backend(dp, "depth2image")
    with span("stage2", sync=device, barrier=True):
        sa.scale_adapter_batch(real_arts)
        _release_backend(sa, "image23d")
        _release_backend(sa, "rembg")
        arts = _pad_to_dp(real_arts, mesh)

    with span("stage3", sync=device, barrier=True):
        batch = batch or len(arts)
        for i in range(0, len(arts), batch):
            batched_reg(cfg, arts[i:i + batch], mesh=mesh)
        arts = real_arts

    with span("metric", sync=device, barrier=True):
        # batched metric: FPS from the FULL clouds (reference:
        # main.py:21-22), each cloud padded to the batch max by repeating
        # its own points (ops/fps.pad_repeat: the selected sequence equals
        # the full-cloud run).
        results: Dict[str, Dict[str, float]] = {}
        preds, gts, valid = [], [], []
        for art in arts:
            gt_path = os.path.join(gt_dir, f"{art.flag}.ply")
            if not os.path.exists(gt_path):
                continue
            gt, _ = load_xyz(gt_path)
            from genpc_tpu_torch.metrics.frame_fixes import \
                apply_frame_fix
            gt = apply_frame_fix(art.flag, gt)
            preds.append(np.asarray(art.fused_xyz, np.float32))
            gts.append(np.asarray(gt, np.float32))
            valid.append(art.flag)
        if preds:
            devs = dp_devices(mesh, device)
            # the batch padded to a dp multiple by repeating its last cloud
            preds = _pad_rows(pad_repeat(preds), len(devs))
            gts = _pad_rows(pad_repeat(gts), len(devs))
            # GT clouds are immutable across passes over one eval set:
            # keep the GT-side FPS selection (the metric stage's biggest
            # compute) keyed by the GT directory, flag set, shape, sample
            # count and the shards' devices (the mesh).
            num_points = int(cfg.metric_points)
            gt_key = (os.path.abspath(gt_dir), tuple(valid), gts.shape,
                      num_points, tuple(str(d) for d in devs))
            cached = _GT_DEVICE_CACHE.get("entry")
            if cached is not None and cached[0] == gt_key:
                gt_s = cached[1]
            else:
                gt_s = [batched_fps_gather(g, num_points)
                        for g in split(gts, devs)]
                _GT_DEVICE_CACHE["entry"] = (gt_key, gt_s)
            outs = [batched_metric_sampled(
                batched_fps_gather(p, num_points), g,
                emd_eps=float(cfg.emd_eps), emd_iters=int(cfg.emd_iters),
                with_emd=with_emd)
                for p, g in zip(split(preds, devs), gt_s)]
            cd, emd = (np.concatenate([o[j].cpu().numpy() for o in outs])
                       for j in (0, 1))
            for i, flag in enumerate(valid):
                results[flag] = {"cd": float(cd[i])}
                if with_emd:
                    results[flag]["emd"] = float(emd[i])
    return results


def _holdout_wedge(xyz: np.ndarray, wedge_deg: float) -> np.ndarray:
    """The held-out wedge of a scan (reference: batched_runner.py:745-760):
    the points within wedge_deg/2 of the azimuth opposite the densest
    10° bin about the scan's centroid, so that the rest still anchors the
    viewpoint selection."""
    c = xyz.mean(0)
    az = np.degrees(np.arctan2(xyz[:, 1] - c[1], xyz[:, 0] - c[0]))
    hist, edges = np.histogram(az, bins=36, range=(-180, 180))
    center = (edges[hist.argmax()] + 5.0 + 180.0)
    d = (az - center + 180.0) % 360.0 - 180.0
    return np.abs(d) < wedge_deg / 2.0


def _uhd_batched(partials: List[np.ndarray], fused: List[np.ndarray],
                 devices: List[torch.device]) -> np.ndarray:
    """Max-of-min distance of each partial into its fused cloud [B]: one
    K1 launch per dp shard (``devices``) over both sides padded by
    repetition (a duplicate changes neither a row's minimum nor the
    maximum over rows), the batch padded to a shard multiple."""
    k = len(devices)
    p = _pad_rows(pad_repeat(partials).astype(np.float32), k)
    f = _pad_rows(pad_repeat(fused).astype(np.float32), k)
    d2 = run_sharded(lambda a, b: _nn(a, b)[0], devices, p, f)
    return np.sqrt(np.maximum(d2, 0.0)).max(axis=1)[:len(partials)]


def run_batched_lidar(cfg, flags: List[str], data_dir: str, category: str,
                      batch: Optional[int] = None,
                      holdout_wedge_deg: float = 0.0,
                      fusion_debug: Optional[Dict[str, dict]] = None
                      ) -> Dict[str, Dict[str, float]]:
    """Waymo LiDAR pipeline with batched stages (reference: main_lidar.py;
    genpc_tpu/parallel/batched_runner.py:713-815), on cfg.device.

    Scans load from data_dir/category and, with no GT, each object's
    quality is the partial->completion UHD (reference: metric.py:105-132).

    holdout_wedge_deg > 0 withholds an azimuthal wedge of each scan from
    the pipeline (when the rest keeps at least min(1024, n // 2) points:
    PED scans hold ~350-500), and ``holdout_uhd`` is the max distance
    from the held-out points to the fused completion: a completion
    quality signal the partial->fused UHD cannot give, since the fused
    cloud contains the partial.  With cfg.mesh_shape every stage splits
    the objects over dp (the module docstring)."""
    mesh = get_mesh(cfg)
    devs = dp_devices(mesh, resolve_device(cfg.device, mesh))
    dp = DepthPrompting(cfg)
    sa = ScaleAdapter(cfg)
    n_in = int(cfg.get("input_points", 65536))

    arts = []
    heldout: Dict[str, np.ndarray] = {}
    for flag in flags:
        xyz, rgb = load_xyz(os.path.join(data_dir, category, f"{flag}.ply"))
        if holdout_wedge_deg > 0.0:
            held = _holdout_wedge(xyz, holdout_wedge_deg)
            keep_min = min(1024, len(xyz) // 2)
            if held.any() and (~held).sum() >= keep_min:
                heldout[flag] = xyz[held].astype(np.float32)
                xyz, rgb = xyz[~held], rgb[~held]
        arts.append(input_artifacts(flag, xyz, rgb, n_in))
    real_arts, arts = arts, _pad_to_dp(arts, mesh)

    batched_stage1(cfg, arts, dp.viewpoints, dp=dp, mesh=mesh)
    _release_backend(dp, "inpainter")
    _generate_images(cfg, dp, real_arts)
    _release_backend(dp, "depth2image")
    sa.scale_adapter_batch(real_arts)
    _release_backend(sa, "image23d")
    _release_backend(sa, "rembg")
    arts = _pad_to_dp(real_arts, mesh)
    batch = batch or len(arts)
    for i in range(0, len(arts), batch):
        batched_reg(cfg, arts[i:i + batch], mesh=mesh,
                    fusion_debug=fusion_debug)
    arts = real_arts

    h = _uhd_batched([a.xyz for a in arts], [a.fused_xyz for a in arts],
                     devs)
    results = {a.flag: {"uhd": float(h[i])} for i, a in enumerate(arts)}
    if heldout:
        held_arts = [a for a in arts if a.flag in heldout]
        hu = _uhd_batched([heldout[a.flag] for a in held_arts],
                          [a.fused_xyz for a in held_arts], devs)
        for i, a in enumerate(held_arts):
            results[a.flag]["holdout_uhd"] = float(hu[i])
    return results


# -------------------------------------------------------- batched stage 1

def _up_vector(eye: torch.Tensor) -> torch.Tensor:
    """calculate_up_vector for a batch of eyes [B,3] (cameras.py twin)."""
    gaze = -eye
    world_up = torch.tensor([0.0, 1.0, 0.0], device=eye.device) \
        .expand_as(eye)
    side = torch.linalg.cross(gaze, world_up, dim=-1)
    degenerate = torch.linalg.vector_norm(side, dim=-1, keepdim=True) < 1e-8
    up = torch.linalg.cross(side, gaze, dim=-1)
    up = up / torch.clamp_min(
        torch.linalg.vector_norm(up, dim=-1, keepdim=True), 1e-12)
    return torch.where(degenerate,
                       torch.tensor([0.0, 0.0, 1.0], device=eye.device), up)


def _project(eye: torch.Tensor, pts: torch.Tensor, fovy_rad: float
             ) -> torch.Tensor:
    """Project pts [N,3] through cameras at eye [C,3] looking at the
    origin -> [C,N,3] = (u, v, depth)."""
    from genpc_tpu_torch.geometry.cameras import look_at_rotation
    rot = look_at_rotation(eye, torch.zeros_like(eye), _up_vector(eye))
    cam = torch.einsum("cnj,cij->cni", pts[None] - eye[:, None], rot)
    depth = -cam[..., 2]
    inv_tan = 1.0 / torch.tan(torch.tensor(fovy_rad * 0.5,
                                           device=eye.device))
    safe = torch.clamp_min(depth, 1e-8)
    return torch.stack([cam[..., 0] / safe * inv_tan,
                        cam[..., 1] / safe * inv_tan, depth], dim=-1)


def make_stage1_core(cfg, viewpoints: np.ndarray,
                     device: torch.device | str = "cpu", mesh=None):
    """Build the batched Stage-1 core: (xyz, rgb) [B,N,3] ->
    (uv [B,N,2], viewpoint [B,3], raw_depth/depth/mask1/mask2
    [B,3,res,res]).  With a mesh that has a dp axis the core takes the
    dp shards of xyz and rgb (``mesh.dp_sharded``), runs each on its
    device and returns the outputs gathered in shard order on the first
    dp device (the reference runs the core under shard_map,
    batched_runner.py:902-907).

    FPS to ``downsample_num`` (one K2 launch over the batch),
    coarse-to-exact z-buffer viewpoint selection over the rig, the
    best-vs-opposite depth-sum heuristic, splatting, masks and, with the
    diffusion inpainter ('jax'), its fill (depth None otherwise: the
    per-object inpainter paints it)."""
    from genpc_tpu_torch.geometry.cameras import rescale_uvs
    from genpc_tpu_torch.ops.hpr import (
        auto_zbuffer_res, select_best_view, visible_points_zbuffer)
    from genpc_tpu_torch.render.inpaint import diffusion_inpaint
    from genpc_tpu_torch.render.splat import raw_depth_images, uvs_to_pixels

    fovy_rad = math.pi * float(cfg.fovy) / 180.0
    res = int(cfg.res)
    n_ds = int(cfg.downsample_num)
    point_size = int(cfg.point_size)
    mask_rate = int(cfg.mask_pixel_rate)
    padding = float(cfg.padding)
    inpaint_iters = int(cfg.get("inpaint_iters", 250))
    fill = cfg.get("inpainter", "jax") == "jax"
    sel_coarse = int(cfg.get("select_coarse_points", 2500))
    sel_topk = int(cfg.get("select_topk", 48))

    def core(xyz: torch.Tensor, rgb: torch.Tensor, views: torch.Tensor):
        sampled = batched_fps_gather(xyz, n_ds)
        best = torch.stack([select_best_view(p, views, n_coarse=sel_coarse,
                                             topk=sel_topk)
                            for p in sampled])
        vp = views[best]                                   # [B,3]
        out = []
        for pts, cols, eye in zip(xyz, rgb, vp):
            cand = torch.stack([eye, -eye])                # best + opposite
            uv, d = rescale_uvs(_project(cand, pts, fovy_rad), padding)
            v2 = visible_points_zbuffer(
                pts, cand, res=auto_zbuffer_res(pts.shape[0]))  # [2,N]
            sums = torch.where(v2, d, 0.0).sum(dim=1)
            pick = torch.argmax(sums)                      # reference heuristic
            uv_s, d_s, vis_s = uv[pick], d[pick], v2[pick]
            pixels = uvs_to_pixels(uv_s, res)
            _, raw, m1, m2 = raw_depth_images(
                pixels, d_s, cols, res=res, point_size=point_size,
                mask_pixel_rate=mask_rate, valid=vis_s)
            out.append((uv_s, cand[pick], raw, m1, m2))
        uv, view, raw, m1, m2 = (torch.stack(t) for t in zip(*out))
        depth = diffusion_inpaint(raw, m1, iters=inpaint_iters) \
            if fill else None
        return uv, view, raw, depth, m1, m2

    def views_on(d):
        return torch.as_tensor(np.asarray(viewpoints), dtype=torch.float32,
                               device=d)

    if mesh is None or "dp" not in mesh.axis_names:
        return functools.partial(core, views=views_on(device))
    devs = mesh.axis_devices("dp")
    views = {d: views_on(d) for d in set(devs)}

    def sharded(xyz_shards, rgb_shards):
        outs = [core(x, r, views[d])
                for x, r, d in zip(xyz_shards, rgb_shards, devs)]
        return tuple(None if o[0] is None else gather(o, devs[0])
                     for o in zip(*outs))

    return sharded


def batched_stage1(cfg, arts: List[ObjectArtifacts],
                   viewpoints: np.ndarray, core=None,
                   dp: Optional[DepthPrompting] = None, mesh=None) -> None:
    """Run the Stage-1 core over a batch; fill the artifacts' fields.  With
    an inpainter other than the diffusion fill each object's depth is
    painted in the reference's per-object loop: by the FLUX or DDNM
    inpainter that ``dp`` holds (DDNM over hole mask 2, which it keeps as
    the object's mask), or by cv2 on the host.  With a mesh the objects
    split over dp (their count a multiple of dp)."""
    name = cfg.get("inpainter", "jax")
    inpainter = None
    if name in ("flux", "DDNM"):
        if dp is None or dp.inpainter is None:
            raise ValueError(f"inpainter {name!r} needs the DepthPrompting "
                             f"that holds it (dp=...)")
        inpainter = dp.inpainter
    else:
        make_inpainter(cfg)          # raises for an unknown name
    device = resolve_device(cfg.device, mesh)
    core = core or make_stage1_core(cfg, viewpoints, device=device,
                                    mesh=mesh)
    xyz = np.stack([a.xyz for a in arts]).astype(np.float32)
    rgb = np.stack([a.rgb for a in arts]).astype(np.float32)
    if mesh is not None and "dp" in mesh.axis_names:
        inputs = dp_sharded(mesh, xyz, rgb)
    else:
        inputs = (torch.as_tensor(xyz, device=device),
                  torch.as_tensor(rgb, device=device))
    uv, vp, raw, depth, m1, m2 = (None if t is None else t.cpu().numpy()
                                  for t in core(*inputs))
    for i, art in enumerate(arts):
        art.point_uv = uv[i]
        art.viewpoint = vp[i]
        art.raw_depth = raw[i]
        art.mask = m2[i] if name == "DDNM" else m1[i]
        art.depth = depth[i] if name == "jax" else paint_depth(
            cfg, inpainter, raw[i], m1[i], m2[i])
        art.paint_v0 = getattr(inpainter, "first_velocity", None)

"""Point-to-point ICP and the coarse/fine scale searches, batched over
problems (counterpart of genpc_tpu/registration/icp.py).

Every function takes a leading problem axis P, written out instead of
the reference's vmap: one ICP iteration over all problems is one launch
of kernel K1 for the correspondences and one batched 3×3 SVD (on the
card ``torch.linalg.svd`` synchronises with the host, so it runs once per
iteration, never per problem).

  * ``icp`` ≡ open3d registration_icp, point-to-point (reference:
    reg_xyz.py:18-20,28-37): NN correspondences within the distance,
    weighted Kabsch, a fixed number of iterations.
  * ``icp_with_scaling`` ≡ reg_xyz.py:24-38 (ICP, bake an isotropic
    scale into the result, ICP again).
  * ``coarse_scale_sweep`` ≡ the 11-scale loop reg_xyz.py:146-173.
  * ``iterative_scale_search`` ≡ the 10×10×10 per-axis grid
    reg_xyz.py:60-96, scored chamfer-only on the scaled-but-unregistered
    source (reg_xyz.py:75-83), then one ICP at the winner.
  * ``similarity_icp``, ``anisotropic_icp``, ``affine_icp``: the final
    refinements of the batched runner.

A problem whose target is shared between problems passes ``tgt_index``
(int32 [P], the target batch of each problem), so K1 reads one target
per object instead of a copy per problem.

Every sum over points and every small matrix product goes through
``ops/rowsum``, which on the card sums each output in an order that does
not depend on how many problems share the call: a dp shard's objects
register as they do in the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from portbench.reference.plain.ops.chamfer import _nn
from portbench.reference.plain.ops.rowsum import matmul, mean_dims, sum_dims


def _eye(p: int, n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.float32, device=device).expand(
        p, n, n).clone()


def _apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """T [P,4,4] applied to pts [P,N,3]."""
    return matmul(pts, T[:, :3, :3].transpose(1, 2)) + T[:, None, :3, 3]


def _rt(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[P,3,3], [P,3] -> 4x4 [P,4,4]."""
    T = _eye(A.shape[0], 4, A.device)
    T[:, :3, :3] = A
    T[:, :3, 3] = t
    return T


def _gather_targets(tgt: torch.Tensor, idx: torch.Tensor,
                    tgt_index: Optional[torch.Tensor]) -> torch.Tensor:
    t = tgt if tgt_index is None else tgt[tgt_index.long()]
    return torch.gather(t, 1, idx.long()[..., None].expand(-1, -1, 3))


def _point_sum(x: torch.Tensor) -> torch.Tensor:
    """[P,N,...] -> [P,...]: the sum over the points."""
    return sum_dims(x, (1,))


def _weighted_means(src, tgt, weights):
    w = weights / torch.clamp_min(sum_dims(weights, (1,), keepdim=True),
                                  1e-12)
    return w, _point_sum(src * w[..., None]), _point_sum(tgt * w[..., None])


def kabsch(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment src -> tgt for [P,N,3] pairs, weights
    [P,N]: returns (R [P,3,3], t [P,3])."""
    w, ms, mt = _weighted_means(src, tgt, weights)
    H = matmul((src - ms[:, None]).transpose(1, 2),
               (tgt - mt[:, None]) * w[..., None])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    d = torch.sign(torch.linalg.det(matmul(V, U.transpose(1, 2))))
    D = _eye(src.shape[0], 3, src.device)
    D[:, 2, 2] = d
    R = matmul(matmul(V, D), U.transpose(1, 2))
    t = mt - matmul(R, ms[..., None])[..., 0]
    return R, t


def umeyama(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted similarity alignment src -> tgt: (c [P], R [P,3,3],
    t [P,3]) with x -> c·R·x + t (Umeyama 1991 closed form)."""
    w, ms, mt = _weighted_means(src, tgt, weights)
    xs = src - ms[:, None]
    xt = tgt - mt[:, None]
    H = matmul(xs.transpose(1, 2), xt * w[..., None])
    U, D, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    d = torch.sign(torch.linalg.det(matmul(V, U.transpose(1, 2))))
    S = torch.ones_like(D)
    S[:, 2] = d
    R = matmul(matmul(V, torch.diag_embed(S)), U.transpose(1, 2))
    var_s = sum_dims(xs.square() * w[..., None], (1, 2))
    c = (D * S).sum(1) / torch.clamp_min(var_s, 1e-12)
    t = mt - c[:, None] * matmul(R, ms[..., None])[..., 0]
    return c, R, t


def _thresh2(max_correspondence_distance: float) -> float:
    return float(np.float32(max_correspondence_distance) ** 2)


def _correspond(src, T, tgt, tgt_index, thresh2):
    moved = _apply(T, src)
    d2, idx = _nn(moved, tgt, tgt_index)
    return moved, d2, _gather_targets(tgt, idx, tgt_index), \
        (d2 <= thresh2).to(torch.float32)


def icp(source: torch.Tensor, target: torch.Tensor,
        max_correspondence_distance: float,
        init_transform: Optional[torch.Tensor] = None, iters: int = 30,
        tgt_index: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ICP source [P,N,3] -> target [P or By,M,3]: (T [P,4,4], fitness
    [P], inlier_rmse [P])."""
    src = source.to(torch.float32)
    tgt = target.to(torch.float32)
    p = src.shape[0]
    T = _eye(p, 4, src.device) if init_transform is None \
        else init_transform.to(torch.float32)
    thresh2 = _thresh2(max_correspondence_distance)
    for _ in range(iters):
        moved, _, y, w = _correspond(src, T, tgt, tgt_index, thresh2)
        any_in = w.sum(1) > 0
        R, t = kabsch(moved, y, torch.where(any_in[:, None], w, 1.0))
        T = torch.where(any_in[:, None, None], matmul(_rt(R, t), T), T)
    d2, _ = _nn(_apply(T, src), tgt, tgt_index)
    inl = d2 <= thresh2
    fitness = inl.to(torch.float32).mean(1)
    rmse = torch.sqrt(torch.where(inl, d2, 0.0).sum(1)
                      / torch.clamp_min(inl.sum(1), 1))
    return T, fitness, rmse


def similarity_icp(source: torch.Tensor, target: torch.Tensor,
                   max_correspondence_distance: float = 0.05,
                   iters: int = 30) -> torch.Tensor:
    """ICP with a per-iteration closed-form scale (Umeyama update): the
    final input-frame refinement option 'similarity'.  Returns T [P,4,4]
    with T[:3,:3] = c·R."""
    src = source.to(torch.float32)
    tgt = target.to(torch.float32)
    T = _eye(src.shape[0], 4, src.device)
    thresh2 = _thresh2(max_correspondence_distance)
    for _ in range(iters):
        moved, _, y, w = _correspond(src, T, tgt, None, thresh2)
        any_in = w.sum(1) > 2
        c, R, t = umeyama(moved, y, torch.where(any_in[:, None], w, 1.0))
        T = torch.where(any_in[:, None, None],
                        matmul(_rt(c[:, None, None] * R, t), T), T)
    return T


def anisotropic_icp(source: torch.Tensor, target: torch.Tensor,
                    max_correspondence_distance: float = 0.05,
                    iters: int = 30, inner: int = 2) -> torch.Tensor:
    """ICP with a per-axis scale model x -> R·diag(s)·x + t (the default
    final refinement): per iteration, ``inner`` alternations of the
    per-axis least-squares scale (clamped to ±25 %) and Kabsch.  Returns
    T [P,4,4] with T[:3,:3] = R·diag(s)."""
    src = source.to(torch.float32)
    tgt = target.to(torch.float32)
    p = src.shape[0]
    T = _eye(p, 4, src.device)
    thresh2 = _thresh2(max_correspondence_distance)
    for _ in range(iters):
        moved, _, y, w0 = _correspond(src, T, tgt, None, thresh2)
        any_in = w0.sum(1) > 8
        w = torch.where(any_in[:, None], w0, 1.0)
        R = _eye(p, 3, src.device)
        s = torch.ones((p, 3), dtype=torch.float32, device=src.device)
        t = torch.zeros((p, 3), dtype=torch.float32, device=src.device)
        for _ in range(inner):
            yb = matmul(y - t[:, None], R)
            num = _point_sum(w[..., None] * moved * yb)
            den = _point_sum(w[..., None] * moved * moved)
            s = torch.clamp(num / torch.clamp_min(den, 1e-12), 0.75, 1.25)
            R, t = kabsch(moved * s[:, None], y, w)
        T = torch.where(any_in[:, None, None],
                        matmul(_rt(matmul(R, torch.diag_embed(s)), t), T), T)
    return T


def affine_icp(source: torch.Tensor, target: torch.Tensor,
               max_correspondence_distance: float = 0.05,
               iters: int = 30) -> torch.Tensor:
    """ICP with a general affine model x -> A·x + t, A's singular values
    clamped to [0.75, 1.25] (final refinement option 'affine').  Returns
    T [P,4,4] with T[:3,:3] = A."""
    src = source.to(torch.float32)
    tgt = target.to(torch.float32)
    p = src.shape[0]
    T = _eye(p, 4, src.device)
    eye3 = torch.eye(3, dtype=torch.float32, device=src.device)
    thresh2 = _thresh2(max_correspondence_distance)
    for _ in range(iters):
        moved, _, y, w0 = _correspond(src, T, tgt, None, thresh2)
        any_in = w0.sum(1) > 8
        w = torch.where(any_in[:, None], w0, 1.0)[..., None]
        wsum = torch.clamp_min(_point_sum(w), 1e-6)
        xm = _point_sum(w * moved) / wsum
        ym = _point_sum(w * y) / wsum
        Xc = moved - xm[:, None]
        Yc = y - ym[:, None]
        Sxx = matmul((w * Xc).transpose(1, 2), Xc)
        tr = Sxx.diagonal(dim1=1, dim2=2).sum(1)
        Sxx = Sxx + 1e-6 * tr[:, None, None] * eye3
        Sxy = matmul((w * Yc).transpose(1, 2), Xc)
        A = matmul(Sxy, torch.linalg.inv_ex(Sxx)[0])
        U, S, Vt = torch.linalg.svd(A)
        A = matmul(matmul(U, torch.diag_embed(torch.clamp(S, 0.75, 1.25))),
                   Vt)
        t = ym - matmul(A, xm[..., None])[..., 0]
        T = torch.where(any_in[:, None, None], matmul(_rt(A, t), T), T)
    return T


def _scale_mat(s: torch.Tensor) -> torch.Tensor:
    """[P] isotropic or [P,3] per-axis scales -> diag(s, 1) [P,4,4]."""
    s3 = s[:, None].expand(-1, 3) if s.ndim == 1 else s
    return torch.diag_embed(torch.cat([s3, torch.ones_like(s3[:, :1])], 1))


def icp_with_scaling(source, target, scale: torch.Tensor,
                     max_correspondence_distance: float = 0.05,
                     init_transform: Optional[torch.Tensor] = None,
                     iters: int = 30,
                     tgt_index: Optional[torch.Tensor] = None):
    """ICP, bake an isotropic scale [P] into the result, ICP again
    (reference: reg_xyz.py:24-38, final = T1 @ diag(scale))."""
    T1, _, _ = icp(source, target, max_correspondence_distance,
                   init_transform, iters=iters, tgt_index=tgt_index)
    return icp(source, target, max_correspondence_distance,
               matmul(T1, _scale_mat(scale.to(torch.float32))), iters=iters,
               tgt_index=tgt_index)


def _partial_l1(x, y, y_index=None) -> torch.Tensor:
    """Per-problem one-sided chamfer-L1: mean sqrt of x's NN distances."""
    d, _ = _nn(x, y, y_index)
    return mean_dims(torch.sqrt(torch.clamp_min(d, 0.0)), (1,))


def _coarse_one(scale: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                cd_inv_weight: float, iters: int = 30,
                obj_index: Optional[torch.Tensor] = None):
    """Coarse candidates: scale [P], src/tgt [B,N,3] with obj_index [P]
    naming each problem's object (default: problem p is object p).
    Returns (cd [P], T [P,4,4])."""
    if obj_index is None:
        obj_index = torch.arange(src.shape[0], dtype=torch.int32,
                                 device=src.device)
    oi = obj_index.long()
    s, t = src.to(torch.float32)[oi], tgt.to(torch.float32)[oi]
    T, _, _ = icp_with_scaling(s, tgt, scale, 0.075, iters=iters,
                               tgt_index=obj_index)
    inv = torch.linalg.inv_ex(T)[0]
    t_back = _apply(inv, t)
    cd = _partial_l1(s, t_back) + _partial_l1(t_back, s) * cd_inv_weight
    return cd, T


def coarse_scale_sweep(source, target, scales=None,
                       cd_inv_weight: float = 0.5,
                       device: torch.device | str = "cuda"
                       ) -> Tuple[float, np.ndarray, float]:
    """Best isotropic scale by batched ICP for one pair [N,3]/[M,3]
    (reference: reg_xyz.py:146-173): (best_scale, T 4x4, best_loss).
    Runs on ``device`` (the card unless the caller asks for the CPU)."""
    if scales is None:
        scales = np.linspace(1.5, 0.8, 11)
    f32 = dict(dtype=torch.float32, device=device)
    src = torch.as_tensor(np.asarray(source), **f32)[None]
    tgt = torch.as_tensor(np.asarray(target), **f32)[None]
    sc = torch.as_tensor(np.asarray(scales), **f32)
    cds, Ts = _coarse_one(sc, src, tgt, cd_inv_weight,
                          obj_index=torch.zeros(len(sc), dtype=torch.int32,
                                                device=src.device))
    best = int(torch.argmin(cds))
    return float(scales[best]), Ts[best].cpu().numpy(), float(cds[best])


def _fine_score(scales3: torch.Tensor, src: torch.Tensor, tgt: torch.Tensor,
                cd_inv_weight: float) -> torch.Tensor:
    """Scores [B,C] of the per-axis candidates scales3 [C,3] on each
    object's scaled-but-unregistered source (no ICP; reference
    semantics, reg_xyz.py:75-83).  src/tgt [B,N,3]."""
    b, c = src.shape[0], scales3.shape[0]
    scaled = (src[:, None] * scales3[None, :, None]).reshape(
        b * c, src.shape[1], 3)
    obj = torch.arange(b, dtype=torch.int32,
                       device=src.device).repeat_interleave(c)
    fwd = _partial_l1(scaled, tgt, obj)
    rev = _partial_l1(tgt[obj.long()], scaled)
    return (fwd + rev * cd_inv_weight).reshape(b, c)


def iterative_scale_search(source, target,
                           scale_ranges=((0.8, 1.2), (0.8, 1.2), (0.8, 1.2)),
                           scale_steps: int = 10,
                           cd_inv_weight: float = 0.0,
                           batch: int = 125,
                           device: torch.device | str = "cuda",
                           ) -> Tuple[np.ndarray, float, np.ndarray]:
    """Per-axis scale grid for one pair (reference: reg_xyz.py:60-96):
    (S 4x4, best_loss, T 4x4).  Runs on ``device`` (the card unless the
    caller asks for the CPU)."""
    axes = [np.linspace(lo, hi, scale_steps) for lo, hi in scale_ranges]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    f32 = dict(dtype=torch.float32, device=device)
    src = torch.as_tensor(np.asarray(source), **f32)[None]
    tgt = torch.as_tensor(np.asarray(target), **f32)[None]
    best_cd, best_scales = np.inf, None
    for i in range(0, len(grid), batch):
        chunk = torch.as_tensor(grid[i:i + batch], **f32)
        cds = _fine_score(chunk, src, tgt, cd_inv_weight)[0].cpu().numpy()
        j = int(cds.argmin())
        if cds[j] < best_cd:
            best_cd = float(cds[j])
            best_scales = grid[i + j]
    sc = torch.as_tensor(best_scales, **f32)
    T, _, _ = icp(src * sc, tgt, 0.075, iters=15)
    S = np.eye(4)
    S[0, 0], S[1, 1], S[2, 2] = best_scales
    return S, best_cd, T[0].cpu().numpy()

"""7-DoF object pose optimisation (rotation-6D + translation + log-scale),
batched over objects (counterpart of genpc_tpu/registration/pose_optim.py;
reference: optim_registration/diff_obj_pose.py:339-594).

  * the partial renders once from a fixed camera (eye (0,0,3), focal
    4.0) into a reference image and hard mask;
  * 4 starts per object with y-axis 0/90/180/270° initial rotations,
    scale init 0.75 (a log-scale parameter);
  * per-step loss = soft mask (MSE·30 + BCE) + 10·Dice
    + 3·(CD(result→partial) + 0.5·CD(partial→result)) + 0.001·‖RRᵀ−I‖;
  * Adam with per-parameter learning rates (lr, 0.2·lr, 0.1·lr), written
    out in optax's order over [B, starts, …] tensors, with the best-loss
    parameters tracked per start.

All objects' starts render together: R = B·4 images per step through the
slot renderer (kernels K4/K5) and one-sided Chamfer terms through K1
(the partial shared per object through ``y_index``).  The step uses no
matrix-multiply library call and no float atomics, so it repeats bitwise
on the card; its sums over pixels and points go through ``ops/rowsum``,
so on the card an object's steps do not depend on the objects batched
beside it.

The carry is a dict: ``params`` and ``best_params`` ({rot6d [B,K,6],
trans [B,K,3], log_scale [B,K,1]}), ``opt`` ({mu, nu: like params; count
[B,K] int32}), ``best`` [B,K], ``ref_img`` [B,r,r,3], ``ref_mask``
[B,r,r].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from genpc_tpu_torch import _kernels
from genpc_tpu_torch.geometry.transforms import (
    build_transform, rot6d_from_axis_angle, rotation_6d_to_matrix)
from genpc_tpu_torch.ops.chamfer import nn_one_sided
from genpc_tpu_torch.ops.rowsum import mean_dims, std_dims, sum_dims
from genpc_tpu_torch.render.point_renderer import (
    RenderCamera, clip, hard_mask, render_points, soft_mask)
from genpc_tpu_torch.tracing import count, span

#: per-pixel depth slots of the pose renderer (reference value): inputs
#: are voxel-0.02 downsamples, whose centre-pixel occupancy at 224² stays
#: under this bound; points beyond it are dropped
POSE_RENDER_SLOTS = 6
#: the reference's host-chunk length; here it only decides whether the
#: coarse phase runs (it needs at least one chunk of steps)
POSE_CHUNK = 25
N_STARTS = 4
KEYS = ("rot6d", "trans", "log_scale")
#: Adam learning-rate factor of each parameter group (optax groups rot,
#: trans, scale)
LR_FACTOR = {"rot6d": None, "trans": 0.2, "log_scale": 0.1}
B1, B2, EPS = 0.9, 0.999, 1e-8
#: eager steps a phase runs on the card before it captures its step: the
#: capture then finds the allocator and the autograd engine warm
WARMUP_STEPS = 1


def _normalize_images(ref_img, result_img):
    """Statistical colour match of result to ref per render
    (diff_obj_pose.py:201-236); images [R,r,r,3]."""
    ref_mean = mean_dims(ref_img, (1, 2), keepdim=True)
    ref_std = std_dims(ref_img, (1, 2), keepdim=True) + 1e-6
    res_mean = mean_dims(result_img, (1, 2), keepdim=True)
    res_std = std_dims(result_img, (1, 2), keepdim=True) + 1e-6
    out = (result_img - res_mean) / res_std * ref_std + ref_mean
    return ref_img, clip(out, 0.0, 1.0)


def _dice_loss(pred, target, smooth=1e-6):
    inter = sum_dims(pred * target, (1, 2))
    return 1.0 - (2.0 * inter + smooth) / (sum_dims(pred, (1, 2))
                                           + sum_dims(target, (1, 2))
                                           + smooth)


def _bce(pred, target):
    p = clip(pred, 1e-7, 1.0 - 1e-7)
    return -mean_dims(target * torch.log(p)
                      + (1 - target) * torch.log(1 - p), (1, 2))


def _rot_apply(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v @ Rᵀ written out (no matmul library call): R [...,3,3], v [...,N,3]."""
    return (v[..., :, None, :] * R[..., None, :, :]).sum(-1)


def _transform_points(params, vert_pos, center):
    """params [B,K,...], vert_pos [B,N,3], center [B,3] ->
    (points [B,K,N,3], R [B,K,3,3], scale [B,K])."""
    R = rotation_6d_to_matrix(params["rot6d"])
    scale = torch.exp(params["log_scale"])[..., 0]
    local = (vert_pos - center[:, None])[:, None] * scale[..., None, None]
    local = _rot_apply(R, local)
    return local + center[:, None, None] + params["trans"][..., None, :], \
        R, scale


def pose_loss(params, vert_pos, vert_col, center, partial_xyz, ref_img,
              ref_mask, camera: RenderCamera, radius, gamma=1e-2,
              footprint=2, slots=POSE_RENDER_SLOTS) -> torch.Tensor:
    """Loss of every start: params leaves [B,K,...]; vert_pos/vert_col
    [B,N,3]; center [B,3]; partial_xyz [B,Np,3]; ref_img [B,r,r,3] ->
    [B,K].  ref_mask rides along as in the reference (the mask terms use
    the soft mask of ref_img)."""
    b, k = params["rot6d"].shape[:2]
    n = vert_pos.shape[1]
    pts, R, _ = _transform_points(params, vert_pos, center)
    flat = pts.reshape(b * k, n, 3)
    cols = vert_col[:, None].expand(b, k, n, 3).reshape(b * k, n, 3)
    result = render_points(flat, cols, radius, camera, gamma=gamma,
                           footprint=footprint, method="slots", slots=slots)
    ref = ref_img[:, None].expand((b, k) + ref_img.shape[1:]).reshape(
        (b * k,) + ref_img.shape[1:])
    ref_n, result_n = _normalize_images(ref, result)
    mask_result = soft_mask(result_n)
    mask_ref = soft_mask(ref_n)
    mask_loss = (mean_dims((mask_result - mask_ref).square(), (1, 2)) * 30.0
                 + _bce(mask_result, mask_ref)
                 + 10.0 * _dice_loss(mask_result, mask_ref))
    obj = torch.arange(b, dtype=torch.int32,
                       device=flat.device).repeat_interleave(k)
    d_fwd, _ = nn_one_sided(flat, partial_xyz.to(torch.float32), obj)
    d_rev, _ = nn_one_sided(partial_xyz.to(torch.float32)[obj.long()], flat)
    cd = (mean_dims(torch.sqrt(torch.clamp_min(d_fwd, 0.0)), (1,))
          + 0.5 * mean_dims(torch.sqrt(torch.clamp_min(d_rev, 0.0)), (1,)))
    # eps keeps the Frobenius-norm gradient finite at exact orthogonality
    eye = torch.eye(3, dtype=torch.float32, device=R.device)
    rrt = _rot_apply(R, R)                       # R @ Rᵀ
    ortho = torch.sqrt((rrt - eye).square().sum((-2, -1)) + 1e-12)
    return (mask_loss + 3.0 * cd).reshape(b, k) + 0.001 * ortho


def render_reference_image(partial_xyz, partial_col, radius,
                           render_size: int):
    """Reference render + hard mask (diff_obj_pose.py:108-134)."""
    cam = RenderCamera.default(render_size)
    img = render_points(partial_xyz.to(torch.float32),
                        partial_col.to(torch.float32), radius, cam,
                        method="slots")
    return img, hard_mask(img), cam


def _lr(lr: float, key: str, factors=LR_FACTOR) -> float:
    lr32 = np.float32(lr)
    f = factors[key]
    return float(lr32 if f is None else lr32 * np.float32(f))


def pose_carry_init(vert_pos, vert_col, partial_xyz, partial_col, radius,
                    render_size: int) -> Dict:
    """Initial state of the 4 starts of each object (inputs [B,N,3]);
    the reference image and mask render once here and ride in the
    carry."""
    dev = vert_pos.device
    b = vert_pos.shape[0]
    camera = RenderCamera.default(render_size)
    ref_img = render_points(partial_xyz.to(torch.float32),
                            partial_col.to(torch.float32), radius, camera,
                            footprint=2, method="slots")
    init_rots = torch.stack([rot6d_from_axis_angle("y", 90.0 * s, dev)
                             for s in range(N_STARTS)])
    params = {
        "rot6d": init_rots.expand(b, N_STARTS, 6).clone(),
        "trans": torch.zeros((b, N_STARTS, 3), dtype=torch.float32,
                             device=dev),
        "log_scale": torch.log(torch.full((b, N_STARTS, 1), 0.75,
                                          dtype=torch.float32, device=dev)),
    }
    return {"params": params,
            "opt": {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                    "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                    "count": torch.zeros((b, N_STARTS), dtype=torch.int32,
                                         device=dev)},
            "best": torch.full((b, N_STARTS), float("inf"),
                               dtype=torch.float32, device=dev),
            "best_params": {k: v.clone() for k, v in params.items()},
            "ref_img": ref_img, "ref_mask": hard_mask(ref_img)}


def pose_carry_from_arrays(params, mu, nu, count, best, best_params,
                           ref_img, ref_mask,
                           device: torch.device | str = "cuda") -> Dict:
    """A carry from plain arrays: params, mu, nu and best_params map
    rot6d/trans/log_scale to [B,K,...] arrays (mu and nu are the Adam
    moments of each parameter's group); count [B,K] is the Adam step
    count; best [B,K]; ref_img [B,r,r,3]; ref_mask [B,r,r]."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    def tree(d):
        return {k: t(d[k]) for k in KEYS}

    return {"params": tree(params),
            "opt": {"mu": tree(mu), "nu": tree(nu),
                    "count": t(count, torch.int32)},
            "best": t(best), "best_params": tree(best_params),
            "ref_img": t(ref_img), "ref_mask": t(ref_mask)}


def _adam(params, grads, opt, lr: float, factors=LR_FACTOR):
    """One Adam update in optax's order: mu, nu, bias correction from the
    incremented count, u = -lr·m̂/(√v̂ + eps), p + u; each group's
    learning rate is lr times its entry of ``factors`` (None: 1)."""
    count = opt["count"] + 1
    c = count.to(torch.float32)[..., None]
    bc1 = 1 - torch.pow(c.new_full((), B1), c)
    bc2 = 1 - torch.pow(c.new_full((), B2), c)
    new_p, mu, nu = {}, {}, {}
    for k in KEYS:
        g = grads[k]
        mu[k] = (1 - B1) * g + B1 * opt["mu"][k]
        nu[k] = (1 - B2) * g.square() + B2 * opt["nu"][k]
        upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
        new_p[k] = params[k] + upd * -_lr(lr, k, factors)
    return new_p, {"mu": mu, "nu": nu, "count": count}


def pose_step(carry: Dict, vert_pos, vert_col, partial_xyz, radius,
              lr: float, render_size: int):
    """The Adam step of every start of every object as a function of the
    state, the carry's {params, opt, best, best_params}: ``step(state)``
    returns the next state in new tensors.  Before the update the
    best-loss parameters are kept (strict ``loss < best``,
    diff_obj_pose.py:547-567).  The step copies nothing from the host and
    reads nothing back, so a CUDA graph can capture it."""
    camera = RenderCamera.default(render_size)
    center = mean_dims(vert_pos, (1,))
    ref_img, ref_mask = carry["ref_img"], carry["ref_mask"]

    def step(state: Dict) -> Dict:
        params, best = state["params"], state["best"]
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = pose_loss(p, vert_pos, vert_col, center, partial_xyz,
                         ref_img, ref_mask, camera, radius)
        grads = dict(zip(KEYS, torch.autograd.grad(
            loss.sum(), [p[k] for k in KEYS])))
        with torch.no_grad():
            loss = loss.detach()
            better = loss < best
            best_params = {k: torch.where(better[..., None], params[k],
                                          state["best_params"][k])
                           for k in KEYS}
            new_params, opt = _adam(params, grads, state["opt"], lr)
        return {"params": new_params, "opt": opt,
                "best": torch.minimum(best, loss),
                "best_params": best_params}

    return step


def _tree(fn, *trees):
    """``fn`` over the tensors of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _graphed_steps(step, state: Dict, steps: int) -> Dict:
    """``steps`` steps of ``step`` on the card, each reading the state from
    static buffers and copying its result into them: the first
    WARMUP_STEPS eagerly, then one capture of the step on a side stream,
    replayed for each remaining step.  The graph runs the eager step's
    kernels on the same buffers, so it gives the same bits.  The graph and
    its memory pool live for this call only.  The warm-up runs on the
    calling stream, so the blocks it leaves cached serve the next call; a
    new side stream each call would cache a set of its own each time."""
    dev = state["best"].device
    cur = torch.cuda.current_stream(dev)
    static = _tree(torch.clone, state)
    for _ in range(WARMUP_STEPS):
        _tree(torch.Tensor.copy_, static, step(static))
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.device(dev):
        pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side), _kernels.Captured() as launches:
            graph.capture_begin(pool=pool.id)
            try:
                _tree(torch.Tensor.copy_, static, step(static))
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        for _ in range(steps - WARMUP_STEPS):
            graph.replay()
            launches.replayed()
    finally:
        # the graph goes before its pool, whose end returns the pool's
        # memory to the device
        graph.reset()
        del pool
    return static


def pose_carry_steps(carry: Dict, vert_pos, vert_col, partial_xyz, radius,
                     lr: float, steps: int, render_size: int) -> Dict:
    """Advance every start of every object by ``steps`` Adam iterations
    (``pose_step``).  On a CUDA device, where it has more than
    WARMUP_STEPS steps, the steps after the first WARMUP_STEPS replay one
    CUDA graph of the step (``_graphed_steps``); elsewhere they run
    eagerly.  Counters (``tracing``): ``graph_steps``, the replayed steps,
    and ``captures``, the graphs captured (both 0 off the card)."""
    step = pose_step(carry, vert_pos, vert_col, partial_xyz, radius, lr,
                     render_size)
    state = {k: carry[k] for k in ("params", "opt", "best", "best_params")}
    graphed = vert_pos.device.type == "cuda" and steps > WARMUP_STEPS
    count("captures", int(graphed))
    count("graph_steps", steps - WARMUP_STEPS if graphed else 0)
    if graphed:
        state = _graphed_steps(step, state, steps)
    else:
        for _ in range(steps):
            state = step(state)
    return dict(state, ref_img=carry["ref_img"], ref_mask=carry["ref_mask"])


def prune_starts(lo: Dict, carry: Dict, keep: int) -> Dict:
    """Carry the ``keep`` best coarse-phase starts of each object into the
    full-resolution carry: params and Adam state ride along, best_params
    is a copy of params, best restarts at +inf (losses across
    resolutions do not compare)."""
    idx = torch.argsort(lo["best"], dim=1, stable=True)[:, :keep]

    def take(x):
        ii = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
        return torch.take_along_dim(x, ii, dim=1)

    params = {k: take(v) for k, v in lo["params"].items()}
    return {"params": params,
            "best_params": {k: v.clone() for k, v in params.items()},
            "opt": {"mu": {k: take(v) for k, v in lo["opt"]["mu"].items()},
                    "nu": {k: take(v) for k, v in lo["opt"]["nu"].items()},
                    "count": take(lo["opt"]["count"])},
            "best": torch.full_like(carry["best"][:, :keep], float("inf")),
            "ref_img": carry["ref_img"], "ref_mask": carry["ref_mask"]}


def pick_transforms(carry: Dict) -> torch.Tensor:
    """The best start of each object as a 4x4 [s·R | t] -> [B,4,4]."""
    k = torch.argmin(carry["best"], dim=1)
    rows = torch.arange(k.shape[0], device=k.device)
    bp = carry["best_params"]
    R = rotation_6d_to_matrix(bp["rot6d"][rows, k])
    s = torch.exp(bp["log_scale"][rows, k])[:, 0]
    return build_transform(R, bp["trans"][rows, k], s)


def optimize_all_starts(vert_pos, vert_col, partial_xyz, partial_col,
                        radius, lr: float, iters: int, render_size: int,
                        chunk: int = POSE_CHUNK, coarse_frac: float = 0.7,
                        coarse_res: int | None = None,
                        prune_to: int = 1) -> Dict:
    """Multi-start optimisation of B objects (inputs [B,N,3]); returns
    the final carry.

    Coarse-to-fine: the first coarse_frac of the iterations run at half
    resolution on a 4x FPS point subsample (kernel K2) with the radius
    scaled by sqrt(N/Nc); params and Adam state transfer to the
    full-resolution phase, whose best-loss tracking alone picks the pose.
    The coarse phase runs only when it has at least ``chunk`` steps.
    prune_to keeps the best prune_to coarse starts per object (0 or >= 4:
    all starts).  Spans (``tracing``): ``pose_coarse`` and ``pose_fine``
    around the two phases' steps, each counting its steps as ``steps``
    and, from ``pose_carry_steps``, ``graph_steps`` and ``captures`` (the
    single phase is ``pose_fine``)."""
    from genpc_tpu_torch.ops.fps_kernel import fps_batched
    coarse_res = coarse_res or max(64, render_size // 2)
    n_coarse = int(iters * coarse_frac)
    if n_coarse < chunk:
        n_coarse = 0
    dev = vert_pos.device
    if not n_coarse:
        carry = pose_carry_init(vert_pos, vert_col, partial_xyz, partial_col,
                                radius, render_size)
        with span("pose_fine", sync=dev):
            count("steps", iters)
            return pose_carry_steps(carry, vert_pos, vert_col, partial_xyz,
                                    radius, lr, iters, render_size)
    n_pts = vert_pos.shape[1]
    nc = min(n_pts, max(512, n_pts // 4))

    def sub(pts, cols):
        idx = fps_batched(pts, nc).long()[..., None].expand(-1, -1, 3)
        return torch.gather(pts, 1, idx), torch.gather(cols, 1, idx)

    cc, ccol = sub(vert_pos, vert_col)
    pc, pcol = sub(partial_xyz, partial_col)
    rad_c = float(np.float32(radius)
                  * np.sqrt(np.float32(n_pts) / np.float32(nc)))
    lo = pose_carry_init(cc, ccol, pc, pcol, rad_c, coarse_res)
    with span("pose_coarse", sync=dev):
        count("steps", n_coarse)
        lo = pose_carry_steps(lo, cc, ccol, pc, rad_c, lr, n_coarse,
                              coarse_res)
    carry = pose_carry_init(vert_pos, vert_col, partial_xyz, partial_col,
                            radius, render_size)
    if 0 < prune_to < N_STARTS:
        carry = prune_starts(lo, carry, prune_to)
    else:
        carry["params"] = lo["params"]
        carry["best_params"] = {k: v.clone() for k, v in lo["params"].items()}
        carry["opt"] = lo["opt"]
    with span("pose_fine", sync=dev):
        count("steps", iters - n_coarse)
        return pose_carry_steps(carry, vert_pos, vert_col, partial_xyz,
                                radius, lr, iters - n_coarse, render_size)


def object_pose_optimization(complete_xyz, complete_col, partial_xyz,
                             partial_col, radius: float = 0.02,
                             lr: float = 0.01, iters: int = 200,
                             render_size: int = 224,
                             coarse_frac: float = 0.7, prune_to: int = 1,
                             device: torch.device | str = "cuda"
                             ) -> np.ndarray:
    """Optimise one object's complete->partial pose; returns the best 4x4
    as numpy (reference entry point diff_obj_pose.py:496-594)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)[None]

    carry = optimize_all_starts(
        t(complete_xyz), t(complete_col), t(partial_xyz), t(partial_col),
        radius, lr, int(iters), int(render_size),
        coarse_frac=float(coarse_frac), prune_to=int(prune_to))
    return pick_transforms(carry)[0].cpu().numpy()

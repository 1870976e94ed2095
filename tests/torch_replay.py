"""Record-and-replay helpers of the port's end-to-end parity tests
(test_torch_per_object.py, test_torch_lidar.py).

The reference's run records what a step returned; the port's run either
replays it without calling its own step (``tape``: model-free stand-ins
whose inputs carry a standing rounding mismatch), or runs its own step
on its own inputs, measures both against the reference's, and goes on
with the reference's result (``held``: the registration steps, whose
rounding-level differences the next step's voxel binning would
otherwise amplify, ROADMAP queue 3).
"""

import numpy as np
import torch

#: transforms of one algorithm on the same inputs, with different
#: roundings of the same sums: 30 ICP iterations twice per scale, where a
#: correspondence that crosses the distance threshold or a near-tied NN
#: moves the result by more than rounding (measured: <= 2.4e-6, and
#: 2.3e-4 on one object's coarse sweep)
REG_STEP_TOL = 1e-3


def native_off(*_a, **_k):
    """Pins the reference's voxel downsample to its numpy algorithm: its
    native helper emits voxels in another order (ROADMAP queue 3)."""
    raise RuntimeError("native voxel helper pinned off")


def tape(fn, recorded):
    """fn recording its results onto an empty list, or replaying a full
    one in call order without calling fn."""
    replay = list(recorded)

    def call(*a, **k):
        if replay:
            return replay.pop(0)
        out = fn(*a, **k)
        recorded.append(out)
        return out
    return call


def arrays(x):
    """The numeric arrays in a step's arguments or result, in order; a
    Python float as the float32 it enters the computation as (the
    reference hands jnp.float32 scalars where the port hands floats)."""
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in arrays(v)]
    if isinstance(x, torch.Tensor):
        return [x.numpy()]
    if x is None or isinstance(x, str):
        return []
    if isinstance(x, float):
        x = np.float32(x)
    return [np.asarray(x, np.float64)]


def max_err(a, b):
    """Max |a - b| over a step's arrays (the port may batch a problem
    that the reference takes alone: shapes [1,...] against [...])."""
    pairs = list(zip(arrays(a), arrays(b)))
    assert pairs and all(x.size == y.size for x, y in pairs)
    return max(float(np.abs(np.asarray(x, np.float64).reshape(y.shape)
                            - y).max()) for x, y in pairs)


def held(name, fn, recorded, errors, convert):
    """fn recording (arguments, result) onto an empty list; with a full
    one, fn runs and (name, argument error, result error) against the
    recorded call goes onto ``errors``, and the recorded result, passed
    through ``convert``, is returned."""
    replay = list(recorded)

    def call(*a, **k):
        out = fn(*a, **k)
        if not replay:
            recorded.append((a, out))
            return out
        ref_a, ref_out = replay.pop(0)
        errors.append((name, max_err(a, ref_a), max_err(out, ref_out)))
        return convert(ref_out)
    return call


#: a Kabsch tie: the step's cross-covariance H has its second singular
#: value below one fp32 ulp of its first (σ2/σ1 < 2^-23), so the rotation
#: about H's dominant axis is rounding noise, which two correct fp32 SVDs
#: settle either way (two inliers give a rank-1 H)
KABSCH_TIE = 2.0 ** -23


def _kabsch_inputs(jnp, jnn, src, tgt, T, thresh2):
    """The reference's ICP correspondences from T (icp.py:64-67): the
    moved source, its matched targets and the inlier weights."""
    moved = src @ jnp.asarray(T[:3, :3]).T + jnp.asarray(T[:3, 3])
    d2, idx = jnn(moved[None], tgt[None])
    return (np.asarray(moved), np.asarray(tgt[idx[0]]),
            np.asarray((d2[0] <= thresh2).astype(jnp.float32)))


def _sv_ratio(moved, y, w):
    """σ2/σ1 of the Kabsch cross-covariance H of a step (float64)."""
    w = w.astype(np.float64) / max(float(w.sum()), 1e-12)
    ms, mt = (moved * w[:, None]).sum(0), (y * w[:, None]).sum(0)
    sv = np.linalg.svd((moved - ms).T @ ((y - mt) * w[:, None]),
                       compute_uv=False)
    return float(sv[1] / max(sv[0], 1e-30))


def coarse_candidate_parting(src, tgt, scale, iters=30, tol=1e-4):
    """Replays one coarse-sweep candidate (the reference's
    icp_with_scaling at 0.075: ICP from the identity, the scale baked
    in, ICP again) one ICP step at a time (chained one-step calls of the
    reference's jitted ICP give its looped result bit for bit), taking
    the port's step from each of the reference's transforms too.
    Returns None when every step agrees within tol, else the first step
    that does not: {'pass': 1 or 2, 'iter', 'inliers', 'sv_ratio': σ2/σ1
    of its Kabsch H}."""
    import importlib

    import jax.numpy as jnp

    from genpc_tpu.ops.chamfer import _nn as jnn
    jicp = importlib.import_module("genpc_tpu.registration.icp")
    ticp = importlib.import_module("genpc_tpu_torch.registration.icp")
    sj, tj = jnp.asarray(src), jnp.asarray(tgt)
    st, tt = torch.tensor(src)[None], torch.tensor(tgt)[None]
    T = jnp.eye(4, dtype=jnp.float32)
    for p in (1, 2):
        if p == 2:
            T = T @ jicp._scale_mat(jnp.float32(scale))
        for i in range(iters):
            T_ref = jicp.icp(sj, tj, 0.075, T, iters=1)[0]
            T_port = ticp.icp(st, tt, 0.075,
                              torch.tensor(np.asarray(T))[None], iters=1)[0]
            if np.abs(T_port[0].numpy() - np.asarray(T_ref)).max() > tol:
                k_in = _kabsch_inputs(jnp, jnn, sj, tj, np.asarray(T),
                                      jnp.float32(0.075) ** 2)
                return {"pass": p, "iter": i, "inliers": int(k_in[2].sum()),
                        "sv_ratio": _sv_ratio(*k_in)}
            T = T_ref
    return None


def hold_coarse_sweep(src, tgt, scales, cd_inv_weight, label):
    """Holds the port's batched_coarse_sweep on src/tgt [B,N,3] to the
    reference's, object by object.  Each candidate (object, scale) whose
    score or transform leaves REG_STEP_TOL of the reference's
    ``_coarse_one`` must part from it first at a Kabsch tie (printed);
    every object without such a candidate must get the reference's sweep
    result within REG_STEP_TOL.  Returns the tied candidates."""
    import importlib

    import jax.numpy as jnp
    jbr = importlib.import_module("genpc_tpu.parallel.batched_runner")
    jicp = importlib.import_module("genpc_tpu.registration.icp")
    tbr = importlib.import_module("genpc_tpu_torch.parallel.batched_runner")
    ticp = importlib.import_module("genpc_tpu_torch.registration.icp")
    src, tgt = np.asarray(src, np.float32), np.asarray(tgt, np.float32)
    scales = np.asarray(scales, np.float32)
    cd_inv_weight = float(cd_inv_weight)
    b, s = src.shape[0], len(scales)
    cds, Ts = ticp._coarse_one(
        torch.tensor(scales).repeat(b), torch.tensor(src),
        torch.tensor(tgt), cd_inv_weight,
        obj_index=torch.arange(b, dtype=torch.int32).repeat_interleave(s))
    ties = []
    for o in range(b):
        for k in range(s):
            cj, Tj = jicp._coarse_one(jnp.float32(scales[k]),
                                      jnp.asarray(src[o]),
                                      jnp.asarray(tgt[o]),
                                      jnp.float32(cd_inv_weight))
            row = o * s + k
            if max(abs(float(cds[row]) - float(cj)),
                   float(np.abs(Ts[row].numpy() - np.asarray(Tj)).max())
                   ) <= REG_STEP_TOL:
                continue
            part = coarse_candidate_parting(src[o], tgt[o], scales[k])
            print(f"{label}: object {o}, scale {scales[k]:.2f}: score "
                  f"{float(cds[row]):.6f} against the reference's "
                  f"{float(cj):.6f}; first parts at {part}")
            assert part is not None and part["sv_ratio"] < KABSCH_TIE, \
                (label, o, k, part)
            ties.append((o, k))
    Tr, cr = jbr.batched_coarse_sweep(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(scales),
        jnp.float32(cd_inv_weight))
    Tp, cp = tbr.batched_coarse_sweep(
        torch.tensor(src), torch.tensor(tgt), torch.tensor(scales),
        cd_inv_weight)
    for o in sorted(set(range(b)) - {t[0] for t in ties}):
        err = max(float(np.abs(Tp[o].numpy() - np.asarray(Tr[o])).max()),
                  abs(float(cp[o]) - float(cr[o])))
        assert err <= REG_STEP_TOL, (label, o, err)
    return ties

"""Parity of the port's registration slice (geometry/transforms,
geometry/normalize, ops/voxel, metrics/losses, registration/icp,
registration/pose_optim and the batched stage-3 steps) with the JAX
reference on the CPU, on the same seeded numpy inputs."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.native
from genpc_tpu.geometry import normalize as jnorm
from genpc_tpu.geometry import transforms as jtf
from genpc_tpu.metrics import losses as jlosses
from genpc_tpu.ops import voxel as jvoxel
from genpc_tpu.parallel import batched_runner as jbr
from genpc_tpu.render.point_renderer import RenderCamera as JCamera
from genpc_tpu_torch.geometry import normalize as tnorm
from genpc_tpu_torch.geometry import transforms as ttf
from genpc_tpu_torch.metrics import losses as tlosses
from genpc_tpu_torch.ops import voxel as tvoxel
from genpc_tpu_torch.parallel import batched_runner as tbr
from genpc_tpu_torch.registration import icp as ticp
from genpc_tpu_torch.registration import pose_optim as tpose
from genpc_tpu_torch.render.point_renderer import RenderCamera as TCamera
from torch_replay import hold_coarse_sweep

# the reference's package re-exports functions under its module names
jicp = importlib.import_module("genpc_tpu.registration.icp")
jpose = importlib.import_module("genpc_tpu.registration.pose_optim")

KEYS = ("rot6d", "trans", "log_scale")
GROUPS = {"rot6d": "rot", "trans": "trans", "log_scale": "scale"}


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def numpy_voxel(monkeypatch):
    """Pin the reference's voxel downsample to its numpy algorithm: its
    native helper emits voxels in another order (ROADMAP queue 3)."""
    def native_off(*_a, **_k):
        raise RuntimeError("native voxel helper pinned off")
    monkeypatch.setattr(genpc_tpu.native, "voxel_down_sample_native",
                        native_off)


def _rot(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def _pair(seed, n=256, scale=1.0, angle=0.15, noise=0.005):
    """A seeded cloud and a moved, noisy copy of it."""
    r = np.random.default_rng(seed)
    src = (r.normal(size=(n, 3)) * [0.3, 0.2, 0.1]).astype(np.float32)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (src * scale) @ R.T + np.float32([0.02, -0.01, 0.03])
    tgt = tgt + r.normal(size=tgt.shape).astype(np.float32) * noise
    return src, tgt.astype(np.float32)


# ------------------------------------------------- transforms, voxel

def test_transforms_match():
    # Gram-Schmidt, Rodrigues and the 4x4 builder: within 1e-6
    r = np.random.default_rng(0)
    d6 = r.normal(size=(5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.rotation_6d_to_matrix(_t(d6)).numpy(),
        np.asarray(jtf.rotation_6d_to_matrix(jnp.asarray(d6))), atol=1e-6)
    aa = r.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.axis_angle_to_matrix(_t(aa)).numpy(),
        np.asarray(jtf.axis_angle_to_matrix(jnp.asarray(aa))), atol=1e-6)
    for axis in "xyz":
        for ang in (0.0, 90.0, 180.0, 270.0, 33.0):
            np.testing.assert_allclose(
                ttf.rot6d_from_axis_angle(axis, ang).numpy(),
                np.asarray(jtf.rot6d_from_axis_angle(axis, ang)), atol=1e-6)
    R, t = _rot(1), r.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        ttf.build_transform(_t(R), _t(t), 0.75).numpy(),
        np.asarray(jtf.build_transform(R, t, 0.75)), atol=1e-7)
    pts = r.normal(size=(20, 3)).astype(np.float32)
    T = np.asarray(jtf.build_transform(R, t, 1.3))
    np.testing.assert_allclose(
        ttf.apply_transform(_t(T), _t(pts)).numpy(),
        np.asarray(jtf.apply_transform(T, pts)), atol=1e-6)


def test_normalize_points_match():
    # the same float32 operations on the host: within 1 ulp
    pts = (np.random.default_rng(2).normal(size=(500, 3)) * 3 + 1).astype(
        np.float32)
    out_j, c_j, s_j = jnorm.normalize_points(pts, range=0.5)
    out_t, c_t, s_t = tnorm.normalize_points(pts, range=0.5)
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=1.2e-7,
                               atol=1e-7)
    np.testing.assert_array_equal(c_t, np.asarray(c_j))
    assert s_t == float(s_j)


@pytest.mark.parametrize("n,size", [(3000, 0.02), (20000, 0.03), (7, 0.5)])
def test_voxel_down_sample_matches_numpy_reference(numpy_voxel, n, size):
    # the same numpy algorithm: exactly equal points and colours
    r = np.random.default_rng(n)
    pts = (r.normal(size=(n, 3)) * 0.3).astype(np.float32)
    cols = r.random((n, 3)).astype(np.float32)
    pj, cj = jvoxel.voxel_down_sample(pts, size, cols)
    pt, ct = tvoxel.voxel_down_sample(pts, size, cols)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)
    pj2, _ = jvoxel.voxel_down_sample(pts, size)
    np.testing.assert_array_equal(tvoxel.voxel_down_sample(pts, size)[0],
                                  pj2)


def test_losses_match():
    # one- and two-sided chamfer and EMD on the same clouds: 1e-6
    # relative (sum order); EMD 1e-3 relative, as in test_torch_ops
    r = np.random.default_rng(3)
    a = r.random((2, 300, 3)).astype(np.float32)
    b = r.random((2, 400, 3)).astype(np.float32)
    for name in ("chamfer_l1", "chamfer_l2", "chamfer_partial_l1",
                 "chamfer_partial_l2"):
        np.testing.assert_allclose(
            float(getattr(tlosses, name)(_t(a), _t(b))),
            float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        float(tlosses.emd_loss(_t(a[:, :256]), _t(b[:, :256]))),
        float(jlosses.emd_loss(jnp.asarray(a[:, :256]),
                               jnp.asarray(b[:, :256]))), rtol=1e-3)


def test_partial_chamfer_gradient_matches():
    # only d1 is computed; the gradient equals the reference's custom VJP
    # (its d2 term carries no cotangent): 1e-6
    r = np.random.default_rng(4)
    a = r.random((300, 3)).astype(np.float32)
    b = r.random((200, 3)).astype(np.float32)
    ga, gb = jax.grad(jlosses.chamfer_partial_l1, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    tlosses.chamfer_partial_l1(at, bt).backward()
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), atol=1e-6)


# --------------------------------------------------------------- ICP

def test_kabsch_and_umeyama_match():
    # batched closed forms against the single-problem reference: 1e-5
    src, tgt = _pair(5, scale=1.2)
    w = np.random.default_rng(6).random(len(src)).astype(np.float32)
    Rj, tj = jicp.kabsch(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    Rt, tt = ticp.kabsch(_t(src)[None], _t(tgt)[None], _t(w)[None])
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-5)
    cj, Rj, tj = jicp.umeyama(jnp.asarray(src), jnp.asarray(tgt),
                              jnp.asarray(w))
    ct, Rt, tt = ticp.umeyama(_t(src)[None], _t(tgt)[None], _t(w)[None])
    np.testing.assert_allclose(float(ct[0]), float(cj), atol=1e-5)
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-5)


@pytest.mark.parametrize("name,kwargs", [
    ("icp", dict(max_correspondence_distance=0.075, iters=30)),
    ("similarity_icp", dict(max_correspondence_distance=0.05)),
    ("anisotropic_icp", dict(max_correspondence_distance=0.05)),
    ("affine_icp", dict(max_correspondence_distance=0.05)),
])
def test_icp_family_matches(name, kwargs):
    # two problems batched on the port's side, one call per problem on
    # the reference's: T within 1e-5
    pairs = [_pair(7, scale=1.05), _pair(8, angle=0.1, noise=0.01)]
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    out = getattr(ticp, name)(_t(src), _t(tgt), **kwargs)
    Tt = (out[0] if isinstance(out, tuple) else out).numpy()
    for i in range(len(pairs)):
        ref = getattr(jicp, name)(jnp.asarray(src[i]), jnp.asarray(tgt[i]),
                                  **kwargs)
        Tj = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
        np.testing.assert_allclose(Tt[i], Tj, atol=1e-5)


def _icp_batch(seed, b=2, n=256):
    pairs = [_pair(seed + i, n=n, scale=0.9 + 0.2 * i, angle=0.1)
             for i in range(b)]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def test_batched_coarse_sweep_matches():
    # 11 scales x 2 objects, two 30-step ICPs each: T within 1e-5; the
    # best two-sided score, computed after the ICP, differs by up to
    # 4.6e-5 relative (measured), held to 1e-4
    src, tgt = _icp_batch(10)
    scales = np.linspace(1.5, 0.8, 11).astype(np.float32)
    Tj, cj = jbr.batched_coarse_sweep(jnp.asarray(src), jnp.asarray(tgt),
                                      jnp.asarray(scales), jnp.float32(0.5))
    Tt, ct = tbr.batched_coarse_sweep(_t(src), _t(tgt), _t(scales), 0.5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4)


@pytest.mark.parametrize("case", ["config5_scan", "seeded"])
def test_coarse_one_matches_or_ties(case):
    """_coarse_one against the reference's, candidate by candidate, on
    the config-5 scan whose sweep ended in another minimum (its 64-point
    ICP inputs, tests/data) and on a seeded pair: every candidate within
    REG_STEP_TOL but those that part at a Kabsch tie, which only the
    scan has (scales 1.50 and 1.36: two inliers after the scale jump,
    σ2/σ1 ~1e-8 of a rank-1 H)."""
    if case == "seeded":
        src, tgt = _icp_batch(60, n=64)
    else:
        d = np.load(os.path.join(os.path.dirname(__file__), "data",
                                 "config5_coarse_sweep_scan.npz"))
        src, tgt = d["src"][None], d["tgt"][None]
    scales = np.linspace(1.5, 0.8, 11).astype(np.float32)
    ties = hold_coarse_sweep(src, tgt, scales, 0.5, label=case)
    assert ties == ([(0, 0), (0, 2)] if case == "config5_scan" else [])


def test_batched_fine_search_matches():
    # the same winning grid scales (exact) and the ICP at the winner
    # within 1e-5
    src, tgt = _icp_batch(20)
    Sj, Tj = jbr.batched_fine_search(jnp.asarray(src), jnp.asarray(tgt))
    St, Tt = tbr.batched_fine_search(_t(src), _t(tgt))
    np.testing.assert_array_equal(St, Sj)
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)


@pytest.mark.parametrize("mode", ["anisotropic", "affine", "similarity"])
def test_batched_similarity_refine_matches(mode):
    src, tgt = _icp_batch(30)
    Tj = jbr.batched_similarity_refine(jnp.asarray(src), jnp.asarray(tgt),
                                       mode=mode)
    Tt = tbr.batched_similarity_refine(_t(src), _t(tgt), mode=mode)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)


def test_fine_icp_batch_matches():
    # the 15-step ICP at per-axis scales (the fine search's winner): T
    # within 1e-5
    src, tgt = _icp_batch(40)
    scales3 = np.float32([[1.1, 0.95, 1.0], [0.9, 1.05, 1.2]])
    Tj = jbr._fine_icp_batch(*map(jnp.asarray, (scales3, src, tgt)))
    Tt = tbr._fine_icp_batch(_t(scales3), _t(src), _t(tgt))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)


# --------------------------------------------------------------- pose

def _pose_inputs(b=2, n=64, seed=50):
    """Complete/partial clouds of b objects: the partial is a noisy
    sample of the complete's front half, turned about y."""
    r = np.random.default_rng(seed)
    comp, part = [], []
    for i in range(b):
        c = (r.normal(size=(n, 3)) * [0.25, 0.2, 0.15]).astype(np.float32)
        front = c[np.argsort(-c[:, 2])[: n // 2]]
        p = front[r.integers(0, len(front), n)] @ _rot(seed + i).T * 0.3 \
            + c[:n] * 0.7
        comp.append(c)
        part.append(p.astype(np.float32))
    cols = r.random((b, n, 3)).astype(np.float32)
    return np.stack(comp), cols, np.stack(part), cols[::-1].copy()


def _carry_to_numpy(carry):
    """The reference's carry as plain arrays (optax state flattened)."""
    out = {"params": {}, "mu": {}, "nu": {}, "best_params": {}}
    for k in KEYS:
        st = carry["opt"].inner_states[GROUPS[k]].inner_state[0]
        out["params"][k] = np.asarray(carry["params"][k])
        out["best_params"][k] = np.asarray(carry["best_params"][k])
        out["mu"][k] = np.asarray(st.mu[k])
        out["nu"][k] = np.asarray(st.nu[k])
        out["count"] = np.asarray(st.count)
    for k in ("best", "ref_img", "ref_mask"):
        out[k] = np.asarray(carry[k])
    return out


def _port_carry(a):
    return tpose.pose_carry_from_arrays(
        a["params"], a["mu"], a["nu"], a["count"], a["best"],
        a["best_params"], a["ref_img"], a["ref_mask"], device="cpu")


def test_pose_carry_init_matches():
    # the reference render (measured within 8.0e-7, held to 1e-5) and
    # mask, start params and Adam state
    comp, ccol, part, pcol = _pose_inputs()
    ref = _carry_to_numpy(jbr._bpose_init(
        *map(jnp.asarray, (comp, ccol, part, pcol)), jnp.float32(0.02),
        jnp.float32(0.01), 32))
    got = tpose.pose_carry_init(_t(comp), _t(ccol), _t(part), _t(pcol),
                                0.02, 32)
    np.testing.assert_allclose(got["ref_img"].numpy(), ref["ref_img"],
                               atol=1e-5)
    np.testing.assert_array_equal(got["ref_mask"].numpy(), ref["ref_mask"])
    for k in KEYS:
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   ref["params"][k], atol=1e-7)
        assert not got["opt"]["mu"][k].any() and not got["opt"]["nu"][k].any()
    assert np.isinf(got["best"].numpy()).all()


def test_pose_loss_and_gradient_match():
    # 4 starts of 2 objects at res 32 from the reference's initial carry:
    # measured loss error 9.4e-6 relative (held to 5e-5; the mask terms
    # sum log-probabilities of 1024 pixels) and gradient error 6.1e-6 of
    # the largest component (held to 1e-4)
    comp, ccol, part, pcol = _pose_inputs()
    carry = jbr._bpose_init(*map(jnp.asarray, (comp, ccol, part, pcol)),
                            jnp.float32(0.02), jnp.float32(0.01), 32)
    a = _carry_to_numpy(carry)
    # move the starts off their init so every term has a gradient
    r = np.random.default_rng(60)
    params = {k: (a["params"][k] + r.normal(size=a["params"][k].shape)
                  .astype(np.float32) * 0.05) for k in KEYS}
    camj = JCamera.default(32)

    def jone(p, vp, vc, px, ri, rm):
        return jax.value_and_grad(jpose.pose_loss)(
            p, vp, vc, vp.mean(axis=0), px, ri, rm, camj, jnp.float32(0.02))

    lj, gj = jax.vmap(jax.vmap(jone, in_axes=(0, None, None, None, None,
                                              None)))(
        {k: jnp.asarray(v) for k, v in params.items()},
        *map(jnp.asarray, (comp, ccol, part, a["ref_img"], a["ref_mask"])))
    p = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    lt = tpose.pose_loss(p, _t(comp), _t(ccol), _t(comp).mean(1), _t(part),
                         _t(a["ref_img"]), _t(a["ref_mask"]),
                         TCamera.default(32), 0.02)
    gt = torch.autograd.grad(lt.sum(), [p[k] for k in KEYS])
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=5e-5)
    for k, g in zip(KEYS, gt):
        ref = np.asarray(gj[k])
        assert np.abs(g.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k


def _jax_steps(carry, comp, ccol, part, steps, res=32):
    return jbr._bpose_steps(carry, *map(jnp.asarray, (comp, ccol, part)),
                            jnp.float32(0.02), jnp.float32(0.01), steps,
                            res)


def test_pose_carry_steps_from_shared_carry():
    # a carry taken across from the reference after 3 of its steps (so
    # the Adam moments are non-zero), then 5 more steps in each package:
    # measured params within 2.7e-7 (held to 1e-5), the best losses within
    # 8.4e-6 relative (held to 5e-5)
    comp, ccol, part, pcol = _pose_inputs()
    carry = jbr._bpose_init(*map(jnp.asarray, (comp, ccol, part, pcol)),
                            jnp.float32(0.02), jnp.float32(0.01), 32)
    carry = _jax_steps(carry, comp, ccol, part, 3)
    start = _carry_to_numpy(carry)
    ref = _carry_to_numpy(_jax_steps(carry, comp, ccol, part, 5))
    got = tpose.pose_carry_steps(_port_carry(start), _t(comp), _t(ccol),
                                 _t(part), 0.02, 0.01, 5, 32)
    assert (got["opt"]["count"].numpy() == ref["count"]).all()
    for k in KEYS:
        np.testing.assert_allclose(got["params"][k].numpy(),
                                   ref["params"][k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["best_params"][k].numpy(),
                                   ref["best_params"][k], atol=1e-5)
    np.testing.assert_allclose(got["best"].numpy(), ref["best"], rtol=5e-5)


def test_pose_step_makes_no_host_copy(monkeypatch):
    # every constant of the step is made on the device (a CUDA graph can
    # capture the step only so): with torch.tensor and torch.as_tensor
    # raising, 3 steps give the bits they give without the patch
    comp, ccol, part, pcol = map(_t, _pose_inputs())
    carry = tpose.pose_carry_init(comp, ccol, part, pcol, 0.02, 32)
    want = tpose.pose_carry_steps(carry, comp, ccol, part, 0.02, 0.01, 3, 32)

    def host_copy(*_a, **_k):
        raise AssertionError("a host-to-device copy in the pose step")

    with monkeypatch.context() as mp:
        mp.setattr(torch, "tensor", host_copy)
        mp.setattr(torch, "as_tensor", host_copy)
        got = tpose.pose_carry_steps(carry, comp, ccol, part, 0.02, 0.01, 3,
                                     32)
    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    assert same(want, got)


@pytest.mark.parametrize("prune_to", [0, 1])
def test_batched_pose_optim_matches(prune_to):
    # 40 iterations: the coarse phase (28 steps on the FPS subsample)
    # runs, then 12 full-phase steps; with and without start pruning.
    # Both phases at 32² and a chunk of 4 steps, so the reference compiles
    # one step program (the chunk is a host loop there and only gates the
    # coarse phase here).  Final transforms: measured within 4.6e-7,
    # held to 1e-5
    comp, ccol, part, pcol = _pose_inputs()
    kw = dict(prune_to=prune_to, chunk=4, coarse_res=32)
    Tj = jbr.batched_pose_optim(*map(jnp.asarray, (comp, ccol, part, pcol)),
                                jnp.float32(0.02), jnp.float32(0.01), 40, 32,
                                **kw)
    Tt = tbr.batched_pose_optim(_t(comp), _t(ccol), _t(part), _t(pcol),
                                0.02, 0.01, 40, 32, **kw)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)

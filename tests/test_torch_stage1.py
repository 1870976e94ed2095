"""Parity of the port's stage 1 (cameras, z-buffer visibility, splats,
inpaint, the batched stage-1 core) with the JAX reference on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.geometry import cameras as jcam
from genpc_tpu.ops import hpr as jhpr
from genpc_tpu.render import inpaint as jinpaint
from genpc_tpu.render import splat as jsplat
from genpc_tpu_torch.geometry import cameras as tcam
from genpc_tpu_torch.io.synthetic_data import make_object
from genpc_tpu_torch.ops import hpr as thpr
from genpc_tpu_torch.ops.fps import fps_indices
from genpc_tpu_torch.render import inpaint as tinpaint
from genpc_tpu_torch.render import splat as tsplat


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cloud(seed, n):
    part, _, _, _ = make_object(seed, n_gt=2 * n)
    idx = np.random.default_rng(0).choice(len(part), n,
                                          replace=len(part) < n)
    return part[idx]


def test_camera_rig_and_projection_match():
    # the 1,024-view rig crosses the port unchanged: eyes bit-equal,
    # rotations and projections within 1e-6 (fp32 dot association)
    cam_j, eyes_j = jcam.create_cameras(1024, 1.6, 49.1, 256)
    cam_t, eyes_t = tcam.create_cameras(1024, 1.6, 49.1, 256)
    np.testing.assert_array_equal(eyes_t, eyes_j)
    np.testing.assert_allclose(cam_t.rot.numpy(), np.asarray(cam_j.rot),
                               atol=1e-6)
    np.testing.assert_allclose(cam_t.fov.numpy(), np.asarray(cam_j.fov))
    pts = _cloud(0, 500)
    tj = jcam.transform_points(cam_j[np.arange(0, 1024, 37)],
                               jnp.asarray(pts))
    tt = tcam.transform_points(cam_t[torch.arange(0, 1024, 37)], _t(pts))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    uj, dj = jcam.rescale_uvs(tj, 0.15)
    ut, dt = tcam.rescale_uvs(tt, 0.15)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)


@pytest.mark.parametrize("splat", [0, 1])
def test_zbuffer_visibility_matches(splat):
    # z-buffer min is exact; pixel bins come from the same fp32 math, so
    # the visible sets and the per-view counts are equal
    pts = _cloud(1, 3000)
    views = tcam.fibonacci_sphere(64, 1.6).astype(np.float32)
    res = thpr.auto_zbuffer_res(len(pts))
    vj = np.asarray(jhpr.visible_points_zbuffer(
        jnp.asarray(pts), jnp.asarray(views), res=res, splat=splat))
    vt = thpr.visible_points_zbuffer(_t(pts), _t(views), res=res,
                                     splat=splat).numpy()
    np.testing.assert_array_equal(vt.sum(1), vj.sum(1))
    np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_best_view_index_matches(seed):
    # the selected view is what the rest of the path depends on: equal
    pts = _cloud(seed, 4096)
    order = fps_indices(_t(pts), 1000).numpy()
    sampled = pts[order]
    views = tcam.fibonacci_sphere(1024, 1.6).astype(np.float32)
    bj = int(jhpr.select_best_view(jnp.asarray(sampled), jnp.asarray(views),
                                   n_coarse=250, topk=48))
    bt = int(thpr.select_best_view(_t(sampled), _t(views), n_coarse=250,
                                   topk=48))
    assert bt == bj


def test_raw_depth_images_match_outside_collisions():
    # several points on one pixel have no defined winner in the reference
    # (the port takes the highest point index): images are compared on
    # pixels hit by exactly one point, within 1 ulp (XLA contracts the
    # depth code 0.1+0.8·(1−d̂) into an FMA); the 0/1 hole masks do not
    # depend on the winner (all colours are nonzero) and are equal
    r = np.random.default_rng(3)
    n, res = 1500, 64
    pix = r.integers(0, res, (n, 2)).astype(np.int32)
    depth = r.random(n).astype(np.float32)
    cols = r.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    valid = r.random(n) < 0.8
    oj = jsplat.raw_depth_images(jnp.asarray(pix), jnp.asarray(depth),
                                 jnp.asarray(cols), res=res, point_size=1,
                                 mask_pixel_rate=3, valid=jnp.asarray(valid))
    ot = tsplat.raw_depth_images(_t(pix), _t(depth), _t(cols), res=res,
                                 point_size=1, mask_pixel_rate=3,
                                 valid=_t(valid))
    hits = np.zeros((res, res), int)
    np.add.at(hits, (pix[valid, 0], pix[valid, 1]), 1)
    single = (hits == 1)[::-1]                 # images are flipped
    assert single.sum() > 500 and (hits > 1).sum() > 50
    for a, b in zip(ot[:2], oj[:2]):
        np.testing.assert_allclose(a.numpy()[:, single],
                                   np.asarray(b)[:, single], rtol=1.2e-7)
    for a, b in zip(ot[2:], oj[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_uvs_to_pixels_match():
    uv = np.random.default_rng(4).uniform(0, 1, (500, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tsplat.uvs_to_pixels(_t(uv), 256).numpy(),
        np.asarray(jsplat.uvs_to_pixels(jnp.asarray(uv), 256)))


def test_diffusion_inpaint_matches():
    # same periodic 4-neighbour averages in the same order: atol 1e-5
    r = np.random.default_rng(5)
    img = r.random((3, 48, 48)).astype(np.float32)
    mask = (r.random((3, 48, 48)) < 0.3).astype(np.float32)
    oj = jinpaint.diffusion_inpaint(jnp.asarray(img), jnp.asarray(mask),
                                    iters=60)
    ot = tinpaint.diffusion_inpaint(_t(img), _t(mask), iters=60)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)


def test_make_stage1_core_matches():
    # the tiny config of test_parallel's stage-1 test: equal viewpoints,
    # uv within 1e-5, the inpainted depth within 1e-4 (its tolerances for
    # the sharded-vs-single comparison); masks equal
    from genpc_tpu.config import load_config as jload
    from genpc_tpu.parallel.batched_runner import make_stage1_core as jcore
    from genpc_tpu_torch.config import load_config as tload
    from genpc_tpu_torch.parallel.batched_runner import \
        make_stage1_core as tcore
    kw = dict(save=False, view_num=16, downsample_num=128, res=64,
              input_points=512, inpaint_iters=10)
    _, viewpoints = jcam.create_cameras(num_views=16, distance=1.6,
                                        fovy=49.1, res=256)
    r = np.random.default_rng(0)
    xyz = (r.normal(size=(2, 512, 3)) * 0.2).astype(np.float32)
    rgb = np.full((2, 512, 3), 0.5, np.float32)
    oj = jcore(jload(**kw), viewpoints)(jnp.asarray(xyz), jnp.asarray(rgb))
    ot = tcore(tload(device="cpu", **kw), viewpoints)(_t(xyz), _t(rgb))
    uvj, vpj, rawj, depthj, m1j, m2j = map(np.asarray, oj)
    uvt, vpt, rawt, deptht, m1t, m2t = (t.numpy() for t in ot)
    np.testing.assert_array_equal(vpt, vpj)
    np.testing.assert_allclose(uvt, uvj, atol=1e-5)
    np.testing.assert_array_equal(m1t, m1j)
    np.testing.assert_array_equal(m2t, m2j)
    np.testing.assert_allclose(deptht, depthj, atol=1e-4)

"""Parity of the port's pose renderer (genpc_tpu_torch/render:
point_renderer, splat_kernel's plain twins of K4/K5) with the JAX
reference on the CPU, on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.render import point_renderer as jpr
from genpc_tpu.render import splat_kernel as jsk
from genpc_tpu_torch.render import point_renderer as tpr
from genpc_tpu_torch.render import splat_kernel as tsk

F, SLOTS, GAMMA = 2, 6, 1e-2


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _cloud(seed, n, spread=0.3):
    r = np.random.default_rng(seed)
    pts = (r.normal(size=(n, 3)) * spread).astype(np.float32)
    return pts, r.random((n, 3)).astype(np.float32)


def _jax_table(pts, cols, res):
    attrs = jpr._project_attrs(jnp.asarray(pts), 0.02,
                               jpr.RenderCamera.default(res), F)
    return attrs, jpr._build_table(*attrs[:4], jnp.asarray(cols), attrs[4],
                                   res, F, SLOTS)


@pytest.mark.parametrize("seed,n,res,spread", [
    (0, 500, 32, 0.3), (1, 2048, 64, 0.3),
    (2, 3000, 32, 0.05)])           # dense: slot overflow drops points
def test_project_attrs_and_build_table_match(seed, n, res, spread):
    # projection: measured bit-equal, held to 2 ulp; the table, keep and
    # slot_orig built from the same attributes: exactly equal
    pts, cols = _cloud(seed, n, spread)
    attrs_j, (tab_j, keep_j, slot_j) = _jax_table(pts, cols, res)
    attrs_t = tpr._project_attrs(_t(pts)[None], 0.02,
                                 tpr.RenderCamera.default(res), F)
    for a, b in zip(attrs_j, attrs_t):
        if a.dtype == jnp.bool_:
            np.testing.assert_array_equal(b[0].numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a),
                                       rtol=2.4e-7, atol=0)
    tab_t, keep_t, slot_t, order_t = tpr._build_table(
        *[_t(a)[None] for a in attrs_j[:4]], _t(cols)[None],
        _t(attrs_j[4])[None], res, F, SLOTS)
    np.testing.assert_array_equal(tab_t[0].numpy(), np.asarray(tab_j))
    # order: the points sorted by pixel, the kept ones first by slot
    assert torch.equal(order_t.sort(dim=1).values, torch.arange(n)[None])
    sorted_slot = slot_t.gather(1, order_t) % (res * res)
    kept = keep_t.gather(1, order_t)
    assert (sorted_slot[kept].diff() >= 0).all()
    np.testing.assert_array_equal(keep_t[0].numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(slot_t[0].numpy(), np.asarray(slot_j))
    if spread < 0.1:
        assert not keep_t.all()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_splat_twins_match_pallas_interpret():
    # K4/K5 twins against assemble/assemble_bwd run in Pallas interpret
    # mode (res 32, f=2, S=6, 500 points): the same order of sums, exp
    # rounding only; measured max error 1.1e-7 of the largest value,
    # held to 1e-6.  dmax is a max: exact.
    pts, cols = _cloud(0, 500)
    res = 32
    _, (tab, _, _) = _jax_table(pts, cols, res)
    r = np.random.default_rng(9)
    g_acc = r.normal(size=(1, 3, res, res)).astype(np.float32)
    g_w = r.normal(size=(1, res, res)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        (acc_j, wacc_j), dmax_j = jsk.assemble(tab[None], res, F, SLOTS,
                                               GAMMA)
        dt_j = jsk.assemble_bwd(tab[None], (jnp.asarray(g_acc),
                                            jnp.asarray(g_w)), dmax_j, res,
                                F, SLOTS, GAMMA)
    table = _t(tab)[None]
    (acc_t, wacc_t), dmax_t = tsk.assemble(table, res, F, GAMMA)
    dt_t = tsk.assemble_bwd(table, (_t(g_acc), _t(g_w)), dmax_t, res, F,
                            GAMMA)
    np.testing.assert_array_equal(dmax_t.numpy(), np.asarray(dmax_j))
    assert _rel(acc_t.numpy(), acc_j) <= 1e-6
    assert _rel(wacc_t.numpy(), wacc_j) <= 1e-6
    dt_j = np.asarray(dt_j)
    for c in range(tsk.CH):
        assert _rel(dt_t.numpy()[:, :, c], dt_j[:, :, c]) <= 1e-6, c


@pytest.mark.parametrize("res", [32, 64])
def test_render_and_grad_match_xla_slots(res):
    # the reference's CPU path is the dense XLA slots renderer, which sums
    # offset-outer (the port sums slot-outer, as the Pallas kernel):
    # measured image error 1.1e-6 (res 32) and 3.2e-6 (res 64) of the
    # largest value, held to 1e-5; gradient error 1.2e-6 and 2.3e-6 of
    # the largest component, held to 1e-4
    pts, cols = _cloud(res, 1500)
    w = np.random.default_rng(res + 1).random((res, res, 3)).astype(
        np.float32)
    camj = jpr.RenderCamera.default(res)

    def jloss(p):
        img = jpr.render_points(p, jnp.asarray(cols), 0.02, camj,
                                footprint=F, method="slots")
        return jnp.sum(img * w), img

    (_, img_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pts))
    pt = _t(pts).requires_grad_(True)
    img_t = tpr.render_points(pt, _t(cols), 0.02,
                              tpr.RenderCamera.default(res), footprint=F,
                              method="slots")
    (img_t * _t(w)).sum().backward()
    assert _rel(img_t.detach().numpy(), img_j) <= 1e-5
    g_j = np.asarray(g_j)
    assert np.abs(pt.grad.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max()


def test_batched_render_equals_single_renders():
    # renders are independent along the batch axis: bit-equal
    clouds = [_cloud(s, 700) for s in (3, 4)]
    cam = tpr.RenderCamera.default(48)
    batch = tpr.render_points(_t(np.stack([c[0] for c in clouds])),
                              _t(np.stack([c[1] for c in clouds])), 0.02,
                              cam, footprint=F, method="slots")
    for i, (p, c) in enumerate(clouds):
        assert torch.equal(batch[i], tpr.render_points(
            _t(p), _t(c), 0.02, cam, footprint=F, method="slots"))


def test_render_and_grad_repeat_bitwise():
    pts, cols = _cloud(5, 2000)
    cam = tpr.RenderCamera.default(64)
    outs = []
    for _ in range(2):
        p = _t(pts).requires_grad_(True)
        img = tpr.render_points(p, _t(cols), 0.02, cam, footprint=F,
                                method="slots")
        img.square().sum().backward()
        outs.append((img.detach(), p.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_masks_match():
    # luminance, soft and hard masks of one image: within 1e-6
    img = np.random.default_rng(6).random((40, 40, 3)).astype(np.float32)
    for fj, ft in ((jpr.luminance, tpr.luminance),
                   (jpr.soft_mask, tpr.soft_mask),
                   (jpr.hard_mask, tpr.hard_mask)):
        np.testing.assert_allclose(ft(_t(img)).numpy(),
                                   np.asarray(fj(jnp.asarray(img))),
                                   atol=1e-6)


@pytest.mark.parametrize("fn", [
    lambda t: tsk.assemble(t, 4, F, GAMMA),
    lambda t: tsk.assemble_bwd(
        t, (torch.zeros((1, 3, 4, 4), device="meta"),
            torch.zeros((1, 4, 4), device="meta")),
        torch.zeros((1, 4, 4), device="meta"), 4, F, GAMMA),
    lambda t: tsk.assemble_bwd_points(
        t, torch.zeros((1, 5), dtype=torch.int64, device="meta"),
        (torch.zeros((1, 3, 4, 4), device="meta"),
         torch.zeros((1, 4, 4), device="meta")),
        torch.zeros((1, 4, 4), device="meta"), 4, F, SLOTS, GAMMA),
])
def test_splat_wrappers_raise_off_cpu_and_cuda(fn):
    # like K1-K3: the plain twin only for a CPU tensor, never a fallback
    t = torch.zeros((1, SLOTS, tsk.CH, 4 + 2 * F, 4 + 2 * F), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(t)


def _dropping_cloud(seed, n, res):
    """A cloud whose table drops points both ways: 10 points on one pixel
    (more than SLOTS) and 5 behind the camera (z > eye)."""
    pts, cols = _cloud(seed, n)
    r = np.random.default_rng(seed + 100)
    pts[:10] = np.float32([0.1, 0.1, 0.0]) + \
        r.uniform(-1e-3, 1e-3, (10, 3)).astype(np.float32)
    pts[10:15, 2] = 3.5
    attrs = jpr._project_attrs(jnp.asarray(pts), 0.02,
                               jpr.RenderCamera.default(res), F)
    return pts, cols, attrs


def test_bwd_points_twin_matches_pallas_interpret():
    # K5's twin (dense twin + gather) against the reference's assemble_bwd
    # in Pallas interpret mode gathered at the same slot positions, as the
    # reference's _slots_pallas_bwd gathers: within 1e-6 of each channel's
    # largest value (the twin test's bound: exp rounding only), exact
    # zeros for dropped points
    res = 32
    pts, cols, attrs = _dropping_cloud(1, 600, res)
    tab, keep, slot_orig = jpr._build_table(*attrs[:4], jnp.asarray(cols),
                                            attrs[4], res, F, SLOTS)
    keep = np.asarray(keep)
    assert not keep[:10].all() and not keep[10:15].any()
    r = np.random.default_rng(10)
    g_acc = r.normal(size=(1, 3, res, res)).astype(np.float32)
    g_w = r.normal(size=(1, res, res)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, dmax = jsk.assemble(tab[None], res, F, SLOTS, GAMMA)
        dt = jsk.assemble_bwd(tab[None], (jnp.asarray(g_acc),
                                          jnp.asarray(g_w)), dmax, res, F,
                              SLOTS, GAMMA)[0]
    flat = np.concatenate([np.asarray(dt).transpose(1, 0, 2, 3).reshape(
        tsk.CH, -1), np.zeros((tsk.CH, 1), np.float32)], axis=1)
    ref = flat[:, np.asarray(slot_orig)]                       # [7,N]
    got = tsk.assemble_bwd_points_plain(
        _t(tab)[None], _t(slot_orig).long()[None], (_t(g_acc), _t(g_w)),
        _t(dmax), res, F, SLOTS, GAMMA)[0].numpy()
    assert got.shape == ref.shape
    assert (got[:, ~keep] == 0).all()
    for c in range(tsk.CH):
        assert _rel(got[c], ref[c]) <= 1e-6, c


def test_plain_twins_on_the_strided_table_equal_contiguous():
    # _build_table returns a view (render stride size + 1) that the
    # kernels read in place; the twins give the same bits on it and on
    # its contiguous copy
    res = 32
    _, cols, attrs = _dropping_cloud(2, 800, res)
    pa = [_t(np.stack([np.asarray(a)] * 2)) for a in attrs]
    table, _, slot_orig, order = tpr._build_table(
        *pa[:4], _t(np.stack([cols] * 2)), pa[4], res, F, SLOTS)
    dense = table.contiguous()
    assert not table.is_contiguous()
    assert table.stride(0) == dense.stride(0) + 1
    (acc, wacc), dmax = tsk.assemble(table, res, F, GAMMA)
    (acc_c, wacc_c), dmax_c = tsk.assemble(dense, res, F, GAMMA)
    assert torch.equal(acc, acc_c) and torch.equal(wacc, wacc_c) and \
        torch.equal(dmax, dmax_c)
    r = np.random.default_rng(11)
    cots = (_t(r.normal(size=(2, 3, res, res)).astype(np.float32)),
            _t(r.normal(size=(2, res, res)).astype(np.float32)))
    g = tsk.assemble_bwd_points(table, slot_orig, cots, dmax, res, F, SLOTS,
                                GAMMA, order)
    assert torch.equal(g, tsk.assemble_bwd_points(dense, slot_orig, cots,
                                                  dmax, res, F, SLOTS, GAMMA))
    assert g.shape == (2, tsk.CH, 800) and g.abs().sum() > 0


@pytest.mark.parametrize("res", [32, 50, 64, 112, 224])
@pytest.mark.parametrize("f", [1, 2, 3])
def test_splat_plan_covers_every_pixel_once(res, f):
    # the grid's threads map onto the pixels one to one, each pixel's
    # window lies in its tile's halo, a halo row fits one 64-bit word and
    # the block fits the card (1,024 threads, 227 KB of shared memory,
    # 2^31 - 1 blocks in x; the renders go in y, at most 65,535)
    plan = tsk.splat_plan(res, f)
    tw, th = plan["tile_w"], plan["tile_h"]
    assert plan["halo_w"] == tw + 2 * f <= 64
    assert plan["halo_h"] == th + 2 * f
    assert plan["threads"] == tw * th <= 1024 and plan["threads"] % 32 == 0
    assert plan["smem"] <= 232448 and plan["blocks"] < 2 ** 31
    cover = np.zeros((res, res), np.int64)
    for blk in range(plan["blocks"]):
        ty, tx = divmod(blk, plan["tiles_x"])
        t = np.arange(plan["threads"])
        qx, qy = tx * tw + t % tw, ty * th + t // tw
        ok = (qx < res) & (qy < res)
        np.add.at(cover, (qy[ok], qx[ok]), 1)
        # padded window of pixel q: rows qy..qy+2f, columns qx..qx+2f
        assert (qx[ok] + 2 * f < tx * tw + plan["halo_w"]).all()
        assert (qy[ok] + 2 * f < ty * th + plan["halo_h"]).all()
    assert (cover == 1).all()


def test_splat_plan_raises_beyond_one_word():
    # a halo row of 32 + 2f columns must fit one 64-bit presence word
    assert tsk.splat_plan(224, 16)["halo_w"] == 64
    with pytest.raises(ValueError, match="64-bit word"):
        tsk.splat_plan(224, 17)

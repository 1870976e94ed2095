"""Parity of the port's ops (genpc_tpu_torch/ops, CPU plain versions)
with the JAX reference's CPU paths, on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.ops import chamfer as jchamfer
from genpc_tpu.ops.emd import _bid_phase
from genpc_tpu.ops.emd_kernel import bid_pallas
from genpc_tpu.ops.emd import emd_auction as jemd
from genpc_tpu.ops.fps import _fps_indices_xla
from genpc_tpu.ops.knn import knn as jknn
from genpc_tpu.ops.outliers import statistical_outlier_mask as jmask
from genpc_tpu_torch.ops.chamfer import (_nn, chamfer_nn, nearest_neighbor,
                                         nn_plan)
from genpc_tpu_torch.ops.emd import emd_auction
from genpc_tpu_torch.ops.emd_kernel import (bid, bid_plain, bid_plain_direct,
                                            bid_plan, spatial_order)
from genpc_tpu_torch.ops.fps import farthest_point_sample, pad_repeat
from genpc_tpu_torch.ops.fps_kernel import fps_batched, fps_plan
from genpc_tpu_torch.ops.knn import knn
from genpc_tpu_torch.ops.outliers import statistical_outlier_mask


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("shape", [(2, 300, 500), (1, 1000, 64)])
def test_nearest_neighbor_matches_xla(shape):
    # both sides compute the direct fp32 form, first index on ties: the
    # indices are equal; distances within 1e-6 relative (sum association)
    b, n, m = shape
    r = np.random.default_rng(n)
    x = r.random((b, n, 3)).astype(np.float32)
    y = r.random((b, m, 3)).astype(np.float32)
    dj, ij = jchamfer._nn_xla(jnp.asarray(x), jnp.asarray(y))
    dt, it = nearest_neighbor(_t(x), _t(y))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


def test_nn_y_index_matches_materialised_copies():
    # the symmetry sweep searches one y per object for many x batches
    r = np.random.default_rng(3)
    x = _t(r.random((6, 200, 3)).astype(np.float32))
    y = _t(r.random((2, 300, 3)).astype(np.float32))
    yi = torch.tensor([0, 1, 1, 0, 1, 0], dtype=torch.int32)
    d, i = _nn(x, y, yi)
    d2, i2 = _nn(x, y[yi.long()])
    assert torch.equal(d, d2) and torch.equal(i, i2)


def test_chamfer_nn_forward_and_grad_match_jax():
    # gradients are the same gather/scatter-add formula: atol 1e-5
    r = np.random.default_rng(1)
    x = r.random((2, 64, 3)).astype(np.float32)
    y = r.random((2, 80, 3)).astype(np.float32)
    w1 = r.random((2, 64)).astype(np.float32)
    w2 = r.random((2, 80)).astype(np.float32)

    def jloss(a, b):
        d1, d2, _, _ = jchamfer.chamfer_nn(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    gxj, gyj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = _t(x).requires_grad_(True)
    yt = _t(y).requires_grad_(True)
    d1, d2, i1, i2 = chamfer_nn(xt, yt)
    (torch.sum(d1 * _t(w1)) + torch.sum(d2 * _t(w2))).backward()
    _, _, j1, j2 = jchamfer.chamfer_nn(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(j2))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), atol=1e-5)


@pytest.mark.parametrize("n,k", [(1000, 256), (100, 150)])
def test_fps_matches_xla_sequence(n, k):
    # same update math and lowest-index tie-break: the exact sequence,
    # including k > N (repeated picks once every point is chosen)
    r = np.random.default_rng(n)
    pts = r.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    ref = np.stack([np.asarray(_fps_indices_xla(jnp.asarray(p), k))
                    for p in pts])
    np.testing.assert_array_equal(fps_batched(_t(pts), k).numpy(), ref)


def test_fps_pad_repeated_ragged_batch_matches_per_object():
    # one batched call over clouds padded by repetition picks each
    # object's own sequence, which is the reference's, and never a copy
    r = np.random.default_rng(11)
    clouds = [r.uniform(-1, 1, (n, 3)).astype(np.float32)
              for n in (700, 1000, 1300)]
    padded = pad_repeat(clouds)
    assert padded.shape == (3, 1300, 3)
    np.testing.assert_array_equal(padded[0, 700:1400], clouds[0][:600])
    got = fps_batched(_t(padded), 300).numpy()
    for row, c in zip(got, clouds):
        alone = fps_batched(_t(c[None]), 300).numpy()[0]
        ref = np.asarray(_fps_indices_xla(jnp.asarray(c), 300))
        np.testing.assert_array_equal(row, alone)
        np.testing.assert_array_equal(row, ref)
        assert row.max() < len(c)


@pytest.mark.parametrize("n,cluster,slice_,ppt", [
    (2048, 1, 2048, 4),          # the pose path's FPS
    (65536, 4, 16384, 32),       # stage 1
    (163840, 16, 10240, 32),     # the metric
    (229376, 16, 14336, 32),     # a fusion cloud
    (300000, 16, 18750, 32),     # beyond on-chip: 2,366 a block stream
])
def test_fps_plan_spreads_objects_over_clusters(n, cluster, slice_, ppt):
    # the smallest power-of-two cluster whose slices fit on-chip
    # (512 threads x 32 points), at most 16 blocks
    plan = fps_plan(n)
    assert (plan["cluster"], plan["slice"], plan["ppt"]) == \
        (cluster, slice_, ppt)
    assert plan["on_chip"] == min(slice_, 16384)
    assert fps_plan(n, 3)["slice"] == -(-n // 3)
    with pytest.raises(ValueError):
        fps_plan(n, 17)


def test_farthest_point_sample_small_cloud_returns_all():
    pts = _t(np.random.default_rng(0).random((10, 3)).astype(np.float32))
    out, idx = farthest_point_sample(pts, 16)
    assert out.shape == (10, 3) and idx.tolist() == list(range(10))


def test_bid_phase_matches_reference():
    # the plain version mirrors _bid_phase (expansion form): >= 99.5 %
    # identical bids, best/second within 2e-4 (the kernel contract)
    r = np.random.default_rng(2)
    x1 = r.random((2, 600, 3)).astype(np.float32)
    x2 = r.random((2, 700, 3)).astype(np.float32)
    pr = (r.random((2, 700)) * 0.1).astype(np.float32)
    bj, bestj, betj = jax.vmap(_bid_phase)(jnp.asarray(x1), jnp.asarray(x2),
                                           jnp.asarray(pr))
    bt, bestt, bett = bid(_t(x1), _t(x2), _t(pr))
    assert (bt.numpy() == np.asarray(bj)).mean() >= 0.995
    np.testing.assert_allclose(bestt.numpy(), np.asarray(bestj), atol=2e-4)
    np.testing.assert_allclose(bett.numpy(), np.asarray(betj), atol=2e-4)


#: K1 launch shapes of the registration pass (B, N, M): the metric, a
#: one-cloud dedup, the symmetry sweep, the fine grid, ICP, the pose loss
#: (both directions, 512 and 2,048 points), and two small ones
PLAN_SHAPES = [(13, 16384, 16384), (1, 163840, 65536), (1, 65536, 65536),
               (4056, 4096, 4096), (1521, 4096, 4096), (3250, 2048, 2048),
               (143, 2048, 2048), (13, 2048, 2048), (52, 512, 512),
               (52, 2048, 2048), (1, 10, 5), (3, 300, 4097)]
#: shapes whose launch must fill the 132 SMs: the pose loss's and the
#: dedups'
FILL_SHAPES = {(1, 163840, 65536), (1, 65536, 65536), (52, 512, 512),
               (52, 2048, 2048)}


def _rows_covered(n, plan):
    """How often each row of one batch is owned by a thread of the plan
    (thread t of row tile k owns k * rows * threads + t + r * threads)."""
    t, r = plan["threads"], plan["rows"]
    tile = np.arange(plan["tiles"])[:, None, None] * (t * r)
    rows = (tile + np.arange(t)[None, :, None]
            + np.arange(r)[None, None, :] * t).ravel()
    return np.bincount(rows[rows < n], minlength=n)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_nn_plan_covers_every_row_and_column_once(shape):
    b, n, m = shape
    plan = nn_plan(b, n, m)
    assert (_rows_covered(n, plan) == 1).all()
    # the splits tile M exactly, none empty, also when a split is forced
    # (chunks round up to whole shared tiles, so 3 may become fewer)
    forced = nn_plan(b, n, m, splits=3)
    assert forced["splits"] <= 3
    for p in (plan, forced):
        starts = np.arange(p["splits"]) * p["chunk"]
        ends = np.minimum(m, starts + p["chunk"])
        assert starts[0] == 0 and ends[-1] == m and (ends > starts).all()
        assert (starts[1:] == ends[:-1]).all()
        assert p["chunk"] % (2 * p["threads"]) == 0
    # CUDA limits: grid.x, block size, and the kernel's templates
    assert plan["blocks"] == b * plan["splits"] * plan["tiles"] < 2 ** 31
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256
    assert plan["rows"] in (2, 4)
    if shape in FILL_SHAPES:
        assert plan["blocks"] >= 132


@pytest.mark.parametrize("shape", [(13, 16384, 16384), (2, 300, 2100),
                                   (1, 1, 7), (40000, 64, 64)])
def test_bid_plan_covers_every_row_once(shape):
    b, n, m = shape
    plan = bid_plan(b, n, m)
    assert (_rows_covered(n, plan) == 1).all()
    assert plan["blocks"] == b * plan["tiles"] < 2 ** 31
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256
    assert (plan["rows"], plan["group"]) == (2, 4)
    if b * n >= 132 * 128 * plan["rows"]:
        assert plan["blocks"] >= 132
    with pytest.raises(ValueError):
        bid_plan(b, n, m, threads=48)


def test_spatial_order_is_a_permutation_along_a_z_curve():
    # each batch's rows once; consecutive rows are near in space
    r = np.random.default_rng(9)
    x = _t(r.random((2, 4096, 3)).astype(np.float32))
    order = spatial_order(x)
    assert order.dtype == torch.int32
    for b in range(2):
        assert torch.equal(order[b].sort().values, torch.arange(4096,
                                                                dtype=torch.int32))
    y = torch.gather(x, 1, order.long()[..., None].expand(-1, -1, 3))
    step = (y[:, 1:] - y[:, :-1]).norm(dim=-1).mean()
    assert step < 0.25 * (x[:, 1:] - x[:, :-1]).norm(dim=-1).mean()
    # the first eight in z order sit in one corner octant
    assert (x[0, order[0, :8].long()] < 0.5).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bid_plain_direct_within_contract_of_bid_plain(seed):
    # direct distance against the reference's expansion: the kernel
    # contract, >= 99.5 % identical bids, values within 2e-4
    r = np.random.default_rng(seed)
    x1 = _t(r.random((2, 700, 3)).astype(np.float32))
    x2 = _t(r.random((2, 900, 3)).astype(np.float32))
    pr = _t((r.random((2, 900)) * 0.1).astype(np.float32))
    bd, bestd, betd = bid_plain_direct(x1, x2, pr)
    bp, bestp, betp = bid_plain(x1, x2, pr)
    assert (bd == bp).float().mean().item() >= 0.995
    torch.testing.assert_close(bestd, bestp, atol=2e-4, rtol=0)
    torch.testing.assert_close(betd, betp, atol=2e-4, rtol=0)


def test_bid_plain_direct_matches_pallas_interpret():
    # the reference's own kernel in interpret mode, across a 2,048-column
    # chunk: the same direct form, but XLA on the CPU may contract the
    # squares into FMAs, so near-tied bids may differ (>= 99.5 % equal)
    # and values agree within 1e-6
    from jax.experimental.pallas import tpu as pltpu
    r = np.random.default_rng(12)
    x1 = r.random((2, 300, 3)).astype(np.float32)
    x2 = r.random((2, 2100, 3)).astype(np.float32)
    pr = (r.random((2, 2100)) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        bj, bestj, betj = bid_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(pr))
    bt, bestt, bett = bid_plain_direct(_t(x1), _t(x2), _t(pr))
    assert (bt.numpy() == np.asarray(bj)).mean() >= 0.995
    np.testing.assert_allclose(bestt.numpy(), np.asarray(bestj), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(bett.numpy(), np.asarray(betj), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 4])
def test_emd_auction_matches_reference(seed):
    # the plain bid phase rounds as the reference's CPU path does, so the
    # auctions take the same path (seeds 0-7: equal assignments, EMDs
    # within 1e-7 relative); the stated contract: assignments agree on
    # >= 99 %, the EMD (mean sqrt d) within 1e-3 relative
    r = np.random.default_rng(seed)
    x = r.random((2, 512, 3)).astype(np.float32)
    y = r.random((2, 512, 3)).astype(np.float32)
    dj, aj = jemd(jnp.asarray(x), jnp.asarray(y), eps=0.005, iters=50)
    dt, at = emd_auction(_t(x), _t(y), eps=0.005, iters=50)
    assert (at.numpy() == np.asarray(aj)).mean() >= 0.99
    ej = np.sqrt(np.maximum(np.asarray(dj), 0)).mean(1)
    et = np.sqrt(np.maximum(dt.numpy(), 0)).mean(1)
    np.testing.assert_allclose(et, ej, rtol=1e-3)


def test_emd_gradient_flows_to_xyz1_only():
    r = np.random.default_rng(5)
    x = _t(r.random((1, 128, 3)).astype(np.float32)).requires_grad_(True)
    y = _t(r.random((1, 128, 3)).astype(np.float32)).requires_grad_(True)
    d, a = emd_auction(x, y, iters=20)
    d.sum().backward()
    matched = y.detach()[0, a[0].clamp_min(0).long()]
    torch.testing.assert_close(x.grad[0], 2.0 * (x.detach()[0] - matched))
    assert torch.count_nonzero(y.grad) == 0


def test_knn_matches_reference():
    # same direct distances; ties ordered lower index first as lax.top_k
    r = np.random.default_rng(6)
    q = r.random((500, 3)).astype(np.float32)
    ref = np.concatenate([q[:50], r.random((650, 3)).astype(np.float32)])
    dj, ij = jknn(jnp.asarray(q), jnp.asarray(ref), 8)
    dt, it = knn(_t(q), _t(ref), 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)


@pytest.mark.parametrize("k", [2, 5])
def test_knn_ties_at_the_kth_place_match_reference(k):
    # points of an integer grid: many neighbours at exactly the k-th
    # distance, of which lax.top_k takes the lowest indices
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    g = g[np.random.default_rng(8).permutation(len(g))]
    dj, ij = jknn(jnp.asarray(g), jnp.asarray(g), k)
    dt, it = knn(_t(g), _t(g), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_outlier_mask_matches_reference():
    r = np.random.default_rng(7)
    pts = np.concatenate([r.normal(size=(2000, 3)) * 0.1,
                          r.uniform(-2, 2, (40, 3))]).astype(np.float32)
    mj = np.asarray(jmask(jnp.asarray(pts), 20, 2.5))
    mt = statistical_outlier_mask(_t(pts), 20, 2.5).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert 0 < (~mt).sum() < 100


@pytest.mark.parametrize("fn", [
    lambda t: _nn(t, t),
    lambda t: fps_batched(t, 4),
    lambda t: bid(t, t, t[..., 0]),
])
def test_kernel_wrappers_raise_off_cpu_and_cuda(fn):
    # a wrapper takes its plain version only for a CPU tensor; any other
    # device launches the kernel or raises, never falls back
    t = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(t)


def test_rowsum_card_form_matches_plain_sums(monkeypatch):
    # ops/rowsum's card form (rows padded to 16, sums over the last
    # axis), run here on CPU tensors: the plain reductions' values within
    # 1e-5 relative, their shapes, keepdim and gradients
    from genpc_tpu_torch.ops import rowsum
    r = np.random.default_rng(9)
    x = _t(r.normal(size=(3, 5, 7, 3)).astype(np.float32))
    a = _t(r.normal(size=(2, 4, 3)).astype(np.float32))
    b = _t(r.normal(size=(2, 3, 5)).astype(np.float32))
    plain = {"sum": x.sum((1, 2), keepdim=True), "mean": x.mean((1,)),
             "std": x.std(dim=(1, 2), keepdim=True, correction=0),
             "mm": a @ b, "last": x.sum(-1)}
    monkeypatch.setattr(rowsum, "_on_card", lambda _x: True)
    xg = x.clone().requires_grad_(True)
    card = {"sum": rowsum.sum_dims(xg, (1, 2), keepdim=True),
            "mean": rowsum.mean_dims(x, (1,)),
            "std": rowsum.std_dims(x, (1, 2), keepdim=True),
            "mm": rowsum.matmul(a, b), "last": rowsum.sum_last(x)}
    for k, v in plain.items():
        assert card[k].shape == v.shape, k
        torch.testing.assert_close(card[k], v, rtol=1e-5, atol=1e-6)
    card["sum"].sum().backward()
    assert torch.equal(xg.grad, torch.ones_like(x))

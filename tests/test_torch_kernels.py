"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA GPU (marker ``cuda``) and skips
without one.  The machine with the card has no JAX, so run these
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu_torch import tracing
from genpc_tpu_torch.models.quant import (W4_ROW_TILES, _scale_bias,
                                          _w4_gemm, _w4_gemv, matmul_f32,
                                          pack_int4, unpack_int4, w4_linear)
from genpc_tpu_torch.ops.chamfer import (_launch, _nn, _nn_plain, _sq_dist,
                                         chamfer_nn, nn_plan)
from genpc_tpu_torch.ops.emd_kernel import _launch as bid_launch
from genpc_tpu_torch.ops.emd_kernel import (bid, bid_plain, bid_plain_direct,
                                            bid_plan, spatial_order)
from genpc_tpu_torch.ops.fps import pad_repeat
from genpc_tpu_torch.ops.fps_kernel import _launch as fps_launch
from genpc_tpu_torch.ops.fps_kernel import (fps_batched, fps_batched_plain,
                                            fps_plan)
from genpc_tpu_torch.render.point_renderer import (
    RenderCamera, _build_table, _project_attrs)
from genpc_tpu_torch.render.splat_kernel import (
    CH, assemble, assemble_bwd_points, assemble_bwd_points_plain,
    assemble_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _rand(seed, *shape, dev="cpu"):
    r = np.random.default_rng(seed)
    return torch.tensor(r.random(shape), dtype=torch.float32, device=dev)


@pytest.mark.parametrize("b,n,m", [(2, 300, 500), (3, 1000, 2500),
                                   (1, 257, 4097)])
def test_k1_equals_plain(dev, b, n, m):
    # the same direct fp32 form without FMA, strict '<': bit-equal
    x, y = _rand(b, b, n, 3, dev=dev), _rand(m, b, m, 3, dev=dev)
    dk, ik = _nn(x, y)
    dp, ip = _nn_plain(x, y)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


def test_k1_y_index_equals_plain(dev):
    x, y = _rand(0, 7, 600, 3, dev=dev), _rand(1, 2, 3000, 3, dev=dev)
    yi = torch.tensor([1, 0, 0, 1, 1, 0, 1], dtype=torch.int32, device=dev)
    dk, ik = _nn(x, y, yi)
    dp, ip = _nn_plain(x, y, yi)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


def _first_argmin(x, y, y_index=None):
    """Exact first-index argmin of every x row and the rows whose minimum
    is attained more than once (the direct fp32 form, in row pieces)."""
    b, n, _ = x.shape
    m = y.shape[1]
    ys = y if y_index is None else y[y_index.long()]
    cols = torch.arange(m, device=x.device)
    first, tied = [], []
    for r0 in range(0, n, 256):
        d = _sq_dist(x[:, r0:r0 + 256], ys)
        eq = d == d.amin(dim=2, keepdim=True)
        first.append(torch.where(eq, cols, m).amin(dim=2))
        tied.append(eq.sum(dim=2) > 1)
    return torch.cat(first, 1), torch.cat(tied, 1)


#: the K1 launch classes of the registration pass (B, N, M, y batches
#: shared through y_index, 0: none); the sweep and the fine grid at a
#: smaller batch that keeps their launch plans
K1_CLASSES = [(13, 16384, 16384, 0), (1, 163840, 65536, 0),
              (1, 65536, 65536, 0), (338, 4096, 4096, 13),
              (650, 2048, 2048, 13), (143, 2048, 2048, 13),
              (13, 2048, 2048, 0), (52, 512, 512, 13), (52, 2048, 2048, 13),
              (52, 2048, 2048, 0)]


@pytest.mark.parametrize("b,n,m,shared", K1_CLASSES)
def test_k1_launch_classes_equal_plain(dev, b, n, m, shared):
    # distances bit-equal to the plain version, every argmin the first
    # index, and the plain version's index wherever the minimum is unique
    # (torch's CUDA min does not promise the first index on ties)
    r = np.random.default_rng(b + n + m)
    x = torch.tensor(r.random((b, n, 3), dtype=np.float32), device=dev)
    y = torch.tensor(r.random((shared or b, m, 3), dtype=np.float32),
                     device=dev)
    yi = (torch.tensor(np.arange(b) * shared // b, dtype=torch.int32,
                       device=dev) if shared else None)
    dk, ik = _nn(x, y, yi)
    dp, ip = _nn_plain(x, y, yi)
    first, tied = _first_argmin(x, y, yi)
    assert torch.equal(dk, dp)
    assert torch.equal(ik.long(), first)
    assert ((ik == ip) | tied).all()


@pytest.mark.parametrize("splits", [2, 3, 4, 8])
def test_k1_split_tie_across_the_boundary(dev, splits):
    # one x row whose nearest y points sit twice, at the last index of
    # one split and the first of the next: the merge keeps the lower
    # index; every split gives the bits of the unsplit launch and the
    # numpy first-index argmin
    r = np.random.default_rng(splits)
    x = r.random((2, 300, 3), dtype=np.float32)
    y = r.random((2, 4096, 3), dtype=np.float32)
    plan = nn_plan(2, 300, 4096, splits=splits)
    assert plan["splits"] == splits
    edge = plan["chunk"]
    x[0, 7] = (2.0, 2.0, 2.0)
    y[0, edge - 1] = y[0, edge] = (2.0, 2.0, 2.001)
    d = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    dk, ik = _launch(xt, yt, None, plan)
    one = _launch(xt, yt, None, nn_plan(2, 300, 4096, splits=1))
    assert ik[0, 7].item() == edge - 1
    np.testing.assert_array_equal(ik.cpu().numpy(), d.argmin(-1))
    assert torch.equal(dk, one[0]) and torch.equal(ik, one[1])
    assert torch.equal(dk, _nn_plain(xt, yt)[0])


@pytest.mark.parametrize("rows,threads", [(2, 64), (2, 256), (4, 64),
                                          (4, 128), (4, 256)])
def test_k1_plans_equal_plain(dev, rows, threads):
    # any rows a thread and block size covers the same rows, short last
    # tiles included
    x, y = _rand(31, 3, 1000, 3, dev=dev), _rand(32, 3, 2500, 3, dev=dev)
    dk, ik = _launch(x, y, None, nn_plan(3, 1000, 2500, rows, threads))
    dp, _ = _nn_plain(x, y)
    first, _ = _first_argmin(x, y)
    assert torch.equal(dk, dp) and torch.equal(ik.long(), first)


def test_chamfer_grad_on_card_equals_host(dev):
    x, y = _rand(2, 2, 200, 3), _rand(3, 2, 300, 3)
    grads = []
    for d in ("cpu", dev):
        xa = x.to(d).detach().requires_grad_(True)
        ya = y.to(d).detach().requires_grad_(True)
        d1, d2, _, _ = chamfer_nn(xa, ya)
        (d1.sum() + 2 * d2.sum()).backward()
        grads.append((xa.grad.cpu(), ya.grad.cpu()))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,n,k", [(2, 1000, 256), (1, 5000, 700),
                                   (2, 100, 150)])
def test_k2_equals_plain(dev, b, n, k):
    # exact sequence, including k > N
    p = _rand(n, b, n, 3, dev=dev) * 2 - 1
    assert torch.equal(fps_batched(p, k), fps_batched_plain(p, k))


@pytest.mark.parametrize("n,cluster", [
    (16384, 1),          # the largest one-block object
    (20000, 2),          # two blocks
    (20003, 2),          # the last block's slice one point short
    (140000, 16),        # the largest cluster
    (140007, 16),        # ... with a short last slice
    (270000, 16),        # slices beyond on-chip: the rest streams from L2
])
def test_k2_cluster_sizes_equal_plain(dev, n, cluster):
    # the plan picks the cluster from N; every size gives the exact
    # sequence of the plain loop
    assert fps_plan(n)["cluster"] == cluster
    p = _rand(n, 2, n, 3, dev=dev) * 2 - 1
    assert torch.equal(fps_batched(p, 300), fps_batched_plain(p, 300))


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8, 16])
def test_k2_forced_cluster_equals_plain(dev, cluster):
    # a given cluster size, non-powers of two, short last slices (16 x 63
    # > 1000) and streamed slices (cluster 1: 40,000 > 16,384 on-chip)
    # included
    for n, k in ((1000, 400), (40000, 200)):
        p = _rand(n + cluster, 2, n, 3, dev=dev) * 2 - 1
        assert torch.equal(fps_launch(p, k, 0, fps_plan(n, cluster)),
                           fps_batched_plain(p, k))


@pytest.mark.parametrize("cluster", [1, 16])
def test_k2_k_above_n(dev, cluster):
    # every point chosen, then index 0 for each further pick; cluster 16
    # leaves the last two blocks without points (slices of 3)
    p = _rand(40, 3, 40, 3, dev=dev)
    out = fps_launch(p, 60, 0, fps_plan(40, cluster))
    assert torch.equal(out, fps_batched_plain(p, 60))
    assert (out[:, 40:] == 0).all()


def test_k2_tie_across_a_block_boundary(dev):
    # the farthest point from the start sits twice, at the last index of
    # block 0 and the first of block 1 (slices of 10,000): the lower
    # index wins, then the copy's distance is 0
    p = _rand(12, 1, 20000, 3, dev=dev)
    p[0, 0] = 0.0
    p[0, 9999] = p[0, 10000] = 5.0
    assert fps_plan(20000)["cluster"] == 2
    out = fps_batched(p, 50)
    assert torch.equal(out, fps_batched_plain(p, 50))
    assert out[0, 1].item() == 9999 and 10000 not in out[0].tolist()


def test_k2_pad_repeated_batch_equals_per_object(dev):
    # one launch over ragged clouds padded by repetition = one launch per
    # cloud, and the padded copies are never chosen
    r = np.random.default_rng(13)
    clouds = [r.uniform(-1, 1, (n, 3)).astype(np.float32)
              for n in (70000, 100000, 131000)]
    out = fps_batched(torch.tensor(pad_repeat(clouds), device=dev), 2000)
    assert fps_plan(131000)["cluster"] == 8
    for row, c in zip(out, clouds):
        alone = fps_batched(torch.tensor(c[None], device=dev), 2000)[0]
        assert torch.equal(row, alone)
        assert row.max().item() < len(c)


@pytest.mark.parametrize("n,k", [(65536, 10000), (65536, 16384)])
def test_k2_ped_duplicate_shape_equals_plain(dev, n, k):
    # a PED-sized scan (400 unique points) drawn with replacement to the
    # pipeline's 65,536 input points, one object: after 400 picks every
    # minimum distance is 0, so each later pick is a tie across all the
    # cluster's blocks, which the first index wins (index 0); the plan's
    # cluster (4) and a forced 16
    r = np.random.default_rng(17)
    base = r.uniform(-0.5, 0.5, (400, 3)).astype(np.float32)
    p = torch.tensor(base[r.choice(400, n, replace=True)][None], device=dev)
    assert fps_plan(n)["cluster"] == 4
    want = fps_batched_plain(p, k)
    assert len(set(want[0, :400].tolist())) == 400
    assert (want[0, 400:] == 0).all()
    assert torch.equal(fps_batched(p, k), want)
    assert torch.equal(fps_launch(p, k, 0, fps_plan(n, 16)), want)


@pytest.mark.parametrize("b,n,m", [(1, 16384, 16384), (1, 4096, 2048)])
def test_k3_single_object_bitwise_equals_plain_direct(dev, b, n, m):
    # the per-object metric's bid (B = 1), with and without the auction's
    # spatial row order: bitwise the plain version's
    x1, x2 = _rand(n, b, n, 3, dev=dev), _rand(m + 1, b, m, 3, dev=dev)
    pr = _rand(n + m + 1, b, m, dev=dev) * 0.1
    want = bid_plain_direct(x1, x2, pr)
    assert _bid_equal(bid(x1, x2, pr), want)
    assert _bid_equal(bid(x1, x2, pr, order=spatial_order(x1)), want)


def test_k3_matches_plain(dev):
    # direct form in the kernel, expansion in the plain version: >= 99.5 %
    # identical bids, values within 2e-4 (the reference kernel contract)
    x1, x2 = _rand(4, 2, 1500, 3, dev=dev), _rand(5, 2, 2600, 3, dev=dev)
    pr = _rand(6, 2, 2600, dev=dev) * 0.1
    bk, bestk, betk = bid(x1, x2, pr)
    bp, bestp, betp = bid_plain(x1, x2, pr)
    assert (bk == bp).float().mean().item() >= 0.995
    torch.testing.assert_close(bestk, bestp, atol=2e-4, rtol=0)
    torch.testing.assert_close(betk, betp, atol=2e-4, rtol=0)


def _bid_equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,n,m", [(2, 1500, 2600), (13, 2048, 4096),
                                   (1, 5, 1), (3, 300, 129)])
def test_k3_bitwise_equals_plain_direct(dev, b, n, m):
    # the same function in the same fp32 order with a correctly rounded
    # root; the square-root filter skips only pairs that cannot change
    # the top two, so every output is bitwise the plain version's
    x1, x2 = _rand(b, b, n, 3, dev=dev), _rand(m, b, m, 3, dev=dev)
    pr = _rand(n + m, b, m, dev=dev) * 0.1
    want = bid_plain_direct(x1, x2, pr)
    assert _bid_equal(bid(x1, x2, pr), want)
    # the threads may take the rows in any order: the auction's spatial
    # one, or a random permutation
    perm = torch.argsort(_rand(n, b, n, dev=dev), dim=1).to(torch.int32)
    for order in (spatial_order(x1), perm):
        assert _bid_equal(bid(x1, x2, pr, order=order), want)
    for threads in (32, 64, 256):
        plan = bid_plan(b, n, m, threads)
        assert _bid_equal(bid_launch(x1, x2, pr, None, plan), want)


def _filter_edge_case(n=64, m=4096, tuned=8, seed=21):
    """Rows 0..tuned-1 sit far from the cloud, each beside its own
    columns (j % 16 == row), whose prices set the values to 2.5 or a
    neighbouring float exactly: ties at the best, a second best equal to
    the best, and pairs whose value sits within one ulp of `second`,
    where the filter's bound is tight."""
    r = np.random.default_rng(seed)
    x1 = r.random((1, n, 3), dtype=np.float32)
    x2 = r.random((1, m, 3), dtype=np.float32)
    pr = (r.random((1, m)) * 0.1).astype(np.float32)
    v = np.float32(2.5)
    values = np.array([np.nextafter(v, np.float32(0)), v,
                       np.nextafter(v, np.float32(4))], np.float32)
    for row in range(tuned):
        x1[0, row] = (5.0 + row, 5.0, 5.0)
        cols = np.arange(row, m, 16)
        x2[0, cols] = x1[0, row] + r.uniform(
            -1e-3, 1e-3, (len(cols), 3)).astype(np.float32)
        d = x1[0, row] - x2[0, cols]
        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        a = np.float32(3) - np.sqrt(d2.astype(np.float64)).astype(np.float32)
        pr[0, cols] = a - values[r.integers(0, 3, len(cols))]
    return x1, x2, pr, values


def test_k3_filter_edge_and_ties_at_the_best(dev):
    x1, x2, pr, values = _filter_edge_case()
    t = [torch.tensor(a, device=dev) for a in (x1, x2, pr)]
    want = bid_plain_direct(*t)
    # the construction: the tuned rows' best is the largest value, tied
    assert (want[1][0, :8] == float(values[2])).all()
    assert (want[2][0, :8] == float(values[2])).all()
    assert _bid_equal(bid(*t), want)
    assert _bid_equal(bid(*t, order=spatial_order(t[0])), want)
    for threads in (32, 256):
        plan = bid_plan(1, 64, 4096, threads)
        assert _bid_equal(bid_launch(*t, None, plan), want)


def test_launch_counters_count_kernel_launches_only(dev):
    x = _rand(7, 1, 64, 3)
    before = (_nn.launches, fps_batched.launches, bid.launches)
    _nn(x, x), fps_batched(x, 8), bid(x, x, x[..., 0])      # host: plain
    assert (_nn.launches, fps_batched.launches, bid.launches) == before
    xd = x.to(dev)
    _nn(xd, xd), fps_batched(xd, 8), bid(xd, xd, xd[..., 0])
    torch.cuda.synchronize()
    assert (_nn.launches, fps_batched.launches, bid.launches) == \
        tuple(c + 1 for c in before)
    # a split launch and its merge count once, per user-level call
    x, y = _rand(8, 13, 16384, 3, dev=dev), _rand(9, 13, 16384, 3, dev=dev)
    assert nn_plan(13, 16384, 16384)["splits"] > 1
    n0 = _nn.launches
    _nn(x, y)
    torch.cuda.synchronize()
    assert _nn.launches == n0 + 1


def _tables(dev, r=3, n=2048, res=64, f=2, slots=6, seed=8, spread=0.3,
            behind=0):
    """Slot tables of r seeded clouds, built by the port's _build_table
    (the view it returns: render stride size + 1), their slot_orig,
    seeded cotangents and the build order; the first `behind` points of
    each cloud sit behind the camera."""
    g = np.random.default_rng(seed)
    pts = g.normal(size=(r, n, 3)) * spread
    pts[:, :behind, 2] = 3.5
    pts = torch.tensor(pts, dtype=torch.float32, device=dev)
    cols = torch.tensor(g.random((r, n, 3)), dtype=torch.float32, device=dev)
    px, py, dn, s2, inf = _project_attrs(pts, 0.02, RenderCamera.default(res),
                                         f)
    table, _, slot_orig, order = _build_table(px, py, dn, s2, cols, inf,
                                              res, f, slots)
    cots = (torch.tensor(g.normal(size=(r, 3, res, res)), dtype=torch.float32,
                         device=dev),
            torch.tensor(g.normal(size=(r, res, res)), dtype=torch.float32,
                         device=dev))
    return table, slot_orig, cots, order


def _check_k4(table, res, f):
    """K4 bit-equal to its twin and repeating bitwise; returns dmax."""
    (acc, wacc), dmax = assemble(table, res, f, 1e-2)
    (acc_p, wacc_p), dmax_p = assemble_plain(table, res, f, 1e-2)
    assert torch.equal(dmax, dmax_p)
    assert torch.equal(acc, acc_p) and torch.equal(wacc, wacc_p)
    (acc2, wacc2), dmax2 = assemble(table, res, f, 1e-2)
    assert torch.equal(acc, acc2) and torch.equal(wacc, wacc2) and \
        torch.equal(dmax, dmax2)
    return dmax


def _check_k5(table, slot_orig, cots, dmax, res, f, order=None, slots=6):
    """K5 bit-equal to its twin, repeating bitwise, the same with the
    points in the caller's order and in `order`, zeros for dropped
    points."""
    g = assemble_bwd_points(table, slot_orig, cots, dmax, res, f, slots,
                            1e-2, order)
    assert torch.equal(g, assemble_bwd_points_plain(table, slot_orig, cots,
                                                    dmax, res, f, slots,
                                                    1e-2))
    assert torch.equal(g, assemble_bwd_points(table, slot_orig, cots, dmax,
                                              res, f, slots, 1e-2, order))
    assert torch.equal(g, assemble_bwd_points(table, slot_orig, cots, dmax,
                                              res, f, slots, 1e-2))
    dropped = slot_orig >= slots * res * res
    assert (g.transpose(1, 2)[dropped] == 0).all()
    return g


@pytest.mark.parametrize("res", [64, 224])
def test_k4_k5_equal_plain_and_repeat(dev, res):
    # the twins sum in the kernels' order with one rounding per operation
    # and the same expf: bit-equal; every output written by one thread:
    # the same bits from run to run
    table, slot_orig, cots, order = _tables(dev, res=res, behind=7)
    assert not table.is_contiguous()
    dmax = _check_k4(table, res, 2)
    g = _check_k5(table, slot_orig, cots, dmax, res, 2, order)
    assert (slot_orig >= 6 * res * res).any() and g.abs().sum() > 0
    # g_acc at other strides (channels last, as autograd may hand it on)
    g_cl = cots[0].permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    assert torch.equal(g, assemble_bwd_points(table, slot_orig,
                                              (g_cl, cots[1]), dmax, res,
                                              2, 6, 1e-2))


@pytest.mark.parametrize("res,n", [(224, 2048), (112, 512)])
def test_k4_k5_pose_shapes_strided_and_contiguous(dev, res, n):
    # R = 52 renders at the pose path's shapes, dense enough that slots
    # overflow, some points behind the camera; the view _build_table
    # returns and its contiguous copy give the same bits
    table, slot_orig, cots, order = _tables(dev, r=52, n=n, res=res,
                                            spread=0.08, behind=5)
    dmax = _check_k4(table, res, 2)
    g = _check_k5(table, slot_orig, cots, dmax, res, 2, order)
    dense = table.contiguous()
    assert dense.stride(0) != table.stride(0)
    assert torch.equal(dmax, _check_k4(dense, res, 2))
    assert torch.equal(g, _check_k5(dense, slot_orig, cots, dmax, res, 2,
                                    order))
    assert (slot_orig < 6 * res * res).sum() < slot_orig.numel()


@pytest.mark.parametrize("res,n", [(224, 2048), (112, 512)])
def test_k4_k5_single_object_pose_shapes(dev, res, n):
    # R = 4 renders (one object's four starts, the per-object pose path)
    # at both pose resolutions: bit-equal to the twins and repeating, on
    # the strided view and its contiguous copy
    table, slot_orig, cots, order = _tables(dev, r=4, n=n, res=res,
                                            spread=0.08, behind=5)
    dmax = _check_k4(table, res, 2)
    g = _check_k5(table, slot_orig, cots, dmax, res, 2, order)
    dense = table.contiguous()
    assert torch.equal(dmax, _check_k4(dense, res, 2))
    assert torch.equal(g, _check_k5(dense, slot_orig, cots, dmax, res, 2,
                                    order))


def _filled_table(dev, r, res, f, seed=12, slots=6):
    """A table with every entry of every slot present (the border too):
    centres within 2f + 1 pixels of each entry's own, random depths,
    sigma2 and colours; slot_orig names every interior entry once, then
    three dropped points."""
    g = np.random.default_rng(seed)
    h = res + 2 * f
    t = g.random((r, slots, CH, h, h)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h) - f, np.arange(h) - f, indexing="ij")
    t[:, :, 0] = xx + (t[:, :, 0] - 0.5) * (4 * f + 2)
    t[:, :, 1] = yy + (t[:, :, 1] - 0.5) * (4 * f + 2)
    t[:, :, 3] = 0.05 + 2.0 * t[:, :, 3]
    npix = res * res
    so = np.concatenate([np.arange(slots * npix), [slots * npix] * 3])
    slot_orig = torch.tensor(np.broadcast_to(so, (r, so.size)).copy(),
                             device=dev)
    cots = (torch.tensor(g.normal(size=(r, 3, res, res)), dtype=torch.float32,
                         device=dev),
            torch.tensor(g.normal(size=(r, res, res)), dtype=torch.float32,
                         device=dev))
    return torch.tensor(t, device=dev), slot_orig, cots


@pytest.mark.parametrize("r,res,f", [(52, 224, 2), (52, 112, 2), (3, 50, 2),
                                     (3, 64, 1), (3, 64, 3)])
def test_k4_k5_full_table(dev, r, res, f):
    # every window entry present: K4 walks all (2f+1)^2 bits of every word,
    # K5 every entry; res 50 leaves a ragged tile edge
    table, slot_orig, cots = _filled_table(dev, r, res, f)
    dmax = _check_k4(table, res, f)
    assert (dmax > -1).all()
    _check_k5(table, slot_orig, cots, dmax, res, f)


@pytest.mark.parametrize("res,f", [(224, 2), (50, 1), (50, 3)])
def test_k4_k5_empty_table(dev, res, f):
    # no entry present: every tile ends early with zeros and dmax = -1
    table = torch.zeros((4, 6, CH, res + 2 * f, res + 2 * f), device=dev)
    slot_orig = torch.full((4, 9), 6 * res * res, device=dev)
    cots = (torch.ones((4, 3, res, res), device=dev),
            torch.ones((4, res, res), device=dev))
    dmax = _check_k4(table, res, f)
    assert (dmax == -1).all()
    (acc, wacc), _ = assemble(table, res, f, 1e-2)
    assert not acc.any() and not wacc.any()
    assert not _check_k5(table, slot_orig, cots, dmax, res, f).any()


@pytest.mark.parametrize("res,f", [(50, 2), (50, 1), (50, 3), (64, 1),
                                   (64, 3)])
def test_k4_k5_ragged_and_other_footprints(dev, res, f):
    # res 50: a ragged tile edge; f = 1 and 3: other halo widths, row
    # pitches that are not a multiple of 4 floats
    table, slot_orig, cots, order = _tables(dev, r=3, n=1500, res=res, f=f,
                                            behind=3)
    dmax = _check_k4(table, res, f)
    _check_k5(table, slot_orig, cots, dmax, res, f, order)


def test_chamfer_backward_repeats_bitwise(dev):
    # many x points share one nearest y point: the per-target gradient sum
    # has a fixed order (segment_sum), so two runs agree bitwise
    x = _rand(9, 4, 3000, 3, dev=dev)
    y = _rand(10, 4, 40, 3, dev=dev)
    grads = []
    for _ in range(2):
        xa = x.detach().requires_grad_(True)
        ya = y.detach().requires_grad_(True)
        d1, d2, _, _ = chamfer_nn(xa, ya)
        (d1.sum() + 0.5 * d2.sum()).backward()
        grads.append((xa.grad, ya.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_pose_step_is_deterministic(dev):
    # one full pose step (loss, backward, Adam) at R = 2 objects x 4
    # starts under torch's deterministic mode: any op with float atomics
    # on the path raises; two runs agree bitwise
    from genpc_tpu_torch.registration.pose_optim import (pose_carry_init,
                                                         pose_carry_steps)
    g = np.random.default_rng(11)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    comp = t(g.normal(size=(2, 512, 3)) * 0.25)
    part = t(g.normal(size=(2, 512, 3)) * 0.25)
    cols = t(g.random((2, 512, 3)))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        outs = []
        for _ in range(2):
            carry = pose_carry_init(comp, cols, part, cols, 0.02, 64)
            outs.append(pose_carry_steps(carry, comp, cols, part, 0.02, 0.01,
                                         2, 64))
    finally:
        torch.use_deterministic_algorithms(was)
    for k in ("rot6d", "trans", "log_scale"):
        assert torch.equal(outs[0]["params"][k], outs[1]["params"][k])
    assert torch.equal(outs[0]["best"], outs[1]["best"])
    assert torch.isfinite(outs[0]["best"]).all()


@pytest.mark.parametrize("b,k,n,res", [(13, 4, 512, 112), (1, 1, 2048, 224)],
                         ids=["coarse_b13", "per_object_fine"])
def test_pose_graph_equals_the_eager_steps(dev, b, k, n, res):
    # pose_carry_steps replays one CUDA graph of the step after its eager
    # warm-up: 10 steps give the eager loop's carry bit for bit (traced
    # and untraced), count their replays, and, with K1's trace on, time
    # each of the 2 K1 launches of every step
    from genpc_tpu_torch.registration.pose_optim import (
        WARMUP_STEPS, pose_carry_init, pose_carry_steps, pose_step,
        prune_starts)
    from genpc_tpu_torch.tracing import recording, span
    g = np.random.default_rng(17)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    comp = t(g.normal(size=(b, n, 3)) * [0.25, 0.2, 0.15])
    part = t(g.normal(size=(b, n, 3)) * [0.25, 0.2, 0.15])
    cols, pcols = t(g.random((b, n, 3))), t(g.random((b, n, 3)))
    carry = pose_carry_init(comp, cols, part, pcols, 0.02, res)
    if k < 4:
        carry = prune_starts(carry, carry, k)
    args = (comp, cols, part, 0.02, 0.01)
    step = pose_step(carry, *args, res)
    state = {key: carry[key] for key in ("params", "opt", "best",
                                         "best_params")}
    for _ in range(10):
        state = step(state)
    launches = _nn.launches
    _nn.trace = []
    try:
        with recording() as rec:
            with span("pose_coarse"):
                traced = pose_carry_steps(carry, *args, 10, res)
        trace = _nn.trace
    finally:
        _nn.trace = None
    untraced = pose_carry_steps(carry, *args, 10, res)
    torch.cuda.synchronize()

    def same(x, y):
        if isinstance(x, dict):
            return all(same(x[key], y[key]) for key in x)
        return torch.equal(x, y)

    assert same(state, traced) and same(state, untraced)
    assert torch.isfinite(state["best"]).all()
    flat = rec.flat()
    assert flat["pose_coarse:graph_steps"] == 10 - WARMUP_STEPS
    assert flat["pose_coarse:captures"] == 1
    assert len(trace) == 2 * 10 and _nn.launches == launches + 2 * 10 * 2
    for shape, start, end in trace:
        ms = start.elapsed_time(end)
        assert shape[0] == b * k and np.isfinite(ms) and ms > 0


def test_splat_launch_counters(dev):
    table, slot_orig, cots, _ = _tables("cpu", r=1, n=300, res=32)
    before = (assemble.launches, assemble_bwd_points.launches)
    (_, _), dmax = assemble(table, 32, 2, 1e-2)                # host: plain
    assemble_bwd_points(table, slot_orig, cots, dmax, 32, 2, 6, 1e-2)
    assert (assemble.launches, assemble_bwd_points.launches) == before
    td = table.to(dev)
    (_, _), dmax = assemble(td, 32, 2, 1e-2)
    assemble_bwd_points(td, slot_orig.to(dev), tuple(c.to(dev) for c in cots),
                        dmax, 32, 2, 6, 1e-2)
    torch.cuda.synchronize()
    assert (assemble.launches, assemble_bwd_points.launches) == \
        (before[0] + 1, before[1] + 1)


# ------------------------------------------------------------------ K6 ---
def _w4_inputs(dev, m, k, n, dtype=torch.bfloat16, seed=0, bias=True):
    """Seeded x [m, k], a packed int4 weight [n, k / 2] of codes -7..7,
    fp32 scale and bias [n] (scales of a 3,072-wide FLUX layer's size)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    codes = torch.randint(-7, 8, (n, k), generator=g, device=dev,
                          dtype=torch.int8)
    scale = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
    b = torch.randn(n, generator=g, device=dev) * 0.1 if bias else None
    return x, pack_int4(codes), scale, b


def _w4_check(x, w, scale, bias, got):
    """K6's result against its plain twin's on the card.  Both multiply
    exact operands (bf16 or fp32 x, integer codes) and sum in fp32 in
    their own orders, so each sum lies within K·u·Σ|x c| of the exact one
    (u = 2^-24; the tensor cores' accumulation counted twice over:
    bound = 4·K·u·Σ|x c|·scale, plus the epilogue's two fp32 roundings).
    fp32 outputs: within that bound.  bf16 outputs: within one bf16 ulp
    of the plain result (the two fp32 values round to neighbouring bf16
    values at most), or, where the plain fp32 value is itself within the
    bound of 0, within the bound plus that ulp."""
    c, k = x.dtype, x.shape[1]
    y32 = _scale_bias(matmul_f32(x, unpack_int4(w, c)), scale, bias)
    want = y32.to(c)
    sabs = (x.float().abs() @ unpack_int4(w, torch.float32).abs().T) * scale
    bound = 4 * k * 2.0 ** -24 * sabs + 2 * 2.0 ** -24 * y32.abs()
    diff = (got.float() - want.float()).abs()
    assert got.dtype == c and got.shape == want.shape
    if c == torch.float32:
        assert (diff <= bound).all(), float((diff - bound).max())
        return
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    ulp = torch.ldexp(torch.ones_like(diff), e - 8)
    near0 = y32.abs() <= bound
    ok = (diff <= ulp) | (near0 & (diff <= bound + ulp))
    assert ok.all(), (int((~ok).sum()), float(diff.max()))


#: (K, N) of the FLUX MMDiT's int4 block matmuls: the attention
#: projections, the MLP in and out, the single blocks' output projection
FLUX_W4 = [(3072, 3072), (3072, 12288), (12288, 3072), (15360, 3072)]
#: the rows they run at: a paint's image and text streams and its single
#: blocks (256, 512, 768), the B = 3 generation's (3,072, 1,536, 4,608)
FLUX_ROWS = [256, 512, 768, 1536, 3072, 4608]


@pytest.mark.parametrize("m", FLUX_ROWS)
@pytest.mark.parametrize("k,n", FLUX_W4)
def test_k6_flux_block_shapes_match_plain(dev, k, n, m):
    x, w, scale, bias = _w4_inputs(dev, m, k, n, seed=m + n)
    _w4_check(x, w, scale, bias, w4_linear(x, w, scale, bias))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [18432, 9216])
def test_k6_fp32_modulations_match_plain(dev, n, m):
    # the AdaLN modulations: fp32 activations at the batch's rows
    x, w, scale, bias = _w4_inputs(dev, m, 3072, n, torch.float32, seed=n)
    _w4_check(x, w, scale, bias, w4_linear(x, w, scale, bias))


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 10240),
                                 (10240, 4096)])
def test_k6_t5_shapes_match_plain(dev, k, n):
    # T5-XXL's q/k/v/o, wi_0/wi_1 and wo at 512 tokens, no bias
    x, w, scale, _ = _w4_inputs(dev, 512, k, n, seed=k + n, bias=False)
    _w4_check(x, w, scale, None, w4_linear(x, w, scale, None))


@pytest.mark.parametrize("m,k,n,dtype", [
    (1000, 1280, 3420, torch.bfloat16),    # Qwen2.5-VL vision MLP in
    (1000, 3420, 1280, torch.bfloat16),    # and out: K = 3,420 (ragged)
    (7, 3420, 1280, torch.bfloat16),       # 7 rows of a 64-row tile, ragged K
    (40, 3072, 1000, torch.float32),       # fp32 at 40 rows: 3 row blocks
    (5, 3072, 3072, torch.bfloat16),       # bf16 at a few rows: masked
    (16, 3072, 3072, torch.bfloat16),      # rows of one 64-row tile
    (17, 3072, 3072, torch.bfloat16),
    (300, 3104, 200, torch.bfloat16),      # K % 64 = 32, M and N ragged
])
def test_k6_ragged_and_small_shapes_match_plain(dev, m, k, n, dtype):
    x, w, scale, bias = _w4_inputs(dev, m, k, n, dtype, seed=m + k)
    _w4_check(x, w, scale, bias, w4_linear(x, w, scale, bias))


@pytest.mark.parametrize("bm", W4_ROW_TILES)
def test_k6_every_row_tile_matches_plain(dev, bm):
    x, w, scale, bias = _w4_inputs(dev, 1000, 3072, 1536, seed=bm)
    y = torch.empty((1000, 1536), dtype=torch.bfloat16, device=dev)
    _w4_gemm(x, w, scale, bias, y, bm=bm)
    _w4_check(x, w, scale, bias, y)


def test_k6_misaligned_input_matches_plain(dev):
    # a contiguous x starting 2 bytes into its storage
    x, w, scale, bias = _w4_inputs(dev, 300, 3072, 256, seed=5)
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
    xm = buf[1:1 + x.numel()].view_as(x)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16
    _w4_check(x, w, scale, bias, w4_linear(xm, w, scale, bias))


@pytest.mark.parametrize("m,dtype", [(3, torch.float32),
                                     (768, torch.bfloat16),
                                     (4608, torch.bfloat16)])
def test_k6_repeats_bitwise_and_replays_in_a_graph(dev, m, dtype):
    x, w, scale, bias = _w4_inputs(dev, m, 3072, 3072, dtype, seed=m)
    eager = w4_linear(x, w, scale, bias)
    assert torch.equal(eager, w4_linear(x, w, scale, bias))
    static = x.clone()
    graph = torch.cuda.graph
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w4_linear(static, w, scale, bias)
    torch.cuda.current_stream().wait_stream(side)
    with graph(g):
        out = w4_linear(static, w, scale, bias)
    static.zero_()
    g.replay()
    static.copy_(x)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_k6_raises_rather_than_falling_back(dev):
    x, w, scale, bias = _w4_inputs(dev, 64, 256, 128)
    with pytest.raises(TypeError):
        w4_linear(x.half(), w, scale, bias)
    with pytest.raises(ValueError):
        w4_linear(x, w.cpu(), scale, bias)          # weight on the host
    with pytest.raises(ValueError):
        w4_linear(x, w, scale.cpu(), bias)
    with pytest.raises(ValueError):
        w4_linear(x[:, :128], w, scale, bias)       # K against in / 2
    with pytest.raises(ValueError):
        w4_linear(x, w.view(torch.uint8), scale, bias)


def test_k6_counts_its_launches(dev):
    x, w, scale, bias = _w4_inputs(dev, 64, 256, 128)
    before = (_w4_gemm.launches, _w4_gemv.launches)
    with tracing.recording() as rec, tracing.span("outer"):
        w4_linear(x, w, scale, bias)
        w4_linear(x[:3].float(), w, scale, bias)
        w4_linear(x.cpu(), w.cpu(), scale.cpu(), bias.cpu())
    assert (_w4_gemm.launches, _w4_gemv.launches) == \
        (before[0] + 1, before[1] + 1)
    flat = rec.flat()
    assert flat["outer:quant_w4"] == 2 and flat["outer:quant_w4_plain"] == 1


def test_k6_in_a_graphed_call_counts_each_replay(dev):
    # the denoise steps' CUDA graph: the eager warm-up launches once, the
    # capture launches nothing, each replay launches once more
    from genpc_tpu_torch.models.graphs import graphed_call
    x, w, scale, bias = _w4_inputs(dev, 256, 256, 128)
    cache = {}
    before = _w4_gemm.launches
    with tracing.recording() as rec, tracing.span("steps"):
        for _ in range(3):
            got = graphed_call(cache, (), lambda a: w4_linear(a, w, scale,
                                                              bias),
                               [x], dev).clone()
    torch.cuda.synchronize()
    assert _w4_gemm.launches == before + 4
    assert rec.flat()["steps:quant_w4"] == 4
    assert torch.equal(got, w4_linear(x, w, scale, bias))

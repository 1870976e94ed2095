"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA GPU (marker ``cuda``) and skips
without one.  The machine with the card has no JAX, so run these
without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from genpc_tpu_torch.ops.chamfer import _nn, _nn_plain, chamfer_nn
from genpc_tpu_torch.ops.emd_kernel import bid, bid_plain
from genpc_tpu_torch.ops.fps_kernel import fps_batched, fps_batched_plain

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

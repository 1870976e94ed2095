"""The roofline arithmetic against values worked out by hand."""

import math

import portbench_tiny  # noqa: F401  (puts the checkout on sys.path)
from portbench import roofline


def test_k1_bound_metric_shape():
    # 13 × 16,384 × 16,384 pairs × 8 operations at 67 TFLOP/s
    want = 8 * 13 * 16384 * 16384 / 67e12
    assert math.isclose(roofline.k1_chamfer(13, 16384, 16384), want)
    assert math.isclose(want * 1e3, 0.41667, rel_tol=1e-4)


def test_k1_bound_by_bytes_when_m_is_one():
    # one point to search: 12 (n + 1) + 8 n bytes over 8 n operations
    n = 1 << 20
    assert math.isclose(roofline.k1_chamfer(1, n, 1),
                        (12 * (n + 1) + 8 * n) / 3.35e12)


def test_k2_bound_stage1_shape():
    # [13, 65,536] -> 10,000: 9,999 picks over every point, 8 operations
    want = 8 * 13 * 65536 * 9999 / 67e12
    assert math.isclose(roofline.k2_fps(13, 65536, 10000), want)
    assert math.isclose(want * 1e3, 1.0172, rel_tol=1e-4)


def test_share_percent():
    b = roofline.k1_chamfer(13, 16384, 16384)
    launches = [((13, 16384, 16384), 2 * b), ((13, 16384, 16384), 2 * b)]
    assert math.isclose(roofline.share_percent(launches,
                                               roofline.k1_chamfer), 50.0)
    assert roofline.share_percent([], roofline.k1_chamfer) is None

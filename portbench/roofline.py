"""The least time a kernel launch could take on one NVIDIA H100 SXM, from
the launch's shape alone.

The arithmetic is ``chip_smoke.bound`` (at commit 15bea8d), frozen here:
the larger of the bytes the algorithm must move once at the memory rate
and the fp32 operations it must do at the fp32 rate outside the tensor
cores (NVIDIA's H100 SXM data sheet).  The counts follow the algorithm's
inputs and outputs, whatever implements them: each input byte read once,
each output byte written once, and the operations that every input pair
needs.  A kernel's roofline share is the sum of these bounds over its
launches divided by the sum of their device times.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32, outside the tensor cores


def bound_s(n_bytes: float, flops: float) -> float:
    """Seconds: bytes at the memory rate or operations at the fp32 rate,
    whichever takes longer."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def k1_chamfer(b: int, n: int, m: int) -> float:
    """K1, the nearest neighbour of each of b × n query points among m
    points of its batch: the queries and the points read (12 bytes a
    point), a distance and an int32 index written a query, and 8 fp32
    operations a pair (3 differences, 3 squares, 2 sums)."""
    return bound_s(12.0 * b * (n + m) + 8.0 * b * n, 8.0 * b * n * m)


def k2_fps(b: int, n: int, k: int) -> float:
    """K2, exact farthest-point sampling of k of n points in each of b
    clouds: the points read (12 bytes a point), k int32 indices written a
    cloud, and k − 1 picks that each update every point's distance to the
    chosen set (8 fp32 operations: 3 differences, 3 squares, 2 sums; the
    minimum and the argmax are not counted).  Points that pad a cloud to
    the launch's n count as points."""
    return bound_s(12.0 * b * n + 4.0 * b * k, 8.0 * b * n * (k - 1))


#: a traced wrapper's name in the record -> its bound from (b, n, m|k)
BOUNDS = {"k1": k1_chamfer, "k2": k2_fps}


def share_percent(launches, bound) -> float | None:
    """launches: [(shape, device seconds)]; the summed bound over the
    summed device time, in percent, or None when there is no launch."""
    t = sum(s for _, s in launches)
    if not launches or t <= 0.0:
        return None
    return 100.0 * sum(bound(*shape) for shape, _ in launches) / t

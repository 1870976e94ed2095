"""Batched exact farthest-point sampling: kernel K2 and its plain twin.

Counterpart of genpc_tpu/ops/fps_kernel.py.  ``fps_batched`` dispatches
by device: a CPU tensor takes ``fps_batched_plain`` (the reference's
``_fps_indices_xla`` loop in torch, over the batch at once), a CUDA
tensor launches csrc/fps.cu, which replaces the Pallas ``_kernel``: one
object per thread-block cluster, its points on-chip (see the note there
for what bounds it and why it is shaped as it is).  ``fps_plan`` says how
an object of N points is spread over its cluster.

Both pick the start index first, then k-1 times the point whose minimum
squared distance to the chosen set is largest, lowest index on ties.
Any N is supported; k may exceed N (further picks are index 0).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from genpc_tpu_torch import _kernels

#: csrc/fps.cu: threads a block, the most points a thread keeps on-chip
#: (a power of two), the largest cluster
THREADS = 512
MAX_PPT = 32
MAX_CLUSTER = 16


def fps_plan(n: int, cluster: int | None = None) -> dict:
    """How K2 spreads an object of n points: ``cluster`` blocks (the
    smallest power of two up to MAX_CLUSTER whose slice fits on-chip,
    unless given), each owning ``slice`` consecutive points of which
    ``on_chip`` stay in shared memory and registers (THREADS × ``ppt``
    slots) and the rest stream from global memory."""
    if cluster is None:
        cluster = 1
        while cluster < MAX_CLUSTER and -(-n // cluster) > THREADS * MAX_PPT:
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"fps: cluster {cluster} outside 1..{MAX_CLUSTER}")
    slice_ = -(-n // cluster)
    ppt = 1
    while ppt < MAX_PPT and THREADS * ppt < slice_:
        ppt *= 2
    return {"cluster": cluster, "slice": slice_, "ppt": ppt,
            "on_chip": min(slice_, THREADS * ppt)}


@functools.lru_cache(maxsize=None)
def active_clusters(device_index: int, cluster: int, ppt: int) -> int:
    """cudaOccupancyMaxActiveClusters for K2's launch configuration: how
    many clusters of ``cluster`` blocks fit on the card at once."""
    active = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _kernels.lib().genpc_fps_active_clusters(cluster, ppt,
                                                      ctypes.byref(active))
    _kernels.check(rc, "genpc_fps_active_clusters")
    return active.value


def fps_batched_plain(pts: torch.Tensor, k: int,
                      start: int = 0) -> torch.Tensor:
    """[B,N,3] -> [B,k] int32, the plain version of K2."""
    p = pts.to(torch.float32)
    b, n, _ = p.shape
    rows = torch.arange(b, device=p.device)
    min_d = torch.full((b, n), float("inf"), dtype=torch.float32,
                       device=p.device)
    out = torch.zeros((b, k), dtype=torch.int64, device=p.device)
    out[:, 0] = start
    last = torch.full((b,), start, dtype=torch.int64, device=p.device)
    for i in range(1, k):
        s = p[rows, last]                                   # [B,3]
        d = (p[..., 0] - s[:, None, 0]).square_()
        d += (p[..., 1] - s[:, None, 1]).square_()
        d += (p[..., 2] - s[:, None, 2]).square_()
        torch.minimum(min_d, d, out=min_d)
        last = torch.argmax(min_d, dim=1)
        out[:, i] = last
    return out.to(torch.int32)


def fps_batched(pts: torch.Tensor, k: int, start: int = 0) -> torch.Tensor:
    """Exact FPS indices for a batch: pts [B,N,3] -> [B,k] int32.

    On the card each object runs on a cluster of ``fps_plan(N)`` blocks;
    raises when that cluster cannot be scheduled."""
    pts = pts.to(torch.float32).contiguous()
    b, n, _ = pts.shape
    if n == 0 or k < 1 or not 0 <= start < n or n >= 1 << 27:
        raise ValueError(f"fps: N={n}, k={k}, start={start}")
    if pts.device.type == "cpu":
        return fps_batched_plain(pts, k, start)
    _kernels.require_cuda("fps", pts)
    return _launch(pts, k, start, fps_plan(n))


def _launch(pts: torch.Tensor, k: int, start: int,
            plan: dict) -> torch.Tensor:
    """Launch K2 on contiguous fp32 pts [B,N,3] on the card with the given
    plan (``fps_batched`` passes ``fps_plan(N)``; tests and the smoke run
    force other cluster sizes)."""
    b, n, _ = pts.shape
    dev = pts.device.index if pts.device.index is not None \
        else torch.cuda.current_device()
    if active_clusters(dev, plan["cluster"], plan["ppt"]) == 0:
        raise RuntimeError(f"fps: no cluster of {plan['cluster']} blocks "
                           f"({plan['ppt']} points a thread) fits on the "
                           f"card")
    streamed = plan["slice"] > plan["on_chip"]
    min_d = (torch.empty((b, n), dtype=torch.float32, device=pts.device)
             if streamed else None)
    out = torch.empty((b, k), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device), \
            _kernels.traced(fps_batched, (b, n, k)):
        rc = _kernels.lib().genpc_fps(
            pts.data_ptr(), _kernels.ptr(min_d), out.data_ptr(), b, n, k,
            start, plan["cluster"], plan["slice"], plan["ppt"],
            _kernels.stream(pts))
    _kernels.check(rc, "genpc_fps")
    return out


fps_batched.launches = 0
fps_batched.trace = None

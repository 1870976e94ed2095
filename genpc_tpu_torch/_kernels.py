"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled by nvcc for Hopper (``sm_90a``), one nvcc
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ctypes.  Nothing of PyTorch
is included in the sources, so a build takes seconds.  The library lands
in ``<repo>/build/`` under a name keyed by a hash of the sources and the
flags, built at first use; importing this module needs no nvcc.

Every C entry launches on the stream it is given (the caller passes
``torch.cuda.current_stream()``), allocates nothing, does not
synchronise, and returns ``cudaGetLastError()``; ``check`` raises when
that is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from genpc_tpu_torch import tracing

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C entry -> argtypes (pointers and the stream as void*, sizes as int,
#: strides in elements as long long, scalars as float)
_SIGNATURES = {
    # x, y, y_index, dist, idx, dpart, ipart, B, N, M, rows, threads,
    # splits, chunk, stream
    "genpc_nn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # pts, min_d, out, B, N, k, start, cluster, slice, ppt, stream
    "genpc_fps": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # cluster, ppt, active (int*)
    "genpc_fps_active_clusters": [_I, _I, ctypes.POINTER(_I)],
    # x1, x2, price, order, bid, best, better, B, n, m, rows, group,
    # threads, stream
    "genpc_emd_bid": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P],
    # table, rstride, acc, wacc, dmax, B, S, res, f, gamma, tiles_x,
    # tiles, smem, stream
    "genpc_splat_fwd": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                        _P],
    # table, rstride, slot_orig, order, g_acc, its 4 strides, g_wacc,
    # dmax, out, B, N, S, res, f, gamma, stream
    "genpc_splat_bwd_points": [_P, _L, _P, _P, _P, _L, _L, _L, _L, _P, _P,
                               _P, _I, _I, _I, _I, _I, _F, _P],
    # x, w, scale, bias, y, M, N, K, ldx, bm, stream
    "genpc_w4_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, scale, bias, y, M, N, K, mt, stream
    "genpc_w4_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgenpc_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into build/ unless the keyed library exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = sorted(SRC_DIR.glob("*.cu"))
    # one nvcc per source, all started together, then one link; built
    # under a temp dir and renamed, so concurrent builds never see a
    # half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in cu]
        lib_tmp = os.path.join(tmp, out.name)
        _nvcc_wait({src.name: [*NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                               str(src)] for src, obj in zip(cu, objs)},
                   verbose)
        _nvcc_wait({"link": ["-shared", "-o", lib_tmp, *objs]}, verbose)
        os.replace(lib_tmp, out)
    return out


def _nvcc_wait(jobs: dict[str, list[str]], verbose: bool) -> None:
    """Run one nvcc per job, all at once; wait for all, raise if any
    failed, print each one's ptxas report when verbose."""
    procs = {what: subprocess.Popen([_nvcc(), *args], stderr=subprocess.PIPE,
                                    text=True) for what, args in jobs.items()}
    logs = {what: p.communicate()[1] for what, p in procs.items()}
    failed = [f"{what} ({p.returncode}):\n{logs[what]}"
              for what, p in procs.items() if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    if verbose:
        for what, log in logs.items():
            print(f"{what}:\n{log.strip()}")


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.genpc_error_string.argtypes = [ctypes.c_int]
            handle.genpc_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().genpc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous fp32/int32 tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name}: dtype {t.dtype} (fp32/int32 only)")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


class Elapsed:
    """The device time of one launch of a graph replay, read as an event
    pair's is: ``elapsed_time(end)`` gives it in milliseconds whatever
    ``end`` is (a trace entry holds None there)."""

    __slots__ = ("ms",)

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, _end=None) -> float:
        return self.ms


def _count(fn) -> None:
    """One launch of the wrapper ``fn``: into ``fn.launches`` and, where
    the wrapper names a ``counter``, into that ``tracing`` counter."""
    fn.launches += 1
    counter = getattr(fn, "counter", None)
    if counter is not None:
        tracing.count(counter)


class Captured:
    """The launches of the traced wrappers that one stream capture
    records: ``with Captured() as launches:`` around the capture and
    nothing else (every traced launch inside is taken as captured), then
    ``launches.replayed()`` after each replay of its graph, which counts
    each launch (``_count``) and, where the wrapper's
    ``trace`` is a list, appends (shape, ``Elapsed``, None) with the
    launch's device time in that replay.  The time is read from the
    external events the capture recorded around the launch (event-record
    nodes of the graph, re-recorded by every replay), so it waits for the
    replay to end, and only while a trace list is on."""

    def __init__(self):
        #: (wrapper, shape, start, end); the events None when untraced
        self.launches: list = []

    def __enter__(self) -> "Captured":
        global _capture
        _capture = self
        return self

    def __exit__(self, *exc) -> None:
        global _capture
        _capture = None

    def replayed(self) -> None:
        for fn, shape, start, end in self.launches:
            _count(fn)
            if start is not None and fn.trace is not None:
                end.synchronize()
                fn.trace.append((shape, Elapsed(start.elapsed_time(end)),
                                 None))


#: the capture under way (``Captured``), which takes the launches it
#: records; process-wide, as a stream capture is, since the backward's
#: launches come from the autograd engine's own thread
_capture: Captured | None = None


@contextlib.contextmanager
def traced(fn, shape: tuple):
    """Around one user-level launch of the wrapper ``fn``: counts it
    (``_count``) and, when ``fn.trace`` is a list, appends (shape,
    start, end) with CUDA events recorded on the current stream before
    and after (the launch-shape histogram of chip_smoke.py, the
    benchmark's rooflines).  A launch that a ``Captured`` capture records
    is counted and traced by ``Captured.replayed`` instead, at each
    replay."""
    capture = _capture
    timed = fn.trace is not None
    if timed:
        start = torch.cuda.Event(enable_timing=True,
                                 external=capture is not None)
        end = torch.cuda.Event(enable_timing=True,
                               external=capture is not None)
        start.record()
    yield
    if timed:
        end.record()
    if capture is not None:
        capture.launches.append((fn, shape) + ((start, end) if timed
                                               else (None, None)))
        return
    _count(fn)
    if timed:
        fn.trace.append((shape, start, end))

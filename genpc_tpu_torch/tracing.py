"""Spans and counters of the port (counterpart of genpc_tpu/tracing.py).

The port's one instrument:

  * ``span(name, sync=None, barrier=False)`` — a context manager on one
    per-thread stack of open spans.  With nothing on it only checks two
    flags: it reads no clock, synchronises nothing and opens no profiler
    range.  While a ``torch.profiler`` runs it opens a
    ``record_function`` range under its name, so the span lies on the
    device trace's own timeline.  While a recorder is on it records its
    name, its parent's name, and a start and an end stamped with
    ``time.time_ns()`` (the clock of the profiler's ``start_ns()``, so
    span stamps and device events share one clock); with ``sync`` (a
    CUDA device) its end first waits for that device, so its wall holds
    the device work it enqueued.  ``barrier=True`` waits for ``sync`` at
    the end whatever is on (a stage boundary the program keeps).
  * ``count(name, n=1)`` — adds n to a counter of every open span:
    counters are inclusive, as walls are.
  * ``recording()`` — opens a ``Recorder`` and yields it.  While one is
    on, every synchronizing CUDA operation the host makes (an ``.item()``,
    a device-to-host ``.cpu()``, a ``nonzero``; PyTorch's sync debug mode
    reports each) adds 1 to the counter ``syncs`` of the open spans; the
    spans' own end-of-span waits are not counted.
  * ``trace(logdir)`` — a ``torch.profiler`` run over CPU and CUDA
    activity that writes a Chrome trace into ``logdir``.

``Recorder.flat()`` gives ``{span: summed seconds}`` and ``{"span:counter":
count}`` in one dict, each span under its bare name.  ``run_batched(...,
timings=d)`` fills ``d`` with the flat record of its pass:

  ==================  =====================================================
  key                 span (parent)
  ==================  =====================================================
  load                reading the PLY files (the pass)
  stage1              FPS, view selection, splat, fill (the pass)
  generate            depth -> image (the pass)
  stage2              ``stage2_matte``, ``stage2_plan``, ``stage2_complete``
  stage3              registration and fusion (the pass)
  reg_prep            host resampling and voxel binning (stage3)
  reg_pose            pose optimisation: ``pose_coarse``, ``pose_fine``
  reg_coarse          coarse ICP sweep (stage3)
  reg_fine            per-axis fine grid (stage3)
  reg_refine          ``reg_undo`` (the host undo chain), the final refine
  reg_fusion          ``fusion_dedup``, ``fusion_fps``, ``fusion_outliers``
  metric              FPS and CD/EMD (the pass)
  pose_*:steps        the Adam steps of a pose phase
  pose_*:graph_steps  those replayed as one CUDA graph (0 off the card)
  pose_*:captures     the CUDA graphs the phase captured (0 off the card)
  inpaint, denoise    a FLUX paint's, a DiT generation's sampler loop
  <loop>:steps        its steps; ``:rows``, ``:img_tokens``, ``:txt_tokens``
                      the batch rows, latent image and text positions of
                      its steps, summed over them
  <stage>:syncs       synchronizing CUDA operations inside the span
  ==================  =====================================================

Usage:
    with recording() as rec:
        with span("stage1", sync=device):
            ...
    rec.report()
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: the message of PyTorch's sync debug mode
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclass
class Span:
    """One recorded span: ``path`` joins the names of the open spans
    with '/'; stamps are ``time.time_ns()``."""
    name: str
    parent: Optional[str]
    path: str
    start_ns: int
    end_ns: int = 0
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The spans that ended while it was on, in the order of their
    ends (``spans``); ``counts_syncs`` when it counts ``syncs`` (on a
    machine with a CUDA device), each span's count starting at 0."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts_syncs = False

    def flat(self) -> Dict[str, float]:
        """{name: summed seconds} and {"name:counter": summed count}."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0.0) + sp.seconds
            for k, v in sp.counters.items():
                key = f"{sp.name}:{k}"
                out[key] = out.get(key, 0.0) + float(v)
        return out

    def report(self, min_total: float = 0.0) -> str:
        """Prints and returns the table of walls by span path."""
        totals: Dict[str, float] = {}
        calls: Dict[str, int] = {}
        for sp in self.spans:
            totals[sp.path] = totals.get(sp.path, 0.0) + sp.seconds
            calls[sp.path] = calls.get(sp.path, 0) + 1
        lines = ["span                                    total_s   calls"
                 "   mean_ms"]
        for name in sorted(totals, key=lambda n: -totals[n]):
            t, c = totals[name], calls[name]
            if t < min_total:
                continue
            lines.append(f"{name:<40}{t:8.2f}{c:8d}{t / c * 1000:10.1f}")
        out = "\n".join(lines)
        print(out)
        return out


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []


_local = _Local()
#: the recorders that are on (a pass's own inside an operator's)
_recorders: List[Recorder] = []


def _wait(device) -> None:
    """A span's own end-of-span wait: ``torch.cuda.synchronize``, which
    the sync debug mode does not report, so ``syncs`` leaves it out."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class span:
    """``with span(name, sync=device):`` — see the module docstring."""

    __slots__ = ("name", "sync", "barrier", "_span", "_range")

    def __init__(self, name: str, sync=None, barrier: bool = False):
        self.name, self.sync, self.barrier = name, sync, barrier

    def __enter__(self) -> "span":
        self._span = self._range = None
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _recorders:
            stack = _local.stack
            parent = stack[-1] if stack else None
            self._span = Span(
                self.name, parent and parent.name,
                f"{parent.path}/{self.name}" if parent else self.name,
                time.time_ns(),
                counters={"syncs": 0} if _recorders[0].counts_syncs else {})
            stack.append(self._span)
        return self

    def __exit__(self, *exc) -> None:
        sp = self._span
        if self.sync is not None and (self.barrier or sp is not None):
            _wait(self.sync)
        if sp is not None:
            sp.end_ns = time.time_ns()
            _local.stack.pop()
            for rec in _recorders:
                rec.spans.append(sp)
        if self._range is not None:
            self._range.__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter ``name`` of every open span (while a
    recorder is on; nothing otherwise)."""
    for sp in _local.stack:
        sp.counters[name] = sp.counters.get(name, 0) + n


@contextlib.contextmanager
def _counting_syncs(rec: Recorder) -> Iterator[None]:
    """PyTorch's sync debug mode on "warn", each of its warnings counted
    into ``syncs`` and not shown; both settings restored at the end."""
    if not torch.cuda.is_available():
        yield
        return
    rec.counts_syncs = True
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None,
                 line=None):
            if str(message).startswith(_SYNC_WARNING):
                count("syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """A recorder of every span that ends while it is on."""
    rec = Recorder()
    counting = contextlib.nullcontext() if _recorders \
        else _counting_syncs(rec)
    _recorders.append(rec)
    try:
        with counting:
            yield rec
    finally:
        _recorders.remove(rec)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Device trace via torch.profiler when logdir is set (written to
    ``logdir/trace.json``, viewable in chrome://tracing or Perfetto);
    no-op otherwise.  Spans show as ranges in it."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

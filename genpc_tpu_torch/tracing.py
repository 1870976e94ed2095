"""Tracing and profiling (counterpart of genpc_tpu/tracing.py).

Three layers:
  * ``StageTimer`` — hierarchical wall-clock spans with a summary table.
    Each span ends in a device synchronisation when the timer is given a
    CUDA device, so a span holds its stage's device work and not only
    its enqueue (as ``run_batched``'s stage marks do);
  * ``trace(logdir)`` — a ``torch.profiler`` run over CPU and CUDA
    activity that writes a Chrome trace into ``logdir``;
  * ``annotate(name)`` — a ``record_function`` range, so spans show up
    inside the profiler's trace.

Usage:
    timer = StageTimer(device)
    with timer.span("stage1"):
        ...
    timer.report()
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch


class StageTimer:
    def __init__(self, device: torch.device | str | None = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []
        dev = torch.device(device) if device is not None else None
        self._sync_device = dev if dev is not None and dev.type == "cuda" \
            else None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync_device is not None:
                torch.cuda.synchronize(self._sync_device)
            dt = time.perf_counter() - t0
            self.totals[full] += dt
            self.counts[full] += 1
            self._stack.pop()

    def report(self, min_total: float = 0.0) -> str:
        lines = ["span                                    total_s   calls"
                 "   mean_ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            if t < min_total:
                continue
            lines.append(f"{name:<40}{t:8.2f}{c:8d}{t / c * 1000:10.1f}")
        out = "\n".join(lines)
        print(out)
        return out

    def as_dict(self) -> Dict[str, Tuple[float, int]]:
        return {k: (self.totals[k], self.counts[k]) for k in self.totals}


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Device trace via torch.profiler when logdir is set (written to
    ``logdir/trace.json``, viewable in chrome://tracing or Perfetto);
    no-op otherwise."""
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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside profiler traces."""
    with torch.profiler.record_function(name):
        yield

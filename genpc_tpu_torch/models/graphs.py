"""One CUDA graph a denoise step, shared by the diffusion backends.

A step of the SDXL ControlNet (ControlNet + two UNet passes) or of
zero123plus (a write and a guided read pass of the UNet, then the
scheduler step) launches thousands of kernels; eager mode pays the
host's cost for each operator on every step.  ``graphed_call`` captures
the step once per key in a CUDA graph on static input buffers and
replays it: the same kernels as the eager call, so the same bits.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from genpc_tpu_torch import _kernels


class GraphedCall:
    """``fn(*tensors)`` captured once in a CUDA graph on static copies of
    ``tensors``; a call copies its inputs into them and replays."""

    def __init__(self, fn: Callable, tensors: Sequence[torch.Tensor]):
        self.bufs = [a.clone() for a in tensors]
        #: holds what ``fn`` closes over and the graph reads (a
        #: scheduler's tables) for as long as the graph lives
        self.fn = fn
        # warm up outside the capture, so that cuDNN and cuBLAS choose and
        # allocate their workspaces first, on the capture stream (one for
        # the process: a new side stream would keep a cuBLAS workspace of
        # its own for as long as the process lives)
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.bufs)
        torch.cuda.current_stream().wait_stream(side)
        # the port's kernels in the graph count at each replay, not here
        with capture, _kernels.Captured() as self.launches:
            self.out = fn(*self.bufs)

    def __call__(self, tensors: Sequence[torch.Tensor]):
        for buf, a in zip(self.bufs, tensors):
            buf.copy_(a)
        self.graph.replay()
        self.launches.replayed()
        return self.out


def graphed_call(cache: Dict[tuple, GraphedCall], key: tuple, fn: Callable,
                 tensors: Sequence[torch.Tensor], device: torch.device):
    """``fn(*tensors)``: eagerly off the card; on it through the graph
    ``cache[key]``, captured at the key's first call (``key`` names what
    ``fn`` closes over besides the shapes of ``tensors``).  A returned
    tensor is overwritten by the next replay."""
    if device.type != "cuda":
        return fn(*tensors)
    key = (tuple(tuple(a.shape) for a in tensors),) + key
    if key not in cache:
        cache[key] = GraphedCall(fn, tensors)
    return cache[key](tensors)

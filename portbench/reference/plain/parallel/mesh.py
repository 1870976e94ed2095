"""The one-device subset of ``genpc_tpu_torch/parallel/mesh.py`` that the
copied runner calls: no mesh, so every helper serves the run's device
alone (``split`` into one chunk, ``run_sharded`` one call)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch


def get_mesh(cfg) -> None:
    return None


def dp_size(mesh: Optional[object]) -> int:
    return 1


def dp_devices(mesh: Optional[object], device) -> List[torch.device]:
    return [torch.device(device)]


def split(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    return [torch.as_tensor(x).to(devices[0])]


def gather(shards: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    return torch.cat([s.to(device) for s in shards])


def dp_sharded(mesh: Optional[object], *arrays):
    raise ValueError("the reference runs on one device, without a mesh")


def run_sharded(fn, devices: Sequence[torch.device], *arrays):
    """fn over the stacked host arrays on devices[0]; the result (a
    tensor or array, or a tuple of them) as numpy arrays."""
    out = fn(*(torch.as_tensor(a).to(devices[0]) for a in arrays))
    single = not isinstance(out, tuple)
    host = tuple(o.cpu().numpy() if torch.is_tensor(o) else np.asarray(o)
                 for o in ((out,) if single else out))
    return host[0] if single else host

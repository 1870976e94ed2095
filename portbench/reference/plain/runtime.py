"""Device resolution and numeric precision for the port.

TF32 is switched off for matmuls and cuDNN where the port initialises:
the reference computes in full fp32 (its distance expansions run at
``Precision.HIGHEST``), and TF32 keeps only ~3 decimal digits.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(name, mesh=None) -> torch.device:
    """``cfg.device`` -> torch.device, or with a device mesh
    (``parallel.mesh.get_mesh``) the mesh's first device; raises when CUDA
    is asked for and absent (a measurement never falls back to the
    CPU)."""
    dev = torch.device(name if mesh is None else mesh.devices.flat[0])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev

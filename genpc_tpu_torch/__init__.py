"""genpc_tpu_torch — the GenPC point-cloud completion pipeline in PyTorch.

The PyTorch/CUDA counterpart of ``genpc_tpu`` (the JAX reference, which
stays the parity oracle).  The module layout and public names mirror
``genpc_tpu``; plain tensor code is PyTorch, and every Pallas kernel of
the reference becomes a hand-written CUDA kernel under ``csrc/``, built
with nvcc for sm_90a on first use (``_kernels.py``).

Dispatch is by device: a kernel wrapper runs its plain-torch version for
a CPU tensor and launches its CUDA kernel for a CUDA tensor.  There is no
environment switch.  ``cfg.device`` picks the device of a pipeline run.
"""

__version__ = "0.1.0"

from genpc_tpu_torch import runtime as _runtime  # noqa: F401  (precision)
from genpc_tpu_torch.config import Config, load_config  # noqa: F401

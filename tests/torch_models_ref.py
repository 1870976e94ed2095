"""Helpers of the generative-model parity tests (test_torch_models.py,
test_torch_checkpoints.py, test_torch_generate.py): reference parameter
trees drawn from numpy without a flax init, the reference run under jit,
the two precision modes, and the tolerance check."""

import contextlib
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genpc_tpu.models import dit as jdit
from genpc_tpu_torch.models import weights as tw

#: max |port - reference| <= TOL * max |reference|, by precision mode.
#: f32 (every layer in fp32 on both sides): summation order only,
#: observed up to 1.5e-6.  bf16 (the packages' own compute types): both
#: round the same layers to bf16 but at other points inside a layer (XLA
#: rounds a dot's output before its bias add, PyTorch after), and the
#: ulp (2^-8 relative) each layer differs by is carried through the
#: following ones: observed up to 2.3e-2, for the tiny UNet.
TOL = {"bf16": 3e-2, "f32": 1e-5}
MODES = ("bf16", "f32")


def ref_params(init, seed: int):
    """A reference parameter tree with numpy leaves, from the shapes of
    ``init()`` (traced with jax.eval_shape, never run): norm scales
    1 + N(0, 0.05), biases N(0, 0.05), kernels and embeddings
    N(0, 1/fan_in) (flax's lecun / embedding scale).  No leaf is zero, so
    no output is trivially zero (a fresh ControlNet's zero convs are)."""
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            a = 1.0 + r.normal(0, 0.05, s.shape)
        elif name == "bias":
            a = r.normal(0, 0.05, s.shape)
        else:
            fan_in = s.shape[-1] if name == "embedding" \
                else math.prod(s.shape[:-1])
            a = r.normal(0, 1.0 / math.sqrt(fan_in), s.shape)
        return a.astype(np.float32)

    shapes = fnn.meta.unbox(jax.eval_shape(init))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def run_jit(fn, *args):
    """``fn(*args)`` under a fresh jit (the reference runs its models
    jitted), with the arrays as arguments, not constants."""
    return jax.jit(fn)(*args)


def port(module_cls, *args, kind, params):
    """A port module built on meta, materialised in fp32 on the CPU and
    loaded from the reference tree."""
    with torch.device("meta"):
        m = module_cls(*args)
    tw.materialize(m, "cpu", torch.float32)
    m.load_state_dict(tw.from_flax(kind, params, m), strict=True)
    return m


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@contextlib.contextmanager
def precision(mode, *modules):
    """'bf16': the packages' own compute types; 'f32': every bf16 layer of
    the reference (``jnp.bfloat16`` is read when a layer is traced; the
    MMDiT's ``_tp_dense`` binds it as a default argument, so it is
    wrapped too) and of the given port modules computes in fp32."""
    if mode == "bf16":
        yield
        return
    saved = [(m, m.compute) for mod in modules for m in mod.modules()
             if hasattr(m, "compute")]
    for m, _ in saved:
        m.compute = torch.float32
    dense = jdit._tp_dense

    def dense_f32(features, name, shard="out", quant=0, dtype=None):
        return dense(features, name, shard, quant, jnp.float32)

    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "bfloat16", jnp.float32)
            mp.setattr(jdit, "_tp_dense", dense_f32)
            yield
    finally:
        for m, c in saved:
            m.compute = c


def close(got, ref, tol) -> float:
    """Asserts max |got - ref| <= tol * max |ref|; ``got`` is torch NCHW
    (compared with the reference's NHWC) or token-major."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().cpu().numpy()
    if ref.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    gap = float(np.abs(got - ref).max())
    assert scale > 0 and gap <= tol * scale, (gap, scale, gap / scale)
    return gap / scale

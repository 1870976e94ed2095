"""Helpers of the FLUX parity tests (test_torch_flux.py,
test_torch_flux_inpaint.py): the tiny FLUX backend's reference trees
(ref_params, quantised by the reference's quantize_tree), installing them
in both packages, and the reference's jax.random draws of generate_batch
and of the inpainter."""

import jax
import numpy as np
import pytest
import torch
from torch_models_ref import precision, ref_params

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models import quant as jq
from genpc_tpu.models.dit_depth import DiTDepthEdit as JDiT
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.dit_depth import DiTDepthEdit

SIZE = 64
#: max |port - reference| over [0, 1] images (test_torch_dit_depth's)
IMAGE_TOL = {"bf16": 0.08, "f32": 1e-4}


def cfg(pkg, bits=0, **kw):
    if pkg == "ref":
        return jconfig.load_config(model_size="tiny", quant_bits=bits,
                                   tower_quant_bits=bits, **kw)
    return tconfig.load_config(device="cpu", model_size="tiny",
                               quant_bits=bits, tower_quant_bits=bits, **kw)


_TREES = {}


def trees(bits):
    """The reference's parameter trees of the tiny FLUX backend (MMDiT,
    VAE, T5, CLIP-L), from ref_params and quantised at ``bits``."""
    if 0 not in _TREES:
        j = JDiT(cfg("ref"), variant="flux")
        fp = ref_params(lambda: j._init_params(SIZE // j.factor), 1)
        _TREES[0] = {"dit": fp["dit"], "vae": fp["vae"],
                     "t5": ref_params(lambda: j.t5.params, 2),
                     "clip_l": ref_params(lambda: j.t5.params_l, 3)}
    if bits not in _TREES:
        fp = _TREES[0]
        _TREES[bits] = dict(
            fp, dit=jq.quantize_tree(fp["dit"], bits, jq.dit_block_select),
            t5=jq.quantize_tree(fp["t5"], bits, jq.t5_block_select))
    return _TREES[bits]


def install_ref(j, trees):
    """Reference FLUX backend j takes the trees."""
    j._params = {"dit": trees["dit"], "vae": trees["vae"]}
    j._latent_hw = SIZE // j.factor
    j.t5.params, j.t5.params_l = trees["t5"], trees["clip_l"]


def install_port(t, trees):
    t.init_params({kind: tw.from_flax(kind, trees[kind], mod)
                   for kind, mod in t.models().items()})


def reference_draws(j, b: int) -> torch.Tensor:
    """The latents the reference's next generate_batch of b objects draws
    (per object, its key folded with the running counter), NCHW."""
    hw = SIZE // j.factor
    keys = [jax.random.fold_in(j.rng, j._noise_ctr + i) for i in range(b)]
    lat = np.stack([np.asarray(jax.random.normal(
        k, (hw, hw, j.dit_cfg.in_channels))) for k in keys])
    return torch.from_numpy(lat.transpose(0, 3, 1, 2).copy())


def paint_draws(rng, n: int, hw: int, c: int):
    """The N(0, 1) latents of the reference inpainter's next n paint
    calls from its backend key ``rng`` (a split a call, then a split
    inside the sampler), NCHW; and the key after them."""
    out = []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        _, k = jax.random.split(k)
        out.append(torch.from_numpy(np.asarray(jax.random.normal(
            k, (1, hw, hw, c))).transpose(0, 3, 1, 2).copy()))
    return out, rng


def depths(n: int, seed: int = 0):
    r = np.random.default_rng(seed)
    return [r.random((3, 32, 32)).astype(np.float32) for _ in range(n)]


_PAIRS = {}


def check_generate_batch(bits: int, mode: str) -> None:
    """Two objects at 64² from 32² depth images through both packages'
    generate_batch (the backends of one ``bits`` shared by both modes): one
    T5 + CLIP-L call over both prompts, the tiled pooled vector, the VAE
    condition latents joined along the channels, 30 steps at guidance
    10.0 and the decode, with the MMDiT and T5 at quant_bits ``bits``; the
    port on the reference's draws, its images within IMAGE_TOL[mode]."""
    if bits not in _PAIRS:
        j = JDiT(cfg("ref", bits), variant="flux")
        install_ref(j, trees(bits))
        t = DiTDepthEdit(cfg("port", bits), variant="flux")
        install_port(t, trees(bits))
        _PAIRS[bits] = j, t
    j, t = _PAIRS[bits]
    assert (t.steps, t.guidance) == (j.steps, j.guidance) == (30, 10.0)
    assert t.dit_cfg.quant_bits == t.t5.cfg.quant_bits == bits
    flags = ["01184", "05117"]
    lat = reference_draws(j, 2)
    jax.clear_caches()
    with precision(mode, *t.models().values()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "draws", lambda b, hw: lat)
        ref = j.generate_batch(depths(2), flags, size=SIZE)
        got = t.generate_batch(depths(2), flags, size=SIZE)
    jax.clear_caches()
    assert got.shape == ref.shape == (2, SIZE, SIZE, 3)
    assert float(ref.std()) > 0.01
    assert np.abs(got - ref).max() <= IMAGE_TOL[mode]

"""Parity of the port's MMDiT (genpc_tpu_torch/models/dit.py) with the JAX
reference's on the CPU: the Qwen-family and the FLUX-family tiny presets
(single-stream blocks, guidance and pooled embedders, channel
conditioning), one joint sequence above the reference's 2,048-token
switch to query-chunked attention, the diffusers checkpoint names at the
tiny and full presets, the full Qwen-Image-Edit parameter count, and one
synthetic checkpoint loaded by both packages."""

import os
from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, TOL, close, nchw, port, precision, \
    ref_params, run_jit
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.models import checkpoint_specs as specs
from genpc_tpu.models import dit as jdit
from genpc_tpu.models import weights as jw
from genpc_tpu.models.dit import DiTConfig as JDiTConfig
from genpc_tpu.models.dit import MMDiT as JMMDiT
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.dit import DiTConfig, MMDiT

#: name -> (preset, latent side, text tokens): the latent side 64 gives
#: 2 x 32² image and edit tokens + 40 text tokens = 2,088 joint tokens,
#: above the reference's _ATTN_CHUNK_MIN_T (its chunked branch)
CASES = {"tiny_qwen": ("tiny_qwen", 8, 12), "tiny": ("tiny", 8, 12),
         "tiny_qwen_chunked": ("tiny_qwen", 64, 40)}


def _inputs(cfg, hw, lt, seed=0):
    """Two objects: latents, flow times, text features with the first
    object's last tokens masked off, condition latents, and (FLUX family)
    pooled text features and a guidance scale."""
    r = np.random.default_rng(seed)
    f = np.float32
    mask = np.ones((2, lt), bool)
    mask[0, lt // 2:] = False
    return dict(
        lat=r.normal(size=(2, hw, hw, cfg.in_channels)).astype(f),
        t=np.array([0.83, 0.27], f),
        txt=r.normal(size=(2, lt, cfg.text_dim)).astype(f),
        cond=r.normal(size=(2, hw, hw, cfg.cond_channels)).astype(f),
        mask=mask,
        pooled=(r.normal(size=(2, cfg.pooled_dim)).astype(f)
                if cfg.pooled_dim else None),
        guidance=np.array([3.5, 3.5], f) if cfg.guidance_embed else None)


def _reference(cfg, x, seed):
    """The reference's MMDiT, its parameters (ref_params) and its jitted
    forward on the inputs ``x``."""
    m = JMMDiT(cfg)
    params = ref_params(lambda: m.init(
        jax.random.PRNGKey(0), jnp.asarray(x["lat"]), jnp.asarray(x["t"]),
        jnp.asarray(x["txt"]), pooled=x["pooled"],
        cond_latents=jnp.asarray(x["cond"]), guidance=x["guidance"]), seed)

    def fwd(p, lat, t, txt, cond, mask, pooled, g):
        return m.apply(p, lat, t, txt, pooled=pooled, cond_latents=cond,
                       guidance=g, txt_mask=mask)
    return params, fwd


def _port_forward(m, x):
    def opt(a):
        return None if a is None else torch.from_numpy(a)
    return m(nchw(x["lat"]), torch.from_numpy(x["t"]),
             torch.from_numpy(x["txt"]), pooled=opt(x["pooled"]),
             cond_latents=nchw(x["cond"]), guidance=opt(x["guidance"]),
             txt_mask=torch.from_numpy(x["mask"]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(CASES))
def test_mmdit_matches_the_reference(case, mode):
    """The velocity of both packages' MMDiT on the same inputs and
    weights, with a key mask: the bf16 compute types of both packages
    (TOL['bf16'] of the largest |v|) and every layer in fp32 (TOL['f32'])."""
    preset, hw, lt = CASES[case]
    jcfg = JDiTConfig.preset(preset)
    x = _inputs(jcfg, hw, lt)
    params, fwd = _reference(jcfg, x, seed=1)
    m = port(MMDiT, DiTConfig.preset(preset), kind="dit", params=params)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, m), torch.no_grad():
        ref = run_jit(fwd, params, x["lat"], x["t"], x["txt"], x["cond"],
                      x["mask"], x["pooled"], x["guidance"])
        got = _port_forward(m, x)
    if mode == "f32":
        jax.clear_caches()
    assert got.dtype == torch.float32
    close(got, ref, TOL[mode])


def test_chunked_case_crosses_the_reference_switch():
    _, hw, lt = CASES["tiny_qwen_chunked"]
    assert 2 * (hw // 2) ** 2 + lt > jdit._ATTN_CHUNK_MIN_T


def _names(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("preset", ["tiny_qwen", "tiny", "qwen", "flux"])
def test_names_are_the_diffusers_checkpoints(preset):
    """On the meta device: a Qwen-family preset carries
    QwenImageTransformer2DModel's names and shapes, a FLUX-family one
    FluxTransformer2DModel's (checkpoint_specs), and mapped by the port's
    name maps they land on the reference's leaves (jax.eval_shape, at
    the tiny presets) with the transposed shapes."""
    with torch.device("meta"):
        m = MMDiT(DiTConfig.preset(preset))
    jcfg = JDiTConfig.preset(preset)
    spec = (specs.spec_qwen_transformer if m.cfg.family == "qwen"
            else specs.spec_flux_transformer)(jcfg)
    assert _names(m) == spec
    if preset not in ("tiny", "tiny_qwen"):
        return
    x = _inputs(jcfg, 8, 12)
    shapes = dict(jw.tree_shapes(fnn.meta.unbox(jax.eval_shape(
        lambda: JMMDiT(jcfg).init(
            jax.random.PRNGKey(0), jnp.asarray(x["lat"]),
            jnp.asarray(x["t"]), jnp.asarray(x["txt"]), pooled=x["pooled"],
            cond_latents=jnp.asarray(x["cond"]),
            guidance=x["guidance"])))))
    for name, shape in _names(m).items():
        path = tw.flax_path("dit", name, family=m.cfg.family)
        leaf = np.broadcast_to(np.float32(0), shapes.pop(path))
        assert tw.flax_layout(path, leaf).shape == shape, name
    assert not shapes, sorted(shapes)[:4]


def test_full_qwen_parameter_count_matches_the_reference():
    """The full Qwen-Image-Edit MMDiT (meta device) counts what the
    reference's tree counts by jax.eval_shape: 20,430,401,088."""
    jcfg = JDiTConfig.preset("qwen")
    lat = jnp.zeros((1, 8, 8, 16))
    tree = jax.eval_shape(lambda: JMMDiT(jcfg).init(
        jax.random.PRNGKey(0), lat, jnp.zeros((1,)),
        jnp.zeros((1, 8, jcfg.text_dim)), cond_latents=lat))
    ref = sum(int(np.prod(s)) for s in jw.tree_shapes(
        fnn.meta.unbox(tree)).values())
    with torch.device("meta"):
        m = MMDiT(DiTConfig.preset("qwen"))
    got = sum(p.numel() for p in m.parameters())
    assert got == ref == 20_430_401_088


def test_synthetic_qwen_checkpoint_loads_in_both_packages(tmp_path):
    """One synthetic QwenImageTransformer2DModel checkpoint (named by
    checkpoint_specs) under <weights_dir>/qwen, loaded by the reference's
    load_dit and by the port's: the port holds the checkpoint's tensors,
    and with every layer in fp32 both packages give the same velocity."""
    from safetensors.numpy import save_file
    jcfg = JDiTConfig.preset("tiny_qwen")
    ckpt = jw.synthetic_checkpoint(specs.spec_qwen_transformer(jcfg), seed=5)
    os.makedirs(tmp_path / "qwen")
    save_file(ckpt, str(tmp_path / "qwen" / "model.safetensors"))
    x = _inputs(jcfg, 8, 12, seed=2)
    params, fwd = _reference(jcfg, x, seed=0)
    params = jw.load_dit(str(tmp_path), {"dit": params}, "qwen")["dit"]
    with torch.device("meta"):
        m = MMDiT(DiTConfig.preset("tiny_qwen"))
    tw.materialize(m, "cpu", torch.float32)
    tw.load_dit(str(tmp_path), SimpleNamespace(model=m), "qwen")
    for name, v in m.state_dict().items():
        assert torch.equal(v, torch.from_numpy(ckpt[name])), name
    jax.clear_caches()
    with precision("f32", m), torch.no_grad():
        ref = run_jit(fwd, params, x["lat"], x["t"], x["txt"], x["cond"],
                      x["mask"], x["pooled"], x["guidance"])
        got = _port_forward(m, x)
    jax.clear_caches()
    close(got, ref, TOL["f32"])

"""Parity of the port's generative models (genpc_tpu_torch/models/layers,
schedulers, vae, unet, adapter, text_encoder, and the Lanczos resize of
controlnet_depth) with the JAX reference on the CPU.

Each port module gets the reference module's parameters through
``weights.from_flax`` and the same seeded numpy inputs, and runs in two
precision modes (torch_models_ref.py): "bf16", the packages' own compute
types, and "f32", every bf16 layer in fp32 on both sides, which holds the
structure (layout, order of operations, casts, epsilons, activations)
without the rounding.  Tolerances are ``TOL`` there; pure fp32
arithmetic (timestep embedding, schedulers) is held to rtol 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import (MODES, TOL, close, nchw, port, precision,
                              ref_params, run_jit)
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.models import layers as jl
from genpc_tpu.models import schedulers as js
from genpc_tpu.models import text_encoder as jte
from genpc_tpu.models.adapter import T2IAdapter as JAdapter
from genpc_tpu.models.unet import ControlNet as JControlNet
from genpc_tpu.models.unet import UNet2DCondition as JUNet
from genpc_tpu.models.unet import UNetConfig as JUNetConfig
from genpc_tpu.models.vae import AutoencoderKL as JVAE
from genpc_tpu.models.vae import VAEConfig as JVAEConfig
from genpc_tpu_torch.models import layers as tl
from genpc_tpu_torch.models import schedulers as ts
from genpc_tpu_torch.models import text_encoder as tte
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.adapter import T2IAdapter
from genpc_tpu_torch.models.controlnet_depth import resize_lanczos_uint8
from genpc_tpu_torch.models.unet import ControlNet, UNet2DCondition, UNetConfig
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig

COND_CH = (16, 32, 96, 256)
K = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    cfg = JUNetConfig.preset("tiny")
    return dict(
        lat=r.normal(size=(1, 8, 8, 4)).astype(np.float32),
        t=np.array([613.0], np.float32),
        ctx=r.normal(size=(1, 77, cfg.context_dim)).astype(np.float32),
        added=r.normal(size=(1, cfg.addition_embed_dim)).astype(np.float32),
        cond=r.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32))


def _targs(inputs):
    """The UNet's (latents, t, context) for the port."""
    return (nchw(inputs["lat"]), torch.from_numpy(inputs["t"]),
            torch.from_numpy(inputs["ctx"]))


@pytest.fixture(scope="module")
def unet_pair(inputs):
    j = JUNet(JUNetConfig.preset("tiny"))
    i = {k: jnp.asarray(v) for k, v in inputs.items()}
    p = ref_params(lambda: j.init(K, i["lat"], i["t"], i["ctx"],
                                  added_cond=i["added"]), 1)
    t = port(UNet2DCondition, UNetConfig.preset("tiny"), kind="unet",
             params=p)
    return j, p, t


@pytest.fixture(scope="module")
def controlnet_pair(inputs):
    j = JControlNet(JUNetConfig.preset("tiny"), cond_channels=COND_CH)
    i = {k: jnp.asarray(v) for k, v in inputs.items()}
    p = ref_params(lambda: j.init(K, i["lat"], i["t"], i["ctx"], i["cond"],
                                  added_cond=i["added"]), 2)
    t = port(ControlNet, UNetConfig.preset("tiny"), COND_CH,
             kind="controlnet", params=p)
    return j, p, t


# ----------------------------------------------------------------- fp32

@pytest.mark.parametrize("dim", [320, 256, 7])
def test_timestep_embedding_matches(dim):
    """rtol 1e-6, plus what one ulp of a frequency becomes at time t:
    XLA's and ATen's fp32 exp differ by one ulp on some frequencies (16
    of 160 at dim 320), and cos/sin of t x freq carry t x 2^-23 of it."""
    t = np.array([0.0, 1.0, 613.0, 999.0, 512.0], np.float32)
    ref = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
    tol = 1e-6 * np.abs(ref) + 1e-7 + t[:, None] * 2.0 ** -23
    assert (np.abs(got - ref) <= tol).all()
    assert np.abs(got - ref)[:2].max() <= 2e-7       # t = 0 and 1


def test_schedulers_match():
    r = np.random.default_rng(4)
    x = r.normal(size=(1, 4, 8, 8)).astype(np.float32)
    eps = r.normal(size=x.shape).astype(np.float32)
    noise = r.normal(size=x.shape).astype(np.float32)
    tx, te, tn = (torch.from_numpy(a) for a in (x, eps, noise))
    jx, je, jn = (jnp.asarray(a) for a in (x, eps, noise))

    def same(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)

    np.testing.assert_array_equal(ts.betas_scaled_linear(),
                                  js.betas_scaled_linear())
    for kw in ({}, {"spacing": "trailing", "prediction": "v"}):
        a, b = ts.EulerAncestral(30, **kw), js.EulerAncestral(30, **kw)
        same(a.timesteps, b.timesteps)
        same(a.sigmas, b.sigmas)
        assert a.init_noise_sigma == b.init_noise_sigma
        for i in (0, 7, 29):
            same(a.scale_model_input(tx, i), b.scale_model_input(jx, i))
            same(a.add_noise(tx, tn, i), b.add_noise(jx, jn, i))
            same(a.step(te, i, tx, tn), b.step(je, i, jx, jn))
    a, b = ts.DDIM(20), js.DDIM(20)
    same(a.timesteps, b.timesteps)
    for i in (0, 10, 19):
        same(a.step(te, i, tx), b.step(je, i, jx))
    a, b = ts.FlowMatchEuler(12), js.FlowMatchEuler(12)
    same(a.sigmas, b.sigmas)
    for i in (0, 11):
        same(a.step(te, i, tx), b.step(je, i, jx))
        same(a.t_next(i), b.t_next(i))
    same(ts.cfg_combine(tn, te, 5.0), js.cfg_combine(jn, je, 5.0))


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("mode", MODES)
def test_resnet_block_matches(mode):
    r = np.random.default_rng(5)
    x = r.normal(size=(1, 8, 8, 32)).astype(np.float32)
    temb = r.normal(size=(1, 128)).astype(np.float32)
    j = jl.ResnetBlock(64, 128)
    p = ref_params(lambda: j.init(K, jnp.asarray(x), jnp.asarray(temb)), 3)
    t = port(tl.ResnetBlock, 32, 64, 128, kind="unet", params=p)
    with precision(mode, t), torch.no_grad():
        ref = run_jit(j.apply, p, x, temb)
        got = t(nchw(x), torch.from_numpy(temb))
    want = {"bf16": torch.bfloat16, "f32": torch.float32}[mode]
    assert got.dtype == want and str(ref.dtype) == str(want)[6:]
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_spatial_transformer_matches(mode):
    r = np.random.default_rng(6)
    x = r.normal(size=(1, 4, 6, 64)).astype(np.float32)
    ctx = r.normal(size=(1, 9, 48)).astype(np.float32)
    j = jl.SpatialTransformer(64, 4, depth=2, context_dim=48)
    p = ref_params(lambda: j.init(K, jnp.asarray(x), jnp.asarray(ctx)), 4)
    t = port(tl.SpatialTransformer, 64, 4, 2, 48, kind="unet", params=p)
    with precision(mode, t), torch.no_grad():
        ref = run_jit(j.apply, p, x, ctx)
        got = t(nchw(x), torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    close(got, ref, TOL[mode])
    # with reference attention: a write pass records each block's
    # post-norm tokens, a read pass appends them to attn1's keys/values
    y = r.normal(size=(1, 3, 5, 64)).astype(np.float32)

    def ref_rw(p, x, y, ctx):
        bank = jl.RefBank("w")
        j.apply(p, y, ctx, ref=bank)
        return j.apply(p, x, ctx, ref=jl.RefBank("r", bank.tokens))

    with precision(mode, t), torch.no_grad():
        ref = run_jit(ref_rw, p, x, y, ctx)
        bank = tl.RefBank("w")
        t(nchw(y), torch.from_numpy(ctx), ref=bank)
        got = t(nchw(x), torch.from_numpy(ctx),
                ref=tl.RefBank("r", bank.tokens))
    assert len(bank.tokens) == 2
    close(got, ref, TOL[mode])


# ----------------------------------------------------------------- models

@pytest.mark.parametrize("mode", MODES)
def test_unet_matches(unet_pair, inputs, mode):
    j, p, t = unet_pair
    i = inputs
    with precision(mode, t), torch.no_grad():
        ref = run_jit(lambda p, a, b, c, d: j.apply(p, a, b, c, added_cond=d),
                      p, i["lat"], i["t"], i["ctx"], i["added"])
        got = t(*_targs(i), added_cond=torch.from_numpy(i["added"]))
    assert got.dtype == torch.float32
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_controlnet_residuals_match(controlnet_pair, unet_pair, inputs,
                                    mode):
    """The ControlNet's residuals, then the UNet with them added."""
    j, p, t = controlnet_pair
    ju, pu, tu = unet_pair
    i = inputs
    added = torch.from_numpy(i["added"])
    with precision(mode, t, tu), torch.no_grad():
        mid, down = run_jit(
            lambda p, a, b, c, d, e: j.apply(p, a, b, c, d, added_cond=e,
                                             conditioning_scale=0.7),
            p, i["lat"], i["t"], i["ctx"], i["cond"], i["added"])
        ref = run_jit(
            lambda p, a, b, c, d, res: ju.apply(p, a, b, c, added_cond=d,
                                                control_residuals=res),
            pu, i["lat"], i["t"], i["ctx"], i["added"], (mid, down))
        tmid, tdown = t(*_targs(i), nchw(i["cond"]), added_cond=added,
                        conditioning_scale=0.7)
        got = tu(*_targs(i), added_cond=added,
                 control_residuals=(tmid, tdown))
    assert len(tdown) == len(down)
    for a, b in zip([tmid] + tdown, [mid] + down):
        close(a, b, TOL[mode])
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_adapter_matches(unet_pair, inputs, mode):
    """The T2I-Adapter's features, then the UNet with them added."""
    boc = JUNetConfig.preset("tiny").block_out_channels
    chans = (boc[0],) + boc[:-1]
    j = JAdapter(chans, downscale=8)
    i = inputs
    p = ref_params(lambda: j.init(K, jnp.asarray(i["cond"])), 5)
    t = port(T2IAdapter, chans, 8, kind="adapter", params=p)
    ju, pu, tu = unet_pair
    with precision(mode, t, tu), torch.no_grad():
        feats = run_jit(j.apply, p, i["cond"])
        ref = run_jit(
            lambda p, a, b, c, d, f: ju.apply(
                p, a, b, c, added_cond=d,
                adapter_features=[x * 0.8 for x in f]),
            pu, i["lat"], i["t"], i["ctx"], i["added"], feats)
        tfeats = t(nchw(i["cond"]))
        got = tu(*_targs(i), added_cond=torch.from_numpy(i["added"]),
                 adapter_features=[f * 0.8 for f in tfeats])
    assert [f.dtype for f in tfeats] == [torch.float32] * len(feats)
    for a, b in zip(tfeats, feats):
        close(a, b, TOL[mode])
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_vae_decode_encode_match(mode):
    j = JVAE(JVAEConfig.preset("tiny"))
    r = np.random.default_rng(7)
    img = r.uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    lat = r.normal(size=(1, 4, 4, 4)).astype(np.float32)
    p = ref_params(lambda: j.init(K, jnp.asarray(img)), 6)
    t = port(AutoencoderKL, VAEConfig.preset("tiny"), kind="vae", params=p)
    with precision(mode, t), torch.no_grad():
        ref_d = run_jit(lambda p, z: j.apply(p, z, method=JVAE.decode),
                        p, lat)
        ref_e = run_jit(lambda p, x: j.apply(p, x, method=JVAE.encode),
                        p, img)
        got_d = t.decode(nchw(lat))
        got_e = t.encode(nchw(img))
    assert got_d.dtype == torch.float32
    close(got_d, ref_d, TOL[mode])
    close(got_e, ref_e, TOL[mode])


@pytest.fixture(scope="module")
def towers():
    j = jte.PromptEncoder("tiny")
    t = tte.PromptEncoder("tiny", device="cpu")
    ids = jnp.zeros((1, 77), jnp.int32)
    j.params_l = ref_params(lambda: j.model_l.init(K, ids), 8)
    j.params_g = ref_params(lambda: j.model_g.init(K, ids), 9)
    for kind, mod, params in (("clip_l", t.model_l, j.params_l),
                              ("clip_g", t.model_g, j.params_g)):
        tw.materialize(mod, "cpu", torch.float32)
        mod.load_state_dict(tw.from_flax(kind, params, mod))
    return j, t


@pytest.mark.parametrize("mode", MODES)
def test_clip_towers_and_prompt_encoder_match(towers, mode):
    """Both towers' (last, penultimate, pooled), then PromptEncoder.encode
    (the reference's own jitted encode, in bf16 only)."""
    j, t = towers
    prompts = ["A photo of chair, 3d model, high resolution",
               "longbody, lowres, bad anatomy"]
    ids = np.stack([j.tok(s) for s in prompts])
    for jm, jp, tm in ((j.model_l, j.params_l, t.model_l),
                       (j.model_g, j.params_g, t.model_g)):
        with precision(mode, tm), torch.no_grad():
            refs = run_jit(jm.apply, jp, ids)
            gots = tm(torch.from_numpy(ids).long())
        for a, b in zip(gots, refs):
            close(a, b, TOL[mode])
    if mode == "bf16":
        ctx, pooled = j.encode(prompts)
        tctx, tpooled = t.encode(prompts)
        assert tctx.shape == ctx.shape and tctx.dtype == torch.float32
        close(tctx, ctx, TOL[mode])
        close(tpooled, pooled, TOL[mode])


# ------------------------------------------------------------- tokenizers

def test_hash_tokenizer_matches():
    for vocab in (1024, 49408):
        a, b = tte.HashTokenizer(vocab), jte.HashTokenizer(vocab)
        for s in ("A photo of Wheelie Bin, 3d model, high resolution",
                  "", "x " * 100):
            np.testing.assert_array_equal(a(s), b(s))


def test_clip_bpe_tokenizer_matches(tmp_path):
    # the temporary vocabulary of tests/test_checkpoints.py
    vocab = {c: i for i, c in enumerate("abcdehlorw")}
    n = len(vocab)
    for piece in ["he", "ll", "hell", "o</w>", "hello</w>", "w", "or",
                  "ld</w>", "world</w>"]:
        vocab[piece] = n
        n += 1
    vocab["<|startoftext|>"] = n
    vocab["<|endoftext|>"] = n + 1
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"),
              ("hell", "o</w>"), ("o", "r"), ("l", "d</w>"),
              ("w", "or"), ("wor", "ld</w>")]
    tdir = tmp_path / "tokenizer"
    tdir.mkdir()
    (tdir / "vocab.json").write_text(json.dumps(vocab))
    (tdir / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    a = tte.make_tokenizer(str(tmp_path), 0, max_len=8)
    b = jte.make_tokenizer(str(tmp_path), 0, max_len=8)
    assert isinstance(a, tte.CLIPTokenizer)
    for s in ("Hello world", "HELLO  &amp; World's 42 héllo!",
              "hello hello world world wor"):
        np.testing.assert_array_equal(a(s), b(s))
    assert a("Hello world")[1] == vocab["hello</w>"]
    assert isinstance(tte.make_tokenizer(None, 1024), tte.HashTokenizer)


# ------------------------------------------------------------ the resize

@pytest.mark.parametrize("shape,size", [((256, 256, 3), 512),
                                        ((32, 32, 3), 64),
                                        ((100, 100, 3), 64),
                                        ((64, 64, 3), 64)])
def test_lanczos_resize_bit_equal_to_pillow(shape, size):
    from PIL import Image
    r = np.random.default_rng(size + shape[0])
    img = r.integers(0, 256, size=shape, dtype=np.uint8)
    img[: shape[0] // 3] = 0                   # a flat background edge
    ref = np.asarray(Image.fromarray(img).resize((size, size),
                                                 Image.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos_uint8(img, size), ref)

"""Parity of the port's weight-only quantisation
(genpc_tpu_torch/models/quant.py) with the JAX reference's on the CPU:
int4 packing and per-channel quantisation bit for bit, ``QuantLinear``
against ``QuantDense``, the quantised tiny MMDiT, T5 and Qwen2.5-VL
towers against the reference's, ``quantize_state`` against
``quantize_tree``, the quantised checkpoint loaders on synthetic
safetensors, and the defaults (None: int4 at full size, bf16 below)."""

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
from genpc_tpu.models import quant as jq
from genpc_tpu.models import qwen_vl as jqv
from genpc_tpu.models import t5 as jt5
from genpc_tpu.models import weights as jw
from genpc_tpu.models.dit import DiTConfig as JDiTConfig
from genpc_tpu.models.dit import MMDiT as JMMDiT
from genpc_tpu_torch.models import quant as tq
from genpc_tpu_torch.models import qwen_vl as tqv
from genpc_tpu_torch.models import t5 as tt5
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.dit import DiTConfig, MMDiT

BITS = (8, 4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_int4_packing_is_bit_equal():
    """The port packs along the input dimension of a torch weight [out,
    in]: its bytes are the reference's [in / 2, out] bytes transposed, and
    it unpacks to the reference's int8 matrix transposed."""
    q = np.random.default_rng(0).integers(-8, 8, (10, 6)).astype(np.int8)
    ref = np.asarray(jq.pack_int4(jnp.asarray(q)))
    got = tq.pack_int4(_t(q.T))
    assert got.dtype == torch.int8 and got.shape == (6, 5)
    np.testing.assert_array_equal(got.numpy(), ref.T)
    np.testing.assert_array_equal(tq.unpack_int4(got).numpy(),
                                  np.asarray(jq.unpack_int4(ref)).T)
    np.testing.assert_array_equal(tq.unpack_int4(got).numpy(), q.T)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_array_is_bit_equal(bits):
    """Codes and scales equal to the reference's bit for bit (round half
    to even, IEEE division), a column of zeros (the 1e-12 floor) and
    exact ties among the inputs included."""
    r = np.random.default_rng(bits)
    w = r.normal(0, 0.05, (16, 12)).astype(np.float32)
    w[:, 3] = 0.0
    qmax = tq.QMAX[bits]
    w[:, 5] = np.array([qmax, -qmax, 0.5, -0.5, 1.5, -2.5, 3.5, 0.0] * 2,
                       np.float32)       # scale 1: every .5 is a tie
    q_ref, s_ref = jq.quantize_array(jnp.asarray(w), bits)
    q, s = tq.quantize_array(_t(w.T), bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(
        tq.dequantize_array(q, s, bits=bits).numpy(),
        np.asarray(jq.dequantize_array(q_ref, s_ref, bits=bits)).T)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", BITS)
def test_quant_linear_matches_quant_dense(bits, mode):
    """One QuantDense tree (a full-precision Dense quantised by
    quantize_tree) carried across to QuantLinear: the same outputs, fp32
    1e-5, bf16 3e-2 of the largest |y|."""
    r = np.random.default_rng(3)
    x = r.normal(size=(3, 5, 32)).astype(np.float32)
    fp = {"params": {"dense": {
        "kernel": r.normal(0, 0.2, (32, 24)).astype(np.float32),
        "bias": r.normal(0, 0.1, (24,)).astype(np.float32)}}}
    qtree = jq.quantize_tree(fp, bits, lambda p: True)
    dtype = jnp.float32 if mode == "f32" else jnp.bfloat16

    class Net(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jq.QuantDense(24, bits=bits, dtype=dtype,
                                 name="dense")(x)

    ref = run_jit(lambda p, a: Net().apply(p, a), qtree, x)
    m = tq.QuantLinear(32, 24, bits,
                       compute=torch.float32 if mode == "f32"
                       else torch.bfloat16)
    d = qtree["params"]["dense"]
    kernel = d["kernel_p4"] if bits == 4 else d["kernel"]
    m.load_state_dict({"weight": _t(np.asarray(kernel).T),
                       "scale": _t(d["scale"]), "bias": _t(d["bias"])})
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == (torch.float32 if mode == "f32" else torch.bfloat16)
    close(got.float(), np.asarray(ref, np.float32), TOL[mode])


def _w4_layer(compute, bias=True, seed=4):
    """A QuantLinear(64 -> 24, int4) with seeded codes, scale and bias, and
    an input [2, 3, 64] in its compute type."""
    g = torch.Generator().manual_seed(seed)
    m = tq.QuantLinear(64, 24, 4, bias=bias, compute=compute)
    state = {"weight": tq.pack_int4(torch.randint(-7, 8, (24, 64),
                                                  generator=g)),
             "scale": torch.rand(24, generator=g) * 0.1 + 1e-3}
    if bias:
        state["bias"] = torch.randn(24, generator=g)
    m.load_state_dict(state)
    return m, torch.randn(2, 3, 64, generator=g).to(compute)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_quant_linear_int4_takes_the_plain_path_on_the_cpu(compute, bias):
    """On the CPU an int4 QuantLinear is K6's plain twin, bit for bit the
    unpack, fp32 product, scale, bias and cast it always was, and counts
    one ``quant_w4_plain`` a call and no kernel launch."""
    from genpc_tpu_torch import tracing
    m, x = _w4_layer(compute, bias)
    launches = (tq._w4_gemm.launches, tq._w4_gemv.launches)
    with tracing.recording() as rec, tracing.span("fwd"), torch.no_grad():
        got = m(x)
        m(x[0])
    y = tq.matmul_f32(x, tq.unpack_int4(m.weight, compute))
    y = y * m.scale if m.bias is None else torch.addcmul(m.bias, y, m.scale)
    assert got.dtype == compute and torch.equal(got, y.to(compute))
    assert torch.equal(got, tq.w4_linear_plain(x, m.weight, m.scale, m.bias))
    flat = rec.flat()
    assert flat["fwd:quant_w4_plain"] == 2 and "fwd:quant_w4" not in flat
    assert (tq._w4_gemm.launches, tq._w4_gemv.launches) == launches


def test_quant_linear_int8_keeps_its_path_and_counts_nothing():
    from genpc_tpu_torch import tracing
    g = torch.Generator().manual_seed(6)
    m = tq.QuantLinear(32, 16, 8, compute=torch.bfloat16)
    m.load_state_dict({"weight": torch.randint(-127, 128, (16, 32),
                                               generator=g).to(torch.int8),
                       "scale": torch.rand(16, generator=g) * 1e-3,
                       "bias": torch.randn(16, generator=g)})
    x = torch.randn(5, 32, generator=g).to(torch.bfloat16)
    with tracing.recording() as rec, tracing.span("fwd"), torch.no_grad():
        got = m(x)
    want = torch.addcmul(m.bias, tq.matmul_f32(x, m.weight.to(torch.bfloat16)),
                         m.scale).to(torch.bfloat16)
    assert torch.equal(got, want)
    assert not any(k.startswith("fwd:quant_w4") for k in rec.flat())


@pytest.mark.parametrize("m,n,bm", [
    (256, 3072, 64), (512, 3072, 192), (768, 3072, 192), (3072, 3072, 192),
    (4608, 3072, 256), (256, 12288, 256), (768, 12288, 192),
    (4608, 12288, 256), (512, 10240, 192), (1000, 1280, 64)])
def test_k6_row_tile_follows_the_waves(m, n, bm):
    """K6's tensor-core tile on a 132-SM card: 64 rows where 256 and 192
    would leave half the SMs idle, else the one whose waves of blocks
    cost less (the FLUX paint, generation and T5 classes)."""
    assert tq.w4_row_tile(m, n, 132) == bm


def test_int4_layer_needs_no_kernel_library_off_the_card(monkeypatch):
    """Building and running an int4 layer on the CPU neither builds nor
    loads the kernel library (no nvcc here); another device raises
    rather than falling back."""
    from genpc_tpu_torch import _kernels

    def no_library(*a, **k):
        raise AssertionError("the kernel library was asked for")
    monkeypatch.setattr(_kernels, "lib", no_library)
    monkeypatch.setattr(_kernels, "build", no_library)
    monkeypatch.setattr(_kernels, "_nvcc", no_library)
    m, x = _w4_layer(torch.bfloat16)
    with torch.no_grad():
        assert m(x).shape == (2, 3, 24)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tq.w4_linear(x.to("meta"), m.weight.to("meta"), m.scale.to("meta"),
                     m.bias.to("meta"))



def test_k6_counts_a_captured_launch_at_each_replay():
    """A K6 launch a stream capture records counts (``launches`` and the
    ``quant_w4`` counter) at each replay of the graph, not at the
    capture; an uncaptured one counts once (bookkeeping only: no kernel
    runs here)."""
    from genpc_tpu_torch import _kernels, tracing
    before = tq._w4_gemm.launches
    with tracing.recording() as rec, tracing.span("step"):
        with _kernels.Captured() as launches:
            with _kernels.traced(tq._w4_gemm, (64, 128, 256)):
                pass
        assert tq._w4_gemm.launches == before
        for _ in range(3):
            launches.replayed()
        with _kernels.traced(tq._w4_gemm, (64, 128, 256)):
            pass
    assert tq._w4_gemm.launches == before + 4
    assert rec.flat()["step:quant_w4"] == 4

# ------------------------------------------------ quantised models

def _dit_case(bits, seed=1):
    """The tiny FLUX-family MMDiT: inputs, the reference's quantised
    tree (quantize_tree of ref_params) and forward."""
    jcfg = JDiTConfig.preset("tiny")
    r = np.random.default_rng(seed)
    f = np.float32
    x = dict(lat=r.normal(size=(2, 8, 8, 4)).astype(f),
             t=np.array([0.83, 0.27], f),
             txt=r.normal(size=(2, 12, 64)).astype(f),
             cond=r.normal(size=(2, 8, 8, 4)).astype(f),
             pooled=r.normal(size=(2, 32)).astype(f),
             guidance=np.array([10.0, 10.0], f))
    fp_model = JMMDiT(jcfg)
    fp = ref_params(lambda: fp_model.init(
        jax.random.PRNGKey(0), jnp.asarray(x["lat"]), jnp.asarray(x["t"]),
        jnp.asarray(x["txt"]), pooled=x["pooled"],
        cond_latents=jnp.asarray(x["cond"]), guidance=x["guidance"]), seed)
    qm = JMMDiT(JDiTConfig(**{**jcfg.__dict__, "quant_bits": bits}))
    qtree = jq.quantize_tree(fp, bits, jq.dit_block_select)

    def fwd(p, lat, t, txt, cond, pooled, g):
        return qm.apply(p, lat, t, txt, pooled=pooled, cond_latents=cond,
                        guidance=g)
    return x, fp, qtree, fwd


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", BITS)
def test_quantized_mmdit_matches_the_reference(bits, mode):
    x, _, qtree, fwd = _dit_case(bits)
    m = port(MMDiT, DiTConfig(**{**DiTConfig.preset("tiny").__dict__,
                                 "quant_bits": bits}),
             kind="dit", params=qtree)
    blk = m.transformer_blocks[0]
    assert isinstance(blk.attn.to_q, tq.QuantLinear)
    assert isinstance(blk.norm1.linear, tq.QuantLinear)
    assert not isinstance(m.x_embedder, tq.QuantLinear)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, m), torch.no_grad():
        ref = run_jit(fwd, qtree, x["lat"], x["t"], x["txt"], x["cond"],
                      x["pooled"], x["guidance"])
        got = m(nchw(x["lat"]), torch.from_numpy(x["t"]),
                torch.from_numpy(x["txt"]),
                pooled=torch.from_numpy(x["pooled"]),
                cond_latents=nchw(x["cond"]),
                guidance=torch.from_numpy(x["guidance"]))
    if mode == "f32":
        jax.clear_caches()
    close(got, ref, TOL[mode])


def _t5_case(bits, seed=2):
    cfg = jt5.T5Config.preset("tiny")
    r = np.random.default_rng(seed)
    ids = r.integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, 11:] = False
    fp = ref_params(lambda: jt5.T5Encoder(cfg).init(
        jax.random.PRNGKey(0), ids, mask), seed)
    qcfg = jt5.T5Config(**{**cfg.__dict__, "quant_bits": bits})
    return ids, mask, fp, qcfg


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", BITS)
def test_quantized_t5_matches_the_reference(bits, mode):
    ids, mask, fp, qcfg = _t5_case(bits)
    qtree = jq.quantize_tree(fp, bits, jq.t5_block_select)
    m = port(tt5.T5Encoder, tt5.T5Config(**qcfg.__dict__), kind="t5",
             params=qtree)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, m), torch.no_grad():
        ref = run_jit(lambda p, a, b: jt5.T5Encoder(qcfg).apply(p, a, b),
                      qtree, ids, mask)
        got = m(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    if mode == "f32":
        jax.clear_caches()
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("tower", ["text", "vision"])
def test_quantized_qwen_vl_towers_match_the_reference(tower, bits):
    """Both towers with their layers' and blocks' matmuls quantised, in
    the packages' own compute types (bf16 bound)."""
    cfg = jqv.QwenVLConfig.preset("tiny")
    qcfg = jqv.QwenVLConfig(**{**cfg.__dict__, "quant_bits": bits})
    tcfg = tqv.QwenVLConfig(**{**tqv.QwenVLConfig.preset("tiny").__dict__,
                               "quant_bits": bits})
    r = np.random.default_rng(4)
    if tower == "text":
        L = 12
        ids = r.integers(8, cfg.vocab_size, (1, L)).astype(np.int32)
        pos = np.broadcast_to(np.arange(L)[None, None], (3, 1, L)).astype(
            np.int32)
        fp = ref_params(lambda: jqv.QwenVLTextModel(cfg).init(
            jax.random.PRNGKey(0), ids, pos), 5)
        qtree = jq.quantize_tree(fp, bits, jq.vl_block_select)
        ref = run_jit(lambda p, a, b: jqv.QwenVLTextModel(qcfg).apply(
            p, a, b), qtree, ids, pos)
        m = port(tqv.QwenVLTextModel, tcfg, kind="qwen_vl_text",
                 params=qtree)
        assert isinstance(m.layers[0].mlp.down_proj, tq.QuantLinear)
        with torch.no_grad():
            got = m(torch.from_numpy(ids).long(),
                    torch.from_numpy(pos).long())
    else:
        grid = 8
        patches = r.normal(size=(grid * grid, 3 * cfg.temporal_patch
                                 * cfg.patch ** 2)).astype(np.float32)
        fp = ref_params(lambda: jqv.QwenVisionModel(cfg).init(
            jax.random.PRNGKey(0), patches, grid), 6)
        qtree = jq.quantize_tree(fp, bits, jq.vl_block_select)
        ref = run_jit(lambda p, a: jqv.QwenVisionModel(qcfg).apply(
            p, a, grid), qtree, patches)
        m = port(tqv.QwenVisionModel, tcfg, kind="qwen_vl_vision",
                 params=qtree)
        assert isinstance(m.blocks[0].attn.qkv, tq.QuantLinear)
        assert not isinstance(m.merger.mlp[0], tq.QuantLinear)
        with torch.no_grad():
            got = m(torch.from_numpy(patches), grid)
    close(got, ref, TOL["bf16"])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("model", ["dit", "t5"])
def test_quantize_state_matches_quantize_tree(model, bits):
    """The full-precision tree carried across and quantised by the port
    (quantize_state) equals the reference's quantize_tree carried across,
    tensor for tensor, bit for bit; the keys are the quantised module's."""
    if model == "dit":
        _, fp, _, _ = _dit_case(bits)
        qtree = jq.quantize_tree(fp, bits, jq.dit_block_select)
        cfg = DiTConfig.preset("tiny")
        fp_mod, q_mod = (MMDiT(DiTConfig(**{**cfg.__dict__,
                                            "quant_bits": b}))
                         for b in (0, bits))
        select = tq.dit_block_select
    else:
        _, _, fp, qcfg = _t5_case(bits)
        qtree = jq.quantize_tree(fp, bits, jq.t5_block_select)
        fp_mod = tt5.T5Encoder(tt5.T5Config.preset("tiny"))
        q_mod = tt5.T5Encoder(tt5.T5Config(**qcfg.__dict__))
        select = tq.t5_block_select
    got = tq.quantize_state(tw.from_flax(model, fp, fp_mod), bits, select)
    ref = tw.from_flax(model, qtree, q_mod)
    assert set(got) == set(ref) == set(q_mod.state_dict())
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        assert torch.equal(got[k], ref[k]), k
    assert {k: tuple(v) for k, v in tq.fp_template_like(q_mod).items()} \
        == {k: tuple(v.shape) for k, v in fp_mod.state_dict().items()}
    assert tq.logical_params(q_mod) == sum(
        p.numel() for p in fp_mod.parameters())


@pytest.mark.parametrize("bits", BITS)
def test_quantized_loaders_match_the_reference(tmp_path, bits):
    """One synthetic FluxTransformer2DModel and one T5EncoderModel
    checkpoint (checkpoint_specs) under <weights_dir>/flux and
    /text_encoder_2: the reference's load_dit and load_t5_and_clip_l
    (quantize_tree after the graft) and the port's (load_quantized)
    give the same ints and scales."""
    from safetensors.numpy import save_file
    jcfg = JDiTConfig.preset("tiny")
    t5cfg = jt5.T5Config.preset("tiny")
    for sub, spec in (("flux", specs.spec_flux_transformer(jcfg)),
                      ("text_encoder_2", specs.spec_t5_encoder(t5cfg))):
        os.makedirs(tmp_path / sub)
        ckpt = jw.synthetic_checkpoint(spec, seed=7)
        if sub == "text_encoder_2":     # the tied duplicate HF may ship
            ckpt["encoder.embed_tokens.weight"] = ckpt["shared.weight"]
        save_file(ckpt, str(tmp_path / sub / "model.safetensors"))
    _, fp, qtree, _ = _dit_case(bits)
    ref = jw.load_dit(str(tmp_path), {"dit": qtree}, "flux",
                      quant_bits=bits)["dit"]
    _, _, fp5, qcfg5 = _t5_case(bits)
    ref5, _ = jw.load_t5_and_clip_l(
        str(tmp_path), jq.quantize_tree(fp5, bits, jq.t5_block_select),
        {}, quant_bits=bits)
    with torch.device("meta"):
        m = MMDiT(DiTConfig(**{**DiTConfig.preset("tiny").__dict__,
                               "quant_bits": bits}))
        t5 = tt5.T5Encoder(tt5.T5Config(**qcfg5.__dict__))
    for mod in (m, t5):
        tw.materialize(mod, "cpu", torch.float32)
    tw.load_dit(str(tmp_path), SimpleNamespace(model=m), "flux")
    tw.load_t5_and_clip_l(str(tmp_path), t5, None)
    for got_mod, kind, tree in ((m, "dit", ref), (t5, "t5", ref5)):
        want = tw.from_flax(kind, tree, got_mod)
        for k, v in got_mod.state_dict().items():
            assert torch.equal(v, want[k]), (kind, k)


def test_defaults_are_the_references():
    """None: int4 at full size and bf16 below; an explicit value wins; 4
    and 8 build; another width raises (as the reference's _QMAX lookup)."""
    from genpc_tpu.models.dit_depth import _default_quant_bits
    for full in (True, False):
        for qb in (None, 0, 4, 8):
            assert tqv.resolve_quant_bits(qb, full) == \
                _default_quant_bits("flux", full, qb)
    for bad in (2, 3, 16):
        with pytest.raises(ValueError):
            tqv.resolve_quant_bits(bad, True)
        with pytest.raises(KeyError):
            jq.quantize_array(jnp.ones((2, 2)), bad)
    assert tq.tree_bytes(tq.QuantLinear(8, 6, 4)) == 6 * 4 + 6 * 4 * 2

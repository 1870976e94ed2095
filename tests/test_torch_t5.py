"""Parity of the port's T5 v1.1 encoder and FLUX prompt encoder
(genpc_tpu_torch/models/t5.py) with the JAX reference's on the CPU: the
relative-position buckets, the hash tokenizer, the tiny T5 encoder with
a key mask in both precision modes, ``T5PromptEncoder.encode`` (T5
context and CLIP-L pooled vector), the HF checkpoint names and the
T5-XXL parameter count on the meta device, and one synthetic checkpoint
loaded by both packages."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, TOL, close, port, precision, \
    ref_params, run_jit
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.models import checkpoint_specs as specs
from genpc_tpu.models import t5 as jt5
from genpc_tpu.models import weights as jw
from genpc_tpu_torch.models import t5 as tt5
from genpc_tpu_torch.models import weights as tw

PROMPTS = ["complete the depth map. ",
           "A raw photo of a chair. no reflections, high quality, rich "
           "details. Shot with a macro lens (f/2.8, 50mm) and a Canon EOSR5"]


@pytest.mark.parametrize("qlen,buckets,dist", [(16, 32, 128), (512, 32, 128),
                                               (40, 8, 20)])
def test_relative_buckets_match(qlen, buckets, dist):
    np.testing.assert_array_equal(
        tt5.t5_relative_buckets(qlen, qlen, buckets, dist),
        jt5.t5_relative_buckets(qlen, qlen, buckets, dist))


@pytest.mark.parametrize("max_len", [32, 512, 4])
def test_hash_tokenizer_ids_match(max_len):
    """Ids and masks equal for the pipeline's prompts, a long one cut at
    max_len - 1 words plus EOS, and an empty one."""
    ref = jt5.T5HashTokenizer(32128, max_len)
    got = tt5.T5HashTokenizer(32128, max_len)
    for text in PROMPTS + ["word " * 600, ""]:
        (ri, rm), (gi, gm) = ref(text), got(text)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gm, rm)


def _inputs(cfg, L=20, seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(2, cfg.vocab_size, (2, L)).astype(np.int32)
    mask = np.ones((2, L), bool)
    mask[1, 13:] = False
    return ids, mask


@pytest.mark.parametrize("mode", MODES)
def test_t5_encoder_matches_the_reference(mode):
    """The tiny encoder on two sequences, the second's last 7 tokens
    masked off: fp32 1e-5, bf16 3e-2 of the largest |h|; masked tokens 0."""
    cfg = jt5.T5Config.preset("tiny")
    ids, mask = _inputs(cfg)
    params = ref_params(lambda: jt5.T5Encoder(cfg).init(
        jax.random.PRNGKey(0), ids, mask), 1)
    m = port(tt5.T5Encoder, tt5.T5Config.preset("tiny"), kind="t5",
             params=params)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, m), torch.no_grad():
        ref = run_jit(lambda p, a, b: jt5.T5Encoder(cfg).apply(p, a, b),
                      params, ids, mask)
        got = m(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    if mode == "f32":
        jax.clear_caches()
    assert got.dtype == torch.float32
    assert not got[1, 13:].any()
    close(got, ref, TOL[mode])


@pytest.fixture(scope="module")
def encoders():
    """The reference's T5PromptEncoder and the port's, tiny, with the same
    weights."""
    j = jt5.T5PromptEncoder("tiny")
    j.params = ref_params(lambda: j.params, 2)
    j.params_l = ref_params(lambda: j.params_l, 3)
    t = tt5.T5PromptEncoder("tiny", device="cpu")
    trees = {"t5": j.params, "clip_l": j.params_l}
    t.init_params({kind: tw.from_flax(kind, trees[kind], mod)
                   for kind, mod in t.models().items()})
    return j, t


@pytest.mark.parametrize("mode", MODES)
def test_prompt_encoder_matches_the_reference(encoders, mode):
    """encode over two prompts at once: the T5 context [2, 32, 64] and
    the CLIP-L pooled vector, each within the mode's bound."""
    j, t = encoders
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, *t.models().values()):
        ctx_ref, pooled_ref = j.encode(PROMPTS)
        ctx, pooled = t.encode(PROMPTS)
    if mode == "f32":
        jax.clear_caches()
    assert ctx.shape == (2, 32, 64) and pooled.shape == (2, 64)
    close(ctx, ctx_ref, TOL[mode])
    close(pooled, pooled_ref, TOL[mode])


def _names(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_xxl_names_and_count_on_the_meta_device():
    """T5-XXL on the meta device carries T5EncoderModel's names and shapes
    (checkpoint_specs.spec_t5_encoder), maps onto the reference's leaves
    (jax.eval_shape) with the transposed shapes, and counts what the
    reference's tree counts: 4,762,310,656 parameters."""
    with torch.device("meta"):
        m = tt5.T5Encoder(tt5.T5Config.preset("xxl"))
    jcfg = jt5.T5Config.preset("xxl")
    assert _names(m) == specs.spec_t5_encoder(jcfg)
    shapes = dict(jw.tree_shapes(fnn.meta.unbox(jax.eval_shape(
        lambda: jt5.T5Encoder(jcfg).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32))))))
    ref = sum(int(np.prod(s)) for s in shapes.values())
    for name, shape in _names(m).items():
        path = tw.flax_path("t5", name)
        leaf = np.broadcast_to(np.float32(0), shapes.pop(path))
        assert tw.flax_layout(path, leaf).shape == shape, name
    assert not shapes, sorted(shapes)[:4]
    assert sum(p.numel() for p in m.parameters()) == ref == 4_762_310_656


def test_synthetic_t5_checkpoint_loads_in_both_packages(tmp_path):
    """One synthetic T5EncoderModel checkpoint (with the tied
    embed_tokens duplicate) under <weights_dir>/text_encoder_2, loaded by
    the reference's load_t5_and_clip_l and by the port's: the port holds
    the checkpoint's tensors, and with every layer in fp32 both encoders
    give the same states."""
    from safetensors.numpy import save_file
    cfg = jt5.T5Config.preset("tiny")
    ckpt = jw.synthetic_checkpoint(specs.spec_t5_encoder(cfg), seed=9)
    ckpt["encoder.embed_tokens.weight"] = ckpt["shared.weight"]
    os.makedirs(tmp_path / "text_encoder_2")
    save_file(ckpt, str(tmp_path / "text_encoder_2" / "model.safetensors"))
    ids, mask = _inputs(cfg, seed=4)
    params = ref_params(lambda: jt5.T5Encoder(cfg).init(
        jax.random.PRNGKey(0), ids, mask), 0)
    params, _ = jw.load_t5_and_clip_l(str(tmp_path), params, {})
    with torch.device("meta"):
        m = tt5.T5Encoder(tt5.T5Config.preset("tiny"))
    tw.materialize(m, "cpu", torch.float32)
    tw.load_t5_and_clip_l(str(tmp_path), m, None)
    for name, v in m.state_dict().items():
        assert torch.equal(v, torch.from_numpy(ckpt[name])), name
    jax.clear_caches()
    with precision("f32", m), torch.no_grad():
        ref = run_jit(lambda p, a, b: jt5.T5Encoder(cfg).apply(p, a, b),
                      params, ids, mask)
        got = m(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    jax.clear_caches()
    close(got, ref, TOL["f32"])

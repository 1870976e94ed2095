"""Parity of the port's Qwen2.5-VL towers and prompt encoder
(genpc_tpu_torch/models/qwen_vl.py) with the JAX reference's on the CPU:
the text tower on three distinct M-RoPE planes with a key mask, the
vision tower over several attention windows, ``QwenVLEncoder.encode``
with and without an image, the HF checkpoint names and the full towers'
parameter counts, and one synthetic checkpoint (both prefix layouts)
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
from genpc_tpu.models import qwen_vl as jqv
from genpc_tpu.models import weights as jw
from genpc_tpu_torch.models import qwen_vl as tqv
from genpc_tpu_torch.models import weights as tw

L = 24
GRID = 8       # 8x8 patches of the tiny preset: 2x2 windows of 4x4


def _text_inputs(cfg):
    """Two sequences of ids, three distinct position planes (as an image
    span makes them: t constant, h and w on a grid), the second
    sequence's last 5 keys masked off."""
    r = np.random.default_rng(0)
    ids = r.integers(8, cfg.vocab_size, (2, L))
    base = np.arange(L)
    span = np.arange(6, 15)                     # a 3x3 "image" span
    t, h, w = base.copy(), base.copy(), base.copy()
    t[span] = 6
    h[span] = 6 + (span - 6) // 3
    w[span] = 6 + (span - 6) % 3
    t[15:] = h[15:] = w[15:] = 9 + np.arange(L - 15)
    pos = np.broadcast_to(np.stack([t, h, w])[:, None], (3, 2, L)).copy()
    mask = np.ones((2, L), bool)
    mask[1, -5:] = False
    return ids.astype(np.int32), pos.astype(np.int32), mask


@pytest.mark.parametrize("mode", MODES)
def test_text_tower_matches_the_reference(mode):
    cfg = jqv.QwenVLConfig.preset("tiny")
    ids, pos, mask = _text_inputs(cfg)
    assert len({tuple(p) for p in pos[:, 0]}) == 3
    m = jqv.QwenVLTextModel(cfg)
    params = ref_params(lambda: m.init(jax.random.PRNGKey(0), ids, pos), 1)
    t = port(tqv.QwenVLTextModel, tqv.QwenVLConfig.preset("tiny"),
             kind="qwen_vl_text", params=params)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, t), torch.no_grad():
        ref = run_jit(lambda p, a, b, c: m.apply(p, a, b, c), params, ids,
                      pos, mask)
        got = t(torch.from_numpy(ids).long(), torch.from_numpy(pos).long(),
                torch.from_numpy(mask))
    if mode == "f32":
        jax.clear_caches()
    assert got.dtype == torch.float32
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_vision_tower_matches_the_reference(mode):
    cfg = jqv.QwenVLConfig.preset("tiny")
    r = np.random.default_rng(1)
    patches = r.normal(size=(GRID * GRID, 3 * cfg.temporal_patch
                             * cfg.patch ** 2)).astype(np.float32)
    m = jqv.QwenVisionModel(cfg)
    params = ref_params(lambda: m.init(jax.random.PRNGKey(0), patches,
                                       GRID), 2)
    t = port(tqv.QwenVisionModel, tqv.QwenVLConfig.preset("tiny"),
             kind="qwen_vl_vision", params=params)
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, t), torch.no_grad():
        ref = run_jit(lambda p, x: m.apply(p, x, GRID), params, patches)
        got = t(torch.from_numpy(patches), GRID)
    if mode == "f32":
        jax.clear_caches()
    assert got.shape == (GRID * GRID // 4, cfg.hidden)
    close(got, ref, TOL[mode])


def test_vision_helpers_match():
    cfg = jqv.QwenVLConfig.preset("full")
    tcfg = tqv.QwenVLConfig.preset("full")
    assert tqv.snap_vision_px(392, tcfg) == jqv.snap_vision_px(392, cfg) \
        == 448
    g = 448 // 14
    np.testing.assert_array_equal(tqv.window_permutation(g, tcfg),
                                  jqv.window_permutation(g, cfg))
    np.testing.assert_array_equal(tqv.vision_rope(g, tcfg),
                                  jqv.vision_rope(g, cfg))
    img = np.random.default_rng(3).random((56, 56, 3)).astype(np.float32)
    np.testing.assert_array_equal(tqv.image_to_patches(img, tcfg),
                                  jqv.image_to_patches(img, cfg))


@pytest.fixture(scope="module")
def encoders():
    """The reference's QwenVLEncoder and the port's, tiny, with the same
    weights."""
    j = jqv.QwenVLEncoder("tiny")
    j.params_text = ref_params(lambda: j.params_text, 3)
    j.params_vision = ref_params(lambda: j.params_vision, 4)
    t = tqv.QwenVLEncoder("tiny", device="cpu")
    trees = {"qwen_vl_text": j.params_text,
             "qwen_vl_vision": j.params_vision}
    t.init_params({kind: tw.from_flax(kind, trees[kind], mod)
                   for kind, mod in t.models().items()})
    return j, t


def _depth(seed=5, res=40):
    r = np.random.default_rng(seed)
    return r.random((res, res, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("with_image", [True, False],
                         ids=["image", "text"])
def test_encode_matches_the_reference(encoders, with_image, mode):
    """encode(prompt[, image]): the template, the image slot's tokens (the
    Pillow bicubic resize, the patches and the vision tower), the M-RoPE
    ids and the dropped prefix, end to end."""
    j, t = encoders
    prompt = "A highly realistic chair, shown from a 3/4 view."
    image = _depth() if with_image else None
    if mode == "f32":
        jax.clear_caches()
    with precision(mode, *t.models().values()):
        ref = np.asarray(j.encode(prompt, image))
        got = t.encode(prompt, image)
    if mode == "f32":
        jax.clear_caches()
    n = len(t._ids(prompt)) + len(t._ids(jqv.EDIT_TEMPLATE_SUFFIX))
    if with_image:      # "Picture 1:", the slot's ends and the merged grid
        n += 4 + (t.vision_px // t.cfg.patch // t.cfg.merge) ** 2
    assert ref.shape == (1, n, t.cfg.hidden)
    close(got, ref, TOL[mode])


def test_mrope_positions_match(encoders):
    j, t = encoders
    np.testing.assert_array_equal(t.mrope_positions(9, 16, 7).numpy(),
                                  np.asarray(j._mrope_positions(9, 16, 7)))


def _shapes(kind, module):
    return {tw.flax_path(kind, k): tuple(v.shape)
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_names_and_counts_match(size):
    """On the meta device the towers carry the HF names and shapes of
    checkpoint_specs below their prefixes, take every leaf of the
    reference's trees (jax.eval_shape), and count as many parameters: at
    full size 7,070,619,136 (text) and 676,550,144 (vision)."""
    cfg = jqv.QwenVLConfig.preset(size)
    tcfg = tqv.QwenVLConfig.preset(size)
    with torch.device("meta"):
        text, vision = tqv.QwenVLTextModel(tcfg), tqv.QwenVisionModel(tcfg)
    g = tqv.snap_vision_px(392 if size == "full" else 16, tcfg) // tcfg.patch
    k = jax.random.PRNGKey(0)
    trees = {
        "qwen_vl_text": jax.eval_shape(lambda: jqv.QwenVLTextModel(cfg).init(
            k, jnp.zeros((1, 8), jnp.int32), jnp.zeros((3, 1, 8),
                                                       jnp.int32))),
        "qwen_vl_vision": jax.eval_shape(
            lambda: jqv.QwenVisionModel(cfg).init(
                k, jnp.zeros((g * g, 3 * cfg.temporal_patch
                              * cfg.patch ** 2)), g))}
    spec = {"qwen_vl_text": specs.spec_qwen_vl_text(cfg),
            "qwen_vl_vision": specs.spec_qwen_vl_vision(cfg)}
    counts = {}
    for kind, mod in (("qwen_vl_text", text), ("qwen_vl_vision", vision)):
        pre = tw.QWEN_VL_PREFIXES[kind][0]
        assert {pre + n: tuple(v.shape) for n, v in
                mod.state_dict().items()} == spec[kind]
        ref = jw.tree_shapes(fnn.meta.unbox(trees[kind]))
        got = _shapes(kind, mod)
        assert set(got) == set(ref), kind
        for path, shape in got.items():
            assert int(np.prod(shape)) == int(np.prod(ref[path])), path
        counts[kind] = sum(p.numel() for p in mod.parameters())
        assert counts[kind] == sum(int(np.prod(s)) for s in ref.values())
    if size == "full":
        assert counts == {"qwen_vl_text": 7_070_619_136,
                          "qwen_vl_vision": 676_550_144}


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_synthetic_checkpoint_loads_in_both_packages(tmp_path, layout,
                                                     encoders):
    """One synthetic Qwen2_5_VLForConditionalGeneration checkpoint
    (checkpoint_specs names, an lm_head and a rotary buffer beside them,
    in the transformers>=4.52 or the older prefix layout) under
    <weights_dir>/text_encoder, loaded by the reference's load_qwen_vl and
    by the port's encoder: the port holds the checkpoint's tensors, and
    with every layer in fp32 both encode the same features."""
    from safetensors.numpy import save_file
    cfg = jqv.QwenVLConfig.preset("tiny")
    ckpt = jw.synthetic_checkpoint({**specs.spec_qwen_vl_text(cfg),
                                    **specs.spec_qwen_vl_vision(cfg)},
                                   seed=6)
    if layout == "legacy":
        ckpt = {k.replace("model.language_model.", "model.")
                 .replace("model.visual.", "visual."): v
                for k, v in ckpt.items()}
    extra = {"lm_head.weight": np.zeros((cfg.vocab_size, cfg.hidden),
                                        np.float32),
             "model.rotary_emb.inv_freq": np.zeros(8, np.float32)}
    os.makedirs(tmp_path / "text_encoder")
    save_file({**ckpt, **extra},
              str(tmp_path / "text_encoder" / "model.safetensors"))
    j = encoders[0]        # the reference encoder, its weights swapped
    saved = j.params_text, j.params_vision
    t = tqv.QwenVLEncoder("tiny", weights_dir=str(tmp_path), device="cpu")
    t.init_params()
    prefixes = {"qwen_vl_text": "model." if layout == "legacy"
                else "model.language_model.",
                "qwen_vl_vision": "visual." if layout == "legacy"
                else "model.visual."}
    for kind, mod in t.models().items():
        for name, v in mod.state_dict().items():
            want = ckpt[prefixes[kind] + name]
            assert torch.equal(v, torch.from_numpy(want)), name
    jax.clear_caches()
    try:
        j.params_text, j.params_vision = jw.load_qwen_vl(
            str(tmp_path), *saved)
        with precision("f32", *t.models().values()):
            ref = np.asarray(j.encode("a chair", _depth(7)))
            got = t.encode("a chair", _depth(7))
    finally:
        j.params_text, j.params_vision = saved
        jax.clear_caches()
    close(got, ref, TOL["f32"])

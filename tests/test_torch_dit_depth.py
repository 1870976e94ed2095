"""Parity of the port's Qwen-Image-Edit depth->image backend
(genpc_tpu_torch/models/dit_depth.py) with the JAX reference's on the
CPU: generate_batch end to end on the reference's jax.random draws, the
grouping of objects into generate_obj_batch chunks, run_batched with the
backend against the reference's run_batched, the quantisation settings,
the FLUX variant's constructors, and release().

Both backends carry the same weights (torch_models_ref.ref_params through
weights.from_flax); the port's per-object draws are replaced by the
reference's (a fold_in of a running object counter into its key).
"""

import os

import jax
import numpy as np
import pytest
import torch
from torch_models_ref import precision, ref_params
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models.dit_depth import DiTDepthEdit as JDiT
from genpc_tpu_torch.io.synthetic_data import write_dataset
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.backends import get_depth2image
from genpc_tpu_torch.models.dit_depth import DiTDepthEdit, FluxInpainter
from genpc_tpu_torch.tracing import recording

SIZE = 64
#: max |port - reference| over the [0, 1] images: test_torch_generate's
#: IMAGE_TOL (bf16 rounds at other points inside a layer in the two
#: packages, and true CFG 4.0 multiplies the gap between the branches
#: over 8 steps; in fp32 only summation order is left)
IMAGE_TOL = {"bf16": 0.08, "f32": 1e-4}


@pytest.fixture(scope="module")
def backends():
    """The reference's DiTDepthEdit and the port's, tiny Qwen, with the
    same weights."""
    j = JDiT(jconfig.load_config(model_size="tiny"), variant="qwen")
    hw = SIZE // j.factor
    j._params = ref_params(lambda: j._init_params(hw), 1)
    j._latent_hw = hw
    j.vl.params_text = ref_params(lambda: j.vl.params_text, 2)
    j.vl.params_vision = ref_params(lambda: j.vl.params_vision, 3)
    t = DiTDepthEdit(tconfig.load_config(device="cpu", model_size="tiny"))
    trees = {"dit": j._params["dit"], "vae": j._params["vae"],
             "qwen_vl_text": j.vl.params_text,
             "qwen_vl_vision": j.vl.params_vision}
    t.init_params({kind: tw.from_flax(kind, trees[kind], mod)
                   for kind, mod in t.models().items()})
    return j, t


def _reference_draws(j, b: int, hw: int) -> torch.Tensor:
    """The latents the reference's next generate_batch of b objects draws
    (per object, its key folded with the running counter), NCHW."""
    keys = [jax.random.fold_in(j.rng, j._noise_ctr + i) for i in range(b)]
    lat = np.stack([np.asarray(jax.random.normal(
        k, (hw, hw, j.dit_cfg.in_channels))) for k in keys])
    return torch.from_numpy(lat.transpose(0, 3, 1, 2).copy())


def _depths(n: int, seed: int = 0):
    r = np.random.default_rng(seed)
    return [r.random((3, 32, 32)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_generate_batch_matches_the_reference(backends, mode):
    """Two objects at 64² from 32² depth images (Pillow's bilinear resize
    on both sides): the VL prompts and negatives, the VAE condition
    latents, 8 rectified-flow steps with true CFG 4.0 and the decode."""
    j, t = backends
    flags = ["01184", "05117"]
    lat = _reference_draws(j, 2, SIZE // j.factor)
    jax.clear_caches()
    with precision(mode, *t.models().values()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "draws", lambda b, hw: lat)
        ref = j.generate_batch(_depths(2), flags, size=SIZE)
        got = t.generate_batch(_depths(2), flags, size=SIZE)
    if mode == "f32":
        jax.clear_caches()
    assert got.shape == ref.shape == (2, SIZE, SIZE, 3)
    assert float(ref.std()) > 0.01
    assert np.abs(got - ref).max() <= IMAGE_TOL[mode]


def test_object_chunks_give_the_same_images():
    """generate_obj_batch 1 (one object a call) and 0 (all in one call)
    generate the same images: each object's draw comes from its own
    generator, keyed by the running object counter."""
    from types import SimpleNamespace
    from genpc_tpu_torch.parallel import batched_runner as br
    depths = _depths(3, seed=1)
    out = []
    for ob in (0, 1):
        cfg = tconfig.load_config(device="cpu", model_size="tiny",
                                  generate_res=SIZE, generate_obj_batch=ob)
        b = DiTDepthEdit(cfg, seed=4)
        arts = [SimpleNamespace(depth=d, flag=f, image=None)
                for d, f in zip(depths, ("01184", "05117", "06127"))]
        calls = []
        gen = b.generate_batch

        def counted(depths, *a, **k):
            calls.append(len(depths))
            return gen(depths, *a, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(b, "generate_batch", counted)
            br._generate_images(cfg, SimpleNamespace(depth2image=b), arts)
        assert calls == ([3] if ob == 0 else [1, 1, 1])
        out.append(np.stack([a.image for a in arts]))
    assert out[0].shape == (3, SIZE, SIZE, 3)
    np.testing.assert_array_equal(out[0], out[1])


#: test_torch_pipeline.py's tiny run_batched config with the Qwen backend
TINY = dict(
    save=False, control_model="qwen", model_size="tiny",
    rembg_model="synthetic", generative_model="synthetic",
    trust_aligned_completion=True, view_num=16, downsample_num=256,
    res=64, cam_res=64, generate_res=SIZE, input_points=4096,
    inpaint_iters=10, glb_sample_points=512, pose_complete_points=64,
    icp_points=64, pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)


def _fixed_planes(pts_list, *a, **k):
    """One vertical mirror plane through each cloud's centroid."""
    n = np.array([1.0, 0.0, 0.0])
    return [(n, float(np.asarray(p)[:, 0].mean())) for p in pts_list]


def _run(pkg, cfg, root, backend, flags, mp):
    """run_batched of one package with ``backend`` injected as its
    depth->image generator (kept alive past the stage's release), the
    symmetry search replaced by fixed planes; -> (images, results)."""
    import importlib
    br = importlib.import_module(f"{pkg}.parallel.batched_runner")
    dpm = importlib.import_module(f"{pkg}.pipeline.depth_prompting")
    syn = importlib.import_module(f"{pkg}.models.synthetic")
    images = []
    gen = br._generate_images

    def recording(cfg, dp, arts):
        gen(cfg, dp, arts)
        images.extend(np.asarray(a.image) for a in arts)

    mp.setattr(br, "_generate_images", recording)
    mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
               staticmethod(_fixed_planes))
    mp.setattr(backend, "release", lambda: None)
    results = br.run_batched(cfg, flags, root,
                             dp=dpm.DepthPrompting(cfg, depth2image=backend))
    return np.stack(images), results


def test_run_batched_with_the_qwen_backend_matches_the_reference(
        backends, tmp_path):
    """run_batched (aligned path) over two objects with the Qwen-Image-Edit
    backend in both packages: the generated images within IMAGE_TOL
    (bf16), and per-object CD within 1e-5 and EMD within 2 %, as
    test_torch_pipeline.py holds them."""
    j, t = backends
    flags = ["01184", "05117"]
    write_dataset(str(tmp_path), flags, seed=0, n_gt=8192)
    lat = _reference_draws(j, 2, SIZE // j.factor)
    with pytest.MonkeyPatch.context() as mp:
        ref_imgs, ref = _run("genpc_tpu", jconfig.load_config(**TINY),
                             str(tmp_path), j, flags, mp)
        mp.setattr(t, "draws", lambda b, hw: lat)
        got_imgs, got = _run("genpc_tpu_torch",
                             tconfig.load_config(device="cpu", **TINY),
                             str(tmp_path), t, flags, mp)
    assert got_imgs.shape == ref_imgs.shape == (2, SIZE, SIZE, 3)
    assert np.abs(got_imgs - ref_imgs).max() <= IMAGE_TOL["bf16"]
    assert set(got) == set(ref) == set(flags)
    for f in flags:
        assert np.isfinite(got[f]["cd"]) and np.isfinite(got[f]["emd"])
        assert abs(got[f]["cd"] - ref[f]["cd"]) <= 1e-5
        assert abs(got[f]["emd"] - ref[f]["emd"]) <= 0.02 * ref[f]["emd"]


def test_unported_quantization_raises(tmp_path):
    """quant_bits and tower_quant_bits resolve as in the reference (None:
    int4 at full size, bf16 below; an explicit value wins): 0, 8 and 4
    build at every size (the full-size default quantises the MMDiT's block
    matmuls and the Qwen2.5-VL towers to int4); any other width raises,
    from the registry and from main.py's --quant-bits and
    --tower-quant-bits, which a backend without them still refuses."""
    from genpc_tpu_torch import main as tmain
    from genpc_tpu_torch.models.quant import QuantLinear

    def cfg(**kw):
        return tconfig.load_config(device="cpu", **kw)

    for kw in (dict(quant_bits=3), dict(quant_bits=16),
               dict(tower_quant_bits=2), dict(model_size="full",
                                              quant_bits=1)):
        for name in ("qwen", "flux"):
            with pytest.raises(ValueError, match="bits"):
                get_depth2image(name, cfg(**kw))
    for kw, bits in ((dict(), 0), (dict(quant_bits=8, tower_quant_bits=4),
                                   8),
                     (dict(model_size="full"), 4),
                     (dict(model_size="full", quant_bits=0,
                           tower_quant_bits=0), 0)):
        b = get_depth2image("qwen", cfg(**kw))
        assert isinstance(b, DiTDepthEdit) and b.device.type == "cpu"
        assert b.dit_cfg.quant_bits == bits
        q = b.model.transformer_blocks[0].attn.to_q
        assert isinstance(q, QuantLinear) == bool(bits)
    assert b.dit_cfg.double_blocks == 60 and b.vl.cfg.layers == 28
    b = get_depth2image("qwen", cfg(model_size="full"))
    assert b.vl.cfg.quant_bits == 4 and isinstance(
        b.vl.text.layers[0].mlp.down_proj, QuantLinear)
    os.makedirs(tmp_path / "data")
    argv = ["--data-dir", str(tmp_path / "data"), "--device", "cpu",
            "--output", str(tmp_path / "ws")]
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmain, "run_pipeline",
                   lambda cfg, *a, **k: seen.append(cfg))
        for flag in ("--quant-bits", "--tower-quant-bits"):
            for model in ("qwen", "flux"):
                tmain.main(argv + ["--control-model", model, flag, "4"])
                assert seen[-1][flag[2:].replace("-", "_")] == 4
            with pytest.raises(SystemExit):  # no such width
                tmain.main(argv + ["--control-model", "qwen", flag, "3"])
            with pytest.raises(SystemExit):  # no DiT backend to quantise
                tmain.main(argv + [flag, "0"])


def test_flux_is_not_ported():
    """FLUX was the last depth->image backend missing: now get_depth2image,
    DiTDepthEdit and FluxInpainter all build it (on the asked device, with
    the reference's 30 steps and guidance 10.0), and an unknown variant
    raises."""
    for b in (get_depth2image("flux", {"device": "cpu"}),
              DiTDepthEdit({"device": "cpu"}, variant="flux"),
              FluxInpainter({"device": "cpu"}).backend):
        assert isinstance(b, DiTDepthEdit) and b.variant == "flux"
        assert b.device.type == "cpu" and b.tower is b.t5
        assert (b.steps, b.guidance) == (30, 10.0)
        assert b.model.cfg.family == "flux"
    with pytest.raises(ValueError, match="variant"):
        DiTDepthEdit({"device": "cpu"}, variant="sd3")


def test_generate_release_and_generate_again():
    """generate draws anew on each call (the object counter advances),
    release() leaves every parameter on the meta device and records its
    span, and the next generate materialises the same seeded weights."""
    b = DiTDepthEdit({"device": "cpu", "model_size": "tiny"}, seed=2)
    depth = np.random.default_rng(1).random((32, 32)).astype(np.float32)
    with recording() as rec:
        a1 = b.generate(depth, "05117", size=SIZE)
        a2 = b.generate(depth, "05117", size=SIZE)
        assert a1.shape == (SIZE, SIZE, 3) and np.isfinite(a1).all()
        assert 0.0 <= a1.min() and a1.max() <= 1.0
        assert not np.array_equal(a1, a2)
        w = b.model.img_in.weight.clone()
        v = b.vl.text.embed_tokens.weight.clone()
        b.release()
        assert all(p.is_meta for m in b.models().values()
                   for p in m.parameters())
        b.generate(depth, "05117", size=SIZE)
        assert torch.equal(b.model.img_in.weight, w)
        assert torch.equal(b.vl.text.embed_tokens.weight, v)
    assert {s.name for s in rec.spans} == {"vl_init", "encode", "dit_init",
                                           "denoise", "decode", "release"}

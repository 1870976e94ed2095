"""Parity of the port's depth-conditioned generator
(genpc_tpu_torch/models/controlnet_depth.py, ControlNet and T2I-Adapter)
with the JAX reference's ControlNetDepth on the CPU, its place in the
backend registry, and run_batched driving it end to end.

The reference draws its latents and noises with jax.random inside its
jitted loop; the test draws the same numbers with the reference's own
calls, in the order generate and _denoise make them, and hands them to
the port's pure ``denoise``.  Both backends carry the same weights
(torch_models_ref.ref_params, through weights.from_flax).
"""

import jax
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, precision, ref_params
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models.controlnet_depth import ControlNetDepth as JCND
from genpc_tpu_torch.categories import get_category
from genpc_tpu_torch.io.synthetic_data import write_dataset
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.backends import get_depth2image
from genpc_tpu_torch.models.controlnet_depth import ControlNetDepth
from genpc_tpu_torch.tracing import recording

SIZE, STEPS = 64, 2
#: max |port - reference| over the [0, 1] images, by precision mode
#: (torch_models_ref.precision): in bf16 the models' rounding differences
#: (torch_models_ref.TOL) pass through two guided steps, where guidance
#: 5.0 multiplies the gap between the two branches, and the VAE decode
#: (observed 0.047 for the ControlNet, 0.042 for the adapter); in fp32
#: only summation order is left
IMAGE_TOL = {"bf16": 0.08, "f32": 1e-4}


def _jax_draws(rng, steps, shape):
    """The reference's draws for one generate call, NCHW: generate splits
    the backend's key once, _denoise splits that key into the latents'
    key and the step keys."""
    _, k = jax.random.split(rng)
    rng2, k2 = jax.random.split(k)
    lat = jax.random.normal(k2, shape)
    keys = jax.random.split(rng2, steps)
    noises = np.stack([np.asarray(jax.random.normal(keys[i], shape))
                       for i in range(steps)])
    return (np.asarray(lat).transpose(0, 3, 1, 2).copy(),
            noises.transpose(0, 1, 4, 2, 3).copy())


@pytest.fixture(scope="module", params=[False, True],
                ids=["controlnet", "adapter"])
def backends(request):
    """The reference's ControlNetDepth and the port's, tiny, with the same
    weights."""
    adapter = request.param
    j = JCND(jconfig.load_config(model_size="tiny"), adapter=adapter)
    j._params = {k: ref_params(
        lambda k=k: j._init_params(SIZE // j.factor)[k], s)
        for s, k in enumerate(("unet", "controlnet", "vae"))}
    j._latent_hw = SIZE // j.factor
    pe = j.prompt_encoder
    pe.params_l = ref_params(lambda: pe.params_l, 3)
    pe.params_g = ref_params(lambda: pe.params_g, 4)
    t = ControlNetDepth(tconfig.load_config(device="cpu", model_size="tiny"),
                        adapter=adapter)
    trees = {"unet": j._params["unet"], "vae": j._params["vae"],
             "adapter" if adapter else "controlnet": j._params["controlnet"],
             "clip_l": pe.params_l, "clip_g": pe.params_g}
    t.init_params({kind: tw.from_flax(kind, trees[kind], mod)
                   for kind, mod in t.models().items()})
    return j, t


@pytest.mark.parametrize("mode", MODES)
def test_generate_matches_the_reference(backends, mode):
    """The reference's generate against the port's pure denoise on the
    reference's draws (64², 2 steps, from a 32² depth image: the Lanczos
    resize on both sides)."""
    j, t = backends
    depth = np.random.default_rng(0).random((3, 32, 32)).astype(np.float32)
    lat, noises = _jax_draws(j.rng, STEPS, (1, SIZE // 8, SIZE // 8, 4))
    if mode == "f32":
        jax.clear_caches()    # the reference's jitted loop, traced anew
    with precision(mode, *t.models().values()):
        ref = j.generate(depth, "01184", size=SIZE,
                         num_inference_steps=STEPS)
        img = t.denoise(t.prepare_depth(depth, SIZE),
                        *t.encode_prompts(get_category("01184"), SIZE),
                        torch.from_numpy(lat), torch.from_numpy(noises))
    if mode == "f32":
        jax.clear_caches()
    got = img[0].permute(1, 2, 0).numpy()
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert float(ref.std()) > 0.01
    assert np.abs(got - ref).max() <= IMAGE_TOL[mode]


def test_backend_registry_builds_the_port_on_the_asked_device():
    for name, adapter in (("controlnet", False), ("adapter", True)):
        b = get_depth2image(name, tconfig.load_config(device="cpu",
                                                      model_size="tiny"))
        assert isinstance(b, ControlNetDepth) and b.adapter == adapter
        assert b.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_depth2image("controlnet", tconfig.load_config(
                model_size="tiny"))
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    for name in ("qwen", "flux"):
        q = get_depth2image(name, tconfig.load_config(device="cpu"))
        assert isinstance(q, DiTDepthEdit) and q.device.type == "cpu"
        assert q.variant == name


def test_generate_release_and_generate_again():
    """generate draws from the backend's generator (a second call draws
    anew), release() leaves every parameter on the meta device, and the
    next generate materialises the same seeded weights again."""
    b = ControlNetDepth(tconfig.load_config(device="cpu", model_size="tiny"),
                        adapter=False, seed=3)
    depth = np.random.default_rng(1).random((32, 32)).astype(np.float32)
    with recording() as rec:
        a1 = b.generate(depth, "05117", size=SIZE, num_inference_steps=STEPS)
        a2 = b.generate(depth, "05117", size=SIZE, num_inference_steps=STEPS)
        assert a1.shape == (SIZE, SIZE, 3) and np.isfinite(a1).all()
        assert 0.0 <= a1.min() and a1.max() <= 1.0
        assert not np.array_equal(a1, a2)
        w = b.unet.conv_in.weight.clone()
        b.release()
        assert all(p.is_meta for m in b.models().values()
                   for p in m.parameters())
        b.generate(depth, "05117", size=SIZE, num_inference_steps=STEPS)
        assert torch.equal(b.unet.conv_in.weight, w)
    assert {s.name for s in rec.spans} == {"init", "prompt", "denoise",
                                           "decode"}


#: test_torch_pipeline.py's tiny run_batched config, with the ControlNet
#: backend and the registration path
TINY = dict(
    save=False, control_model="controlnet", model_size="tiny",
    rembg_model="synthetic", generative_model="synthetic",
    trust_aligned_completion=False, view_num=16, downsample_num=256,
    res=64, cam_res=64, generate_res=64, input_points=4096,
    inpaint_iters=10, glb_sample_points=512, pose_complete_points=64,
    icp_points=64, pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)


def _fixed_planes(pts_list, *a, **k):
    """One vertical mirror plane through each cloud's centroid."""
    n = np.array([1.0, 0.0, 0.0])
    return [(n, float(np.asarray(p)[:, 0].mean())) for p in pts_list]


def test_run_batched_with_the_controlnet_backend(tmp_path):
    """run_batched on the registration path with the ControlNet backend:
    the generated images colour the partial clouds that stage 2 completes
    and the pose search matches.  The synthetic completion's symmetry
    search is replaced by a fixed plane: test_torch_pipeline.py holds it
    to the reference, and it takes about a minute an object on one CPU
    thread."""
    from genpc_tpu_torch.models.synthetic import SyntheticImage23D
    from genpc_tpu_torch.parallel import batched_runner as br
    flags = ["01184", "05117"]
    write_dataset(str(tmp_path), flags, seed=0, n_gt=8192)
    cfg = tconfig.load_config(device="cpu", **TINY)
    seen = []
    gen = br._generate_images

    def recording(cfg, dp, arts):
        gen(cfg, dp, arts)
        seen.append((type(dp.depth2image), [a.image for a in arts]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(br, "_generate_images", recording)
        mp.setattr(SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(_fixed_planes))
        results = br.run_batched(cfg, flags, str(tmp_path))
    (backend, images), = seen
    assert backend is ControlNetDepth
    assert all(im.shape == (64, 64, 3) and np.isfinite(im).all()
               for im in images)
    assert set(results) == set(flags)
    assert all(np.isfinite(results[f][k]) for f in flags
               for k in ("cd", "emd"))

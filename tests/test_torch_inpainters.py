"""Parity of the port's cv2 and DDNM depth inpainters (genpc_tpu_torch/
render/inpaint.py ``inpaint_image(..., "cv2")``, models/ddnm.py) and of
stage 1's dispatch to them (DepthPrompting per object, batched_stage1)
with the JAX reference on the CPU.

cv2 is host code in both packages: the port's result must be bit-equal
to the reference's on the same arrays.  DDNM's UNet gets the reference's
tree through ``weights.from_flax``; its sampler runs on the reference's
jax.random draw.  Stage 1's raw depths differ from the reference's at
pixels where several points collide (test_torch_stage1.py), so a painted
depth is held against the reference's inpainter applied to the port's own
raw depth and hole mask; the masks are held equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, TOL, close, nchw, precision, \
    ref_params, run_jit
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models.ddnm import DDNMInpainter as JDDNM
from genpc_tpu.render.inpaint import inpaint_image as jinpaint
from genpc_tpu_torch.models import schedulers as ts
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.ddnm import DDNMInpainter
from genpc_tpu_torch.render.inpaint import inpaint_image
from genpc_tpu_torch.tracing import recording

K = jax.random.PRNGKey(0)
SIZE = 32
#: max |port - reference| over the [0, 1] painted image after the DDNM
#: sampler on the reference's draw, by precision mode (the issue's sampler
#: bound in bf16)
PAINT_TOL = {"bf16": 0.08, "f32": 1e-4}
#: the reference's parameter count of the full (base) DDNM UNet
#: (jax.eval_shape)
DDNM_PARAMS = 824_754_243
#: stage 1 at a tiny size (test_torch_flux_inpaint.py's)
STAGE1 = dict(save=False, view_num=32, cam_res=64, res=64,
              downsample_num=512, control_model="synthetic",
              model_size="tiny")


#: DDIM steps of the stage-1 inpaints here (the inpainter's default is 50)
STEPS = 3


def kept(img):
    """A known pixel as both packages return it: mapped to [-1, 1] and
    back in fp32."""
    return np.clip((img * 2 - 1) / 2 + 0.5, 0, 1)


def _hole_case(seed=5, size=SIZE, chw_mask=False):
    r = np.random.default_rng(seed)
    img = r.random((3, size, size)).astype(np.float32)
    mask = np.zeros((size, size), np.float32)
    mask[size // 4:size // 2, size // 5:size // 2] = 1.0
    mask[r.random((size, size)) > 0.9] = 1.0
    img[:, mask > 0.5] = 0.0
    return img, (np.repeat(mask[None], 3, 0) if chw_mask else mask)


# ------------------------------------------------------------------- cv2

@pytest.mark.parametrize("chw_mask", [False, True])
def test_cv2_inpaint_is_the_reference_bitwise(chw_mask):
    """inpaint_image(..., "cv2"): numpy and torch inputs, a [H, W] or a
    [C, H, W] mask: bit-equal to the reference's."""
    img, mask = _hole_case(chw_mask=chw_mask)
    ref = np.asarray(jinpaint(jnp.asarray(img), jnp.asarray(mask),
                              backend="cv2"))
    for a, m in ((img, mask), (torch.from_numpy(img),
                               torch.from_numpy(mask))):
        got = inpaint_image(a, m, backend="cv2")
        assert got.dtype == torch.float32 and got.shape == (3, SIZE, SIZE)
        np.testing.assert_array_equal(got.numpy(), ref)
    assert float(np.abs(ref - img)[:, mask.reshape(-1, SIZE, SIZE)[0]
                                    > 0.5].max()) > 0.05


def test_jax_backend_is_the_diffusion_fill():
    from genpc_tpu_torch.render.inpaint import diffusion_inpaint
    img, mask = _hole_case()
    got = inpaint_image(img, mask, backend="jax", iters=20)
    want = diffusion_inpaint(torch.from_numpy(img), torch.from_numpy(mask),
                             iters=20)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="backend"):
        inpaint_image(img, mask, backend="nonsense")


def _object():
    from genpc_tpu_torch.io.synthetic_data import make_object
    return make_object(0, n_gt=8192)[:2]


@pytest.mark.parametrize("name", ["cv2", "DDNM"])
def test_depth_prompting_paints_per_object(name, ddnm_tree):
    """DepthPrompting(inpainter=cv2 | DDNM).get_depth: the reference's hole
    masks (DDNM keeps mask 2 as the object's mask, cv2 mask 1), and the
    port's raw depth painted as the reference's inpainter paints it: cv2
    bit-equal, DDNM (on the reference's draw, bf16) within PAINT_TOL with
    the known pixels exact."""
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.depth_prompting import DepthPrompting as JDP
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts as TArt
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting as TDP
    kw = dict(STAGE1, inpainter=name)
    xyz, rgb = _object()
    jdp = JDP(jconfig.load_config(**kw))
    tdp = TDP(tconfig.load_config(device="cpu", **kw))
    with pytest.MonkeyPatch.context() as mp:
        if name == "DDNM":
            assert isinstance(tdp.inpainter, DDNMInpainter)
            assert tdp.owns_inpainter and tdp.inpainter.steps == 50
            jdp.inpainter.steps = tdp.inpainter.steps = STEPS
            install_ref(jdp.inpainter, ddnm_tree, 64)
            tdp.inpainter.init_params(tw.from_flax(
                "ddnm", ddnm_tree, tdp.inpainter.unet))
            rng0 = jdp.inpainter.rng
            noise = ref_noise(rng0, 64)
            mp.setattr(tdp.inpainter, "paint_draws", lambda shape: noise)
        else:
            assert tdp.inpainter is None
        at = tdp.get_depth(TArt("01184", xyz, rgb))
        aj = jdp.get_depth(JArt("01184", xyz, rgb))
    np.testing.assert_array_equal(at.mask, aj.mask)
    assert at.depth.shape == (3, 64, 64) and at.depth.dtype == np.float32
    if name == "cv2":
        ref = np.asarray(jinpaint(jnp.asarray(at.raw_depth),
                                  jnp.asarray(at.mask), backend="cv2"))
        np.testing.assert_array_equal(at.depth, ref)
        return
    known = at.mask.max(axis=0) < 0.5
    assert known.any() and (~known).any()
    np.testing.assert_array_equal(at.depth[:, known],
                                  kept(at.raw_depth)[:, known])
    jdp.inpainter.rng = rng0
    ref = jdp.inpainter.inpaint(at.raw_depth, at.mask)
    assert np.abs(at.depth - ref).max() <= PAINT_TOL["bf16"]


@pytest.mark.parametrize("name", ["cv2", "DDNM"])
def test_batched_stage1_dispatch_matches(name, ddnm_tree):
    """batched_stage1 over 2 objects with inpainter cv2 or DDNM: the hole
    masks the reference's batched_stage1 keeps (mask 2 for DDNM), each
    depth painted from the object's own raw depth as the reference's
    inpainter paints it (cv2 bit-equal; DDNM on the reference's draws,
    within PAINT_TOL, the known pixels exact)."""
    from genpc_tpu.parallel import batched_runner as jbr
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.depth_prompting import DepthPrompting as JDP
    from genpc_tpu_torch.parallel import batched_runner as tbr
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts as TArt
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting as TDP
    kw = dict(STAGE1, inpainter=name, input_points=2048)
    r = np.random.default_rng(8)
    objs = [((r.normal(size=(2048, 3)) * 0.2).astype(np.float32),
             np.full((2048, 3), 0.5, np.float32)) for _ in range(2)]
    jdp = JDP(jconfig.load_config(**kw))
    tdp = TDP(tconfig.load_config(device="cpu", **kw))
    ja = [JArt(f"o{i}", x, c) for i, (x, c) in enumerate(objs)]
    ta = [TArt(f"o{i}", x, c) for i, (x, c) in enumerate(objs)]
    with pytest.MonkeyPatch.context() as mp:
        if name == "DDNM":
            jdp.inpainter.steps = tdp.inpainter.steps = STEPS
            install_ref(jdp.inpainter, ddnm_tree, 64)
            tdp.inpainter.init_params(tw.from_flax(
                "ddnm", ddnm_tree, tdp.inpainter.unet))
            rng0 = jdp.inpainter.rng
            noises = ref_noises(rng0, 64, 2)
            mp.setattr(tdp.inpainter, "paint_draws",
                       lambda shape: noises.pop(0))
        jbr.batched_stage1(jconfig.load_config(**kw), ja, jdp.viewpoints,
                           dp=jdp)
        tbr.batched_stage1(tconfig.load_config(device="cpu", **kw), ta,
                           tdp.viewpoints, dp=tdp)
    for a, b in zip(ta, ja):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.depth.shape == (3, 64, 64)
        if name == "cv2":
            ref = np.asarray(jinpaint(jnp.asarray(a.raw_depth),
                                      jnp.asarray(a.mask), backend="cv2"))
            np.testing.assert_array_equal(a.depth, ref)
        else:
            known = a.mask.max(axis=0) < 0.5
            np.testing.assert_array_equal(a.depth[:, known],
                                          kept(a.raw_depth)[:, known])
    if name == "DDNM":
        # the reference inpainter, handed the port's raw depths in order,
        # draws what it drew for its own objects
        jdp.inpainter.rng = rng0
        for a in ta:
            ref = jdp.inpainter.inpaint(a.raw_depth, a.mask)
            assert np.abs(a.depth - ref).max() <= PAINT_TOL["bf16"]


# ------------------------------------------------------------------ DDNM

def ddnm_init(inp, hw):
    return lambda: inp.unet.init(K, jnp.zeros((1, hw, hw, 3)),
                                 jnp.zeros((1,)),
                                 jnp.zeros((1, 1, inp.unet_cfg.context_dim)))


@pytest.fixture(scope="module")
def ddnm_tree():
    """The tiny DDNM UNet's reference tree (ref_params)."""
    j = JDDNM(jconfig.load_config(model_size="tiny"))
    return ref_params(ddnm_init(j, SIZE), 60)


def install_ref(j, tree, hw):
    """The reference inpainter takes the tree (its lazy init skipped)."""
    j._params, j._hw = tree, hw


def ref_noise(rng, hw):
    """The reference inpainter's draw of its next call from its key
    ``rng``, NCHW."""
    _, k = jax.random.split(rng)
    x = np.asarray(jax.random.normal(k, (1, hw, hw, 3)))
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def ref_noises(rng, hw, n):
    """The reference inpainter's draws of its next n calls."""
    out = []
    for _ in range(n):
        out.append(ref_noise(rng, hw))
        rng, _ = jax.random.split(rng)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_ddnm_unet_step_matches(ddnm_tree, mode):
    """The pixel-space UNet (3 channels in and out, a zero context) at one
    DDIM timestep: the noise estimate within TOL."""
    j = JDDNM(jconfig.load_config(model_size="tiny"))
    t = DDNMInpainter(tconfig.load_config(device="cpu", model_size="tiny"))
    t.init_params(tw.from_flax("ddnm", ddnm_tree, t.unet))
    r = np.random.default_rng(61)
    x = r.normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    tt = np.array([780.0], np.float32)
    ctx = np.zeros((1, 1, t.unet_cfg.context_dim), np.float32)
    with precision(mode, t.unet), torch.no_grad():
        ref = run_jit(j.unet.apply, ddnm_tree, x, tt, ctx)
        got = t.unet(nchw(x), torch.from_numpy(tt), torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_ddnm_sampler_matches_on_reference_draws(ddnm_tree, mode):
    """DDNMInpainter.inpaint (4 DDIM steps with the data-consistency
    projection) on the reference's draw: within PAINT_TOL, the known
    pixels exactly the input's, the hole changed."""
    j = JDDNM(jconfig.load_config(model_size="tiny"), steps=4)
    install_ref(j, ddnm_tree, SIZE)
    t = DDNMInpainter(tconfig.load_config(device="cpu", model_size="tiny"),
                      steps=4)
    t.init_params(tw.from_flax("ddnm", ddnm_tree, t.unet))
    img, mask = _hole_case()
    noise = ref_noise(j.rng, SIZE)
    jax.clear_caches()
    with precision(mode, t.unet), pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "paint_draws", lambda shape: noise)
        ref = j.inpaint(img, mask)
        with recording() as rec:
            got = t.inpaint(img, mask)
    jax.clear_caches()
    assert got.shape == ref.shape == (3, SIZE, SIZE)
    known = mask < 0.5
    np.testing.assert_array_equal(got[:, known], kept(img)[:, known])
    np.testing.assert_array_equal(ref[:, known], kept(img)[:, known])
    assert float(np.abs(got - img)[:, ~known].max()) > 0.05
    gap = float(np.abs(got - ref).max())
    print(f"ddnm sampler, {mode}: max |port - reference| {gap:.3e}")
    assert gap <= PAINT_TOL[mode]
    assert {s.name for s in rec.spans} == {"inpaint"}


def test_ddnm_draws_release_and_paint_again():
    """The DDNM inpainter of the registry's stage 1 builds on cfg.device
    (the card unless asked), draws anew each call from its seeded
    generator, and release() frees its weights: the next call
    materialises the same seeded weights (a fresh inpainter's first
    paint again)."""
    from genpc_tpu_torch.pipeline.depth_prompting import make_inpainter
    cfg = tconfig.load_config(device="cpu", model_size="tiny",
                              inpainter="DDNM")
    inp = make_inpainter(cfg)
    assert isinstance(inp, DDNMInpainter) and inp.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_inpainter(tconfig.load_config(model_size="tiny",
                                               inpainter="DDNM"))
    inp.steps = 3
    img, mask = _hole_case(seed=9)
    with recording() as rec:
        a1 = inp.inpaint(img, mask)
        a2 = inp.inpaint(img, mask)
        assert not np.array_equal(a1, a2)
        inp.release()
        assert all(p.is_meta for p in inp.unet.parameters())
        fresh = make_inpainter(cfg)
        fresh.steps = 3
        np.testing.assert_array_equal(fresh.inpaint(img, mask), a1)
    assert {s.name for s in rec.spans} == {"init", "inpaint", "release"}


def test_ddim_steps_by_tensor_index_match_int_index():
    """DDIM.step at a [1] index tensor (as a CUDA graph reads it) equals
    the step at an int index, at every step of 50."""
    d = ts.DDIM(50)
    r = np.random.default_rng(62)
    x = torch.from_numpy(r.normal(size=(1, 3, 8, 8)).astype(np.float32))
    e = torch.from_numpy(r.normal(size=(1, 3, 8, 8)).astype(np.float32))
    for i in range(50):
        assert torch.equal(d.step(e, i, x), d.step(e, torch.tensor([i]), x))


def test_ddnm_full_parameter_count_matches_the_reference():
    """The full DDNM UNet (the base preset's widths, 3 channels) has the
    reference's parameter count (jax.eval_shape), on the meta device."""
    import flax.linen as fnn
    j = JDDNM(jconfig.load_config(model_size="full"))
    shapes = fnn.meta.unbox(jax.eval_shape(ddnm_init(j, 64)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == DDNM_PARAMS
    t = DDNMInpainter(tconfig.load_config(device="cpu", model_size="full"))
    assert sum(v.numel() for v in t.unet.state_dict().values()) \
        == DDNM_PARAMS

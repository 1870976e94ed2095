"""Parity of the port's InstantMesh image-to-3D backend (genpc_tpu_torch/
models/lrm.py, the CLIP vision tower, RefBank in models/layers.py) and of
the mesh path through the pipeline with the JAX reference on the CPU.

Each port module gets the reference module's parameters through
``weights.from_flax`` and the same seeded numpy inputs, in both precision
modes of torch_models_ref.py ("bf16": the packages' own compute types;
"f32": every bf16 layer in fp32 on both sides), held to ``TOL``.  The
whole backend runs on the reference's jax.random draws, handed to the
port's pure ``denoise_latents`` (or to its ``draws``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, TOL, close, nchw, port, precision, \
    ref_params, run_jit
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu.native
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models import layers as jl
from genpc_tpu.models import lrm as jlrm
from genpc_tpu.models import text_encoder as jte
from genpc_tpu.models.unet import UNet2DCondition as JUNet
from genpc_tpu.models.unet import UNetConfig as JUNetConfig
from genpc_tpu_torch.models import layers as tl
from genpc_tpu_torch.models import lrm as tlrm
from genpc_tpu_torch.models import text_encoder as tte
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.unet import UNet2DCondition, UNetConfig
from genpc_tpu_torch.tracing import recording
from torch_replay import native_off

K = jax.random.PRNGKey(0)
LRM = jlrm.LRMConfig.preset("tiny")
FLAGS = ["01184", "05117"]
#: max |port - reference| over the [0, 1] views after the tiny preset's
#: 4 multiview steps, by precision mode, and the mean: in bf16 the
#: models' rounding differences (TOL) pass through the write and read
#: passes of each step, where guidance 4.0 multiplies the gap between the
#: two branches, and through the VAE decode (observed: max 0.092, mean
#: 0.0094); in fp32 only summation order is left (observed: max 1.4e-5)
VIEW_TOL = {"bf16": 0.12, "f32": 1e-4}
VIEW_MEAN_TOL = {"bf16": 0.015, "f32": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    """The reference jits its methods with a static ``self``: clear the
    traced programs around this module, whose f32 mode traces them
    anew."""
    jax.clear_caches()
    yield
    jax.clear_caches()


# ------------------------------------------------------------- modules

@pytest.mark.parametrize("mode", MODES)
def test_clip_vision_matches(mode):
    cfg = jte.CLIPVisionConfig.preset("tiny")
    j = jte.CLIPVisionModel(cfg)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    p = ref_params(lambda: j.init(K, jnp.asarray(x)), 11)
    t = port(tte.CLIPVisionModel, tte.CLIPVisionConfig.preset("tiny"),
             kind="clip_vision", params=p)
    with precision(mode, t), torch.no_grad():
        tokens, emb = run_jit(j.apply, p, x)
        gt, ge = t(nchw(x))
    assert ge.dtype == torch.float32 and ge.shape == (2, cfg.proj_dim)
    close(gt, tokens, TOL[mode])
    close(ge, emb, TOL[mode])


@pytest.fixture(scope="module")
def lrm_pair():
    j = jlrm.TriplaneLRM(LRM)
    vs = LRM.view_size
    p = ref_params(lambda: j.init(K, jnp.zeros((1, 6, vs, vs, 3)),
                                  jnp.zeros((1, 6, 16)),
                                  jnp.zeros((8, 3))), 12)
    t = port(tlrm.TriplaneLRM, tlrm.LRMConfig.preset("tiny"), kind="lrm",
             params=p)
    return j, p, t


def _sub(p, name):
    return {"params": p["params"][name]}


def _lrm_case(part, j, p, t):
    """(reference fn, its numpy args, port fn, its args) of one part."""
    r = np.random.default_rng(13)
    vs, n_tok = LRM.view_size, (LRM.view_size // LRM.patch) ** 2 + 1
    views = r.random((2, 6, vs, vs, 3)).astype(np.float32)
    cams = np.tile(jlrm.zero123plus_cameras()[None], (2, 1, 1))
    imgs = views[0]
    adaln = r.normal(size=(6, LRM.vit_dim)).astype(np.float32)
    tokens = r.normal(size=(2, 6 * n_tok, LRM.vit_dim)).astype(np.float32)
    feats = r.normal(size=(50, 3 * LRM.triplane_dim)).astype(np.float32)
    planes = r.normal(size=(3, 8, 8, LRM.triplane_dim)).astype(np.float32)
    pts = r.uniform(-1.1, 1.1, size=(64, 3)).astype(np.float32)
    tv = torch.from_numpy(views.transpose(0, 1, 4, 2, 3).copy())
    T = torch.from_numpy
    if part == "dino":
        return (lambda a, b: jlrm.DinoViT(LRM).apply(
            _sub(p, "encoder_model"), a, b), (imgs, adaln),
            lambda: t.encoder.model(nchw(imgs), T(adaln)))
    if part == "camera":
        return (lambda a: jlrm.CameraEmbedder(LRM).apply(
            _sub(p, "camera_embedder"), a), (cams[0],),
            lambda: t.encoder.camera_embedder(T(cams[0])))
    if part == "transformer":
        return (lambda a: jlrm.TriplaneTransformer(LRM).apply(
            _sub(p, "transformer"), a), (tokens,),
            lambda: t.transformer(T(tokens)))
    if part == "synthesizer":
        return (lambda a: jlrm.SynthesizerDecoder(LRM).apply(
            _sub(p, "synthesizer"), a), (feats,),
            lambda: t.synthesizer(T(feats)))
    if part == "forward_planes":
        return (lambda a, b: j.apply(p, a, b,
                                     method=jlrm.TriplaneLRM.forward_planes),
                (views, cams), lambda: t.forward_planes(tv, T(cams)))
    assert part == "query"
    return (lambda a, b: j.apply(p, a, b, method=jlrm.TriplaneLRM.query),
            (planes, pts), lambda: t.query(T(planes), T(pts)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("part", ["dino", "camera", "transformer",
                                  "synthesizer", "forward_planes", "query"])
def test_lrm_modules_match(lrm_pair, part, mode):
    """DinoViT, CameraEmbedder, TriplaneTransformer (its flax
    ConvTranspose: torch's with the kernel flipped), SynthesizerDecoder,
    TriplaneLRM.forward_planes and .query, on one reference tree."""
    j, p, t = lrm_pair
    ref_fn, args, got_fn = _lrm_case(part, j, p, t)
    with precision(mode, t), torch.no_grad():
        ref = jax.jit(ref_fn)(*args)
        got = got_fn()
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        close(a, np.asarray(b), TOL[mode])


def test_sample_triplane_matches():
    """Both lookups in fp32, points inside and outside [-1, 1] (the cell
    index clipped, the fraction extrapolated)."""
    r = np.random.default_rng(14)
    planes = r.normal(size=(3, 9, 9, 5)).astype(np.float32)
    pts = r.uniform(-1.2, 1.2, size=(500, 3)).astype(np.float32)
    pts[:3] = [[-1, -1, -1], [1, 1, 1], [0, 0, 0]]
    for jf, tf in ((jlrm.sample_triplane, tlrm.sample_triplane),
                   (jlrm.sample_triplane_concat,
                    tlrm.sample_triplane_concat)):
        ref = np.asarray(jax.jit(jf)(planes, pts))
        got = tf(torch.from_numpy(planes), torch.from_numpy(pts)).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


#: an SD2-shaped UNet at toy widths: four levels, the deepest without
#: attention, an attention mid block, no micro-conditioning
SD2_TINY = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
                transformer_depths=(1, 1, 1, 0), mid_depth=1,
                context_dim=64, attention_head_dim=16)


@pytest.mark.parametrize("mode", MODES)
def test_unet_refbank_write_and_read_match(mode):
    """A write pass over condition latents (32x32) records every
    self-attention's tokens; the read pass over the sample (48x32, the
    3x2 grid's aspect) appends them to attn1's keys and values: the read
    pass's output matches in both modes, the recorded tokens with every
    layer in fp32.  (In bf16 the recorded tokens, LayerNorm outputs deep
    in the up path, carry the rounding of every layer before them without
    the output's final projections: up to 3.9e-2 of their largest value.)"""
    r = np.random.default_rng(15)
    cond = r.normal(size=(2, 32, 32, 4)).astype(np.float32)
    lat = r.normal(size=(2, 48, 32, 4)).astype(np.float32)
    ctx = r.normal(size=(2, 77, 64)).astype(np.float32)
    t = np.array([901.0, 901.0], np.float32)
    j = JUNet(JUNetConfig(**SD2_TINY))
    p = ref_params(lambda: j.init(K, jnp.asarray(lat), jnp.asarray(t),
                                  jnp.asarray(ctx)), 16)
    tu = port(UNet2DCondition, UNetConfig(**SD2_TINY), kind="unet", params=p)

    def ref_fn(p, cond, lat, t, ctx):
        bank = jl.RefBank("w")
        j.apply(p, cond, t, ctx, ref=bank)
        out = j.apply(p, lat, t, ctx, ref=jl.RefBank("r", bank.tokens))
        return out, bank.tokens

    with precision(mode, tu), torch.no_grad():
        ref, ref_tokens = run_jit(ref_fn, p, cond, lat, t, ctx)
        bank = tl.RefBank("w")
        tu(nchw(cond), torch.from_numpy(t), torch.from_numpy(ctx), ref=bank)
        got = tu(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                 ref=tl.RefBank("r", bank.tokens))
        plain = tu(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    # 3 down levels, the mid block, 3 up levels x 2 resnets
    assert len(bank.tokens) == len(ref_tokens) == 10
    for a, b in zip(bank.tokens, ref_tokens):
        assert tuple(a.shape) == b.shape
        if mode == "f32":
            close(a, b, TOL[mode])
    close(got, ref, TOL[mode])
    assert float((got - plain).abs().max()) > 1e-3   # the bank is read
    with pytest.raises(ValueError, match="mode"):
        tl.RefBank("x")


@pytest.mark.parametrize("steps", [4, 75])
def test_zero123plus_scheduler_matches(steps):
    """EulerAncestral with trailing spacing and v-prediction at the tiny
    and full step counts, stepped by an int and by a [1] index tensor (a
    CUDA graph's step index): rtol 1e-6."""
    from genpc_tpu.models import schedulers as js
    from genpc_tpu_torch.models import schedulers as ts
    r = np.random.default_rng(17)
    x, v, n = (r.normal(size=(2, 4, 12, 8)).astype(np.float32)
               for _ in range(3))
    a = ts.EulerAncestral(steps, spacing="trailing", prediction="v")
    b = js.EulerAncestral(steps, spacing="trailing", prediction="v")
    np.testing.assert_allclose(a.timesteps, b.timesteps, rtol=1e-6)
    np.testing.assert_allclose(a.sigmas, b.sigmas, rtol=1e-6)
    assert a.init_noise_sigma == b.init_noise_sigma
    tx, tv, tn = (torch.from_numpy(q) for q in (x, v, n))
    for i in sorted({0, 1, steps // 2, steps - 1}):
        want = [np.asarray(b.scale_model_input(x, i)),
                np.asarray(b.add_noise(x, n, i)),
                np.asarray(b.step(v, i, x, n))]
        for idx in (i, torch.tensor([i])):
            got = [a.scale_model_input(tx, idx), a.add_noise(tx, tn, idx),
                   a.step(tv, idx, tx, tn)]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                           atol=1e-6)


def test_presets_match_the_reference():
    for name in ("tiny", "base", "sdxl", "sd2"):
        assert vars(UNetConfig.preset(name)) == \
            vars(JUNetConfig.preset(name)), name
    for name in ("tiny", "full"):
        assert vars(tlrm.LRMConfig.preset(name)) == \
            vars(jlrm.LRMConfig.preset(name)), name
    for name in ("tiny", "vit_h"):
        assert vars(tte.CLIPVisionConfig.preset(name)) == \
            vars(jte.CLIPVisionConfig.preset(name)), name
    assert vars(tte.CLIPTextConfig.preset("clip_sd2")) == \
        vars(jte.CLIPTextConfig.preset("clip_sd2"))


# ------------------------------------------------------------- backend

def ref_trees(j, seed=20):
    """The reference backend's parameter trees (numpy leaves from
    ref_params), keyed as its ``_init_params`` keys them."""
    vs, vp = j.lrm_cfg.view_size, j.vis_cfg.image_size
    gh, gw = j._grid_hw()
    z = jnp.zeros
    inits = {
        "lrm": lambda: j.lrm.init(K, z((1, 6, vs, vs, 3)), z((1, 6, 16)),
                                  z((8, 3))),
        "unet": lambda: j.unet.init(K, z((1, gh, gw, 4)), z((1,)),
                                    z((1, 16, j.unet_cfg.context_dim))),
        "vae": lambda: j.vae.init(K, z((1, vs, vs, 3))),
        "clip_text": lambda: j.clip_text.init(K, z((1, 77), jnp.int32)),
        "clip_vision": lambda: j.clip_vision.init(K, z((1, vp, vp, 3))),
    }
    trees = {k: ref_params(f, seed + i) for i, (k, f) in
             enumerate(inits.items())}
    trees["ramping"] = jnp.linspace(0.0, 1.0, 77)
    return trees


def port_states(t, trees):
    return {kind: tw.from_flax(kind, trees[kind], mod)
            for kind, mod in t.models().items()}


def ref_draws(rng, b, steps, j):
    """The reference's draws of one generate_meshes_batch call from the
    backend key ``rng``, in the port's layout: (the backend's next key,
    latents [b,C,gh,gw], condition noises [steps,b,2,C,h,w], step noises
    [steps,b,C,gh,gw]).  _mv_init_batch draws the latents at once and
    splits one key per object; each step splits (carry, k1, k2)."""
    rng, k = jax.random.split(rng)
    r, k0 = jax.random.split(k)
    gh, gw = j._grid_hw()
    c, h = j.unet_cfg.in_channels, j.lrm_cfg.view_size // j.factor
    lat = np.asarray(jax.random.normal(k0, (b, 1, gh, gw, c)))[:, 0]
    keys = jax.random.split(jax.random.fold_in(r, 1), b)
    cn = np.zeros((steps, b, 2, h, h, c), np.float32)
    sn = np.zeros((steps, b, gh, gw, c), np.float32)
    for o in range(b):
        key = keys[o]
        for i in range(steps):
            key, k1, k2 = jax.random.split(key, 3)
            cn[i, o] = jax.random.normal(k1, (2, h, h, c))
            sn[i, o] = jax.random.normal(k2, (1, gh, gw, c))[0]
    T = torch.from_numpy
    return (rng, T(lat.transpose(0, 3, 1, 2).copy()),
            T(cn.transpose(0, 1, 2, 5, 3, 4).copy()),
            T(sn.transpose(0, 1, 4, 2, 3).copy()))


@pytest.fixture(scope="module")
def backends():
    """The reference's InstantMeshBackend and the port's, tiny, with the
    same weights."""
    j = jlrm.InstantMeshBackend(jconfig.load_config(model_size="tiny"))
    j._params = ref_trees(j)
    t = tlrm.InstantMeshBackend(tconfig.load_config(device="cpu",
                                                    model_size="tiny"))
    t.init_params(port_states(t, j._params))
    return j, t


def _images(n=2, seed=0, size=64):
    r = np.random.default_rng(seed)
    return [r.random((size, size, 4)).astype(np.float32) for _ in range(n)]


def _reference_pieces(j, images):
    """The stages of the reference's generate_meshes_batch, each output
    kept (the backend's key is left as it was)."""
    p = j._params
    imgs01 = np.stack([j._prep_image(im) for im in images])
    _, k = jax.random.split(j.rng)
    ctx = j._encode_context_batch(p, imgs01)
    lat, cond, rngs = j._mv_init_batch(p, jnp.asarray(imgs01 * 2 - 1), k,
                                       j.mv_steps)
    lat, _ = j._mv_chunk_batch(p, lat, cond, ctx, rngs, jnp.int32(0),
                               jnp.int32(j.mv_steps), j.mv_steps)
    views = j._mv_decode_batch(p, lat)
    cams = jnp.broadcast_to(jnp.asarray(jlrm.zero123plus_cameras())[None],
                            (len(images), 6, 16))
    planes, sdf = j._density_grid_batch(p, views, cams)
    return {k: np.asarray(v) for k, v in dict(
        imgs01=imgs01, ctx=ctx, cond=cond, views=views, planes=planes,
        sdf=sdf).items()}


def _port_pieces(t, imgs01, draws):
    _, lat, cn, sn = draws
    ctx = t.encode_context(imgs01)
    x = torch.from_numpy(imgs01.transpose(0, 3, 1, 2).copy())
    cond = t.encode_condition(x * 2 - 1)
    views = t.decode(t.denoise_latents(cond, ctx, lat, cn, sn))
    planes, sdf = t.density_grid(views, t.cameras(len(imgs01)))
    return dict(ctx=ctx, cond=cond, views=views, planes=planes, sdf=sdf)


@pytest.fixture(scope="module")
def pieces(backends):
    """Both backends' stages on 2 objects, in each precision mode."""
    j, t = backends
    images = _images()
    draws = ref_draws(j.rng, 2, j.mv_steps, j)
    out = {}
    for mode in MODES:
        jax.clear_caches()      # the reference's jitted stages, traced anew
        with precision(mode, *t.models().values()):
            ref = _reference_pieces(j, images)
            got = _port_pieces(t, ref["imgs01"], draws)
        out[mode] = (ref, got)
    jax.clear_caches()
    return out


def test_ramping_is_the_reference_linspace(backends):
    j, t = backends
    assert t.ramping.dtype == torch.float32 and t.ramping.shape == (77,)
    np.testing.assert_allclose(t.ramping.numpy(),
                               np.asarray(j._params["ramping"]), atol=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_context_and_condition_latents_match(pieces, mode):
    """The (negative, positive) context [B, 2, 77, D] (SD2 text tower,
    CLIP-H image embedding ramped in) and the VAE's condition latents
    (black image, input).  The black image's latents are held to
    TOL["bf16"] in both modes: the encoder's GroupNorms over a nearly
    constant field divide rounding by a deviation near zero (observed
    1.9e-4 of the largest value in fp32, against 1.4e-7 for a random
    image)."""
    ref, got = pieces[mode]
    assert tuple(got["ctx"].shape) == ref["ctx"].shape[:2] + (77, 64)
    close(got["ctx"].flatten(0, 1), ref["ctx"].reshape(-1, 77, 64),
          TOL[mode])
    close(got["cond"][:, 1], ref["cond"][:, 1], TOL[mode])
    close(got["cond"][:, 0], ref["cond"][:, 0], TOL["bf16"])


@pytest.mark.parametrize("mode", MODES)
def test_multiview_denoise_matches_on_reference_draws(pieces, mode):
    """4 steps (write pass, guided read pass, Euler-ancestral step) on
    the reference's jax.random draws, then the decode into six 32² views:
    within VIEW_TOL of the reference's views."""
    ref, got = pieces[mode]
    views = got["views"].permute(0, 1, 3, 4, 2).numpy()
    assert views.shape == ref["views"].shape == (2, 6, 32, 32, 3)
    assert float(ref["views"].std()) > 0.01
    gap = np.abs(views - ref["views"])
    print(f"multiview views, {mode}: max |port - reference| "
          f"{gap.max():.3e}, mean {gap.mean():.3e}")
    assert gap.max() <= VIEW_TOL[mode] and gap.mean() <= VIEW_MEAN_TOL[mode]


def test_meshes_match_in_f32(pieces, backends):
    """With every layer in fp32: the triplanes and SDF grids within TOL,
    and marching tetrahedra at the median gives each object the same
    face count, with each face's corners and their colours within 1e-4.
    (Faces come in the tetrahedra's order; the welded vertices are in
    np.unique's order of their quantised keys, which a vertex moved by
    rounding across a key step reorders, so vertices are compared
    through the faces.)"""
    j, t = backends
    ref, got = pieces["f32"]
    close(got["planes"], ref["planes"], TOL["f32"])
    close(got["sdf"].flatten(1), ref["sdf"].reshape(2, -1), TOL["f32"])
    for b in range(2):
        v, f = tlrm.mesh_from_sdf(got["sdf"][b].numpy())
        jv, jf = jlrm.marching_tetrahedra(
            ref["sdf"][b], level=float(np.median(ref["sdf"][b])))
        assert len(f) == len(jf) > 100
        assert np.abs(v[f] - jv[jf]).max() <= 1e-4
        rgb = t.vertex_colors(got["planes"][b], v)
        ref_rgb = np.clip(np.asarray(j._colors_at(
            j._params, ref["planes"][b], jnp.asarray(jv))), 0, 1)
        assert np.abs(rgb[f] - ref_rgb[jf]).max() <= 1e-4


def test_generate_meshes_batch_in_chunks_matches(backends):
    """scale_adapter_batch with image23d_batch=1 over 2 objects: two
    generate_meshes_batch calls, each drawing anew (the port handed the
    reference's draws of each call), every layer in fp32: the same face
    counts, face corners and colours within 1e-4."""
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.scale_adapter import ScaleAdapter as JSA
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
    j, t = backends
    kw = dict(save=False, generative_model="instantmesh",
              rembg_model="synthetic", model_size="tiny", image23d_batch=1)
    r = np.random.default_rng(1)
    images = [r.random((48, 48, 3)).astype(np.float32) for _ in range(2)]
    uvs = [r.random((256, 2)).astype(np.float32) for _ in range(2)]
    xyz = [r.normal(size=(256, 3)).astype(np.float32) * 0.2
           for _ in range(2)]
    calls, rng = [], j.rng
    for _ in range(2):
        rng, *d = ref_draws(rng, 1, j.mv_steps, j)
        calls.append(tuple(d))
    saved_rng = j.rng
    arts = {}
    jax.clear_caches()
    with precision("f32", *t.models().values()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "draws", lambda b: calls.pop(0))
        for name, art_cls, sa in (
                ("ref", JArt, JSA(jconfig.load_config(**kw), image23d=j)),
                ("port", ObjectArtifacts, ScaleAdapter(
                    tconfig.load_config(device="cpu", **kw), image23d=t))):
            arts[name] = [art_cls(flag=f, xyz=x, rgb=np.full_like(x, 0.5),
                                  image=im, point_uv=uv)
                          for f, x, im, uv in zip(FLAGS, xyz, images, uvs)]
            sa.scale_adapter_batch(arts[name])
    jax.clear_caches()
    j.rng = saved_rng
    assert not calls
    for a, b in zip(arts["port"], arts["ref"]):
        assert a.complete_xyz is None and not a.complete_aligned
        m, jm = a.complete_mesh, b.complete_mesh
        assert len(m.faces) == len(jm.faces) > 100
        for x, y in ((m.vertices, jm.vertices),
                     (m.vertex_colors, jm.vertex_colors)):
            assert np.abs(x[m.faces] - y[jm.faces]).max() <= 1e-4


def ref_single_draws(rng, steps, j):
    """The reference's draws of one __call__ (the per-object path) from
    the backend key ``rng``, in the port's layout for one object:
    _mv_init draws the latents from the call's key and carries the rest
    through the steps, each splitting (carry, k1, k2)."""
    _, k = jax.random.split(rng)
    carry, k0 = jax.random.split(k)
    gh, gw = j._grid_hw()
    c, h = j.unet_cfg.in_channels, j.lrm_cfg.view_size // j.factor
    lat = np.asarray(jax.random.normal(k0, (1, gh, gw, c)))
    cn, sn = [], []
    for _ in range(steps):
        carry, k1, k2 = jax.random.split(carry, 3)
        cn.append(np.asarray(jax.random.normal(k1, (2, h, h, c))))
        sn.append(np.asarray(jax.random.normal(k2, (1, gh, gw, c))))
    T = torch.from_numpy
    return (T(lat.transpose(0, 3, 1, 2).copy()),
            T(np.stack(cn)[:, None].transpose(0, 1, 2, 5, 3, 4).copy()),
            T(np.stack(sn).transpose(0, 1, 4, 2, 3).copy()))


def test_scale_adapter_per_object_mesh_matches(backends, tmp_path):
    """ScaleAdapter.scale_adapter (the per-object path: the backend's
    __call__, img2shape's mesh branch, the stage-2 GLB) on both packages,
    the port handed the reference's draws of one call, every layer in
    fp32: the same face count, face corners and colours within 1e-4, and
    each package's GLB loads in the other."""
    from genpc_tpu.io.glb import load_glb as jload
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.scale_adapter import ScaleAdapter as JSA
    from genpc_tpu_torch.io.glb import load_glb
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
    j, t = backends
    r = np.random.default_rng(5)
    image = r.random((48, 48, 3)).astype(np.float32)
    uv = r.random((256, 2)).astype(np.float32)
    xyz = r.normal(size=(256, 3)).astype(np.float32) * 0.2
    draws = ref_single_draws(j.rng, j.mv_steps, j)
    saved_rng = j.rng
    meshes = {}
    jax.clear_caches()
    with precision("f32", *t.models().values()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "draws", lambda b: draws)
        for name, art_cls, sa_cls, cfg_mod, kw in (
                ("ref", JArt, JSA, jconfig, {}),
                ("port", ObjectArtifacts, ScaleAdapter, tconfig,
                 {"device": "cpu"})):
            cfg = cfg_mod.load_config(
                save=True, output_path=str(tmp_path / name),
                generative_model="instantmesh", rembg_model="synthetic",
                model_size="tiny", **kw)
            art = art_cls(flag="01184", xyz=xyz, rgb=np.full_like(xyz, 0.5),
                          image=image, point_uv=uv)
            sa_cls(cfg, image23d=j if name == "ref" else t).scale_adapter(
                art)
            assert art.complete_xyz is None
            meshes[name] = art.complete_mesh
    jax.clear_caches()
    j.rng = saved_rng
    m, jm = meshes["port"], meshes["ref"]
    assert len(m.faces) == len(jm.faces) > 100
    for x, y in ((m.vertices, jm.vertices),
                 (m.vertex_colors, jm.vertex_colors)):
        assert np.abs(x[m.faces] - y[jm.faces]).max() <= 1e-4
    for name, other_load in (("port", jload), ("ref", load_glb)):
        got = other_load(str(tmp_path / name / "01184" /
                             "01184_instantmesh.glb"))
        np.testing.assert_array_equal(got.faces, meshes[name].faces)
        np.testing.assert_array_equal(got.vertices, meshes[name].vertices)


def test_backend_registry_release_and_generate_again():
    """get_image23d builds the port's backend on the asked device; a
    generate call draws from the backend's generator (a second call draws
    anew); release() leaves every parameter on the meta device, and the
    next call materialises the same seeded weights again."""
    from genpc_tpu_torch.models.backends import get_image23d
    b = get_image23d("instantmesh", tconfig.load_config(device="cpu",
                                                        model_size="tiny"))
    assert isinstance(b, tlrm.InstantMeshBackend)
    assert b.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_image23d("instantmesh",
                         tconfig.load_config(model_size="tiny"))
    img = _images(1)[0]
    with recording() as rec:
        m1 = b("01184", img)
        m2 = b("01184", img)
        assert m1.vertices.shape[1] == 3 and m1.faces.shape[1] == 3
        assert m1.vertex_colors.shape == m1.vertices.shape
        assert np.isfinite(m1.vertices).all() and len(m1.faces) > 1
        assert not np.array_equal(m1.vertices, m2.vertices) or \
            len(m1.faces) != len(m2.faces)
        w = b.lrm.transformer.pos_embed.clone()
        b.release()
        assert all(p.is_meta for m in b.models().values()
                   for p in m.parameters())
        b("01184", img)
        assert torch.equal(b.lrm.transformer.pos_embed, w)
    assert {s.name for s in rec.spans} == {
        "init", "context", "denoise", "decode", "grid", "marching",
        "colors", "release"}


# ------------------------------------------------------------ pipeline

def test_batched_reg_samples_the_mesh(pieces):
    """scale_adapter_batch -> batched_reg with a mesh-producing backend
    (the model: tests/test_models.py:254-284): each completion is the
    mesh's surface sample (bit-equal to the reference's sampling), and
    every object gets a fused cloud."""
    from genpc_tpu.io.glb import Mesh as JMesh
    from genpc_tpu.io.glb import sample_mesh_surface as jsample
    from genpc_tpu_torch.parallel.batched_runner import batched_reg
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    cfg = tconfig.load_config(
        device="cpu", save=False, generative_model="instantmesh",
        rembg_model="synthetic", model_size="tiny",
        trust_aligned_completion=False, glb_sample_points=256,
        pose_complete_points=64, icp_points=64, pose_iters=3,
        pose_render_size=32, fused_points=128, fine_scale_steps=2)
    _, got = pieces["bf16"]
    r = np.random.default_rng(1)
    arts = []
    for i in range(2):
        v, f = tlrm.mesh_from_sdf(got["sdf"][i].numpy())
        mesh = tlrm.Mesh(v, f, r.random(v.shape).astype(np.float32))
        xyz = r.normal(size=(256, 3)).astype(np.float32) * 0.2
        arts.append(ObjectArtifacts(
            flag=f"o{i}", color_xyz=xyz, color_rgb=np.full_like(xyz, 0.5),
            complete_mesh=mesh))
    batched_reg(cfg, arts)
    for art in arts:
        m = art.complete_mesh
        p, c = jsample(JMesh(m.vertices, m.faces, m.vertex_colors), 256)
        np.testing.assert_array_equal(art.complete_xyz, p)
        np.testing.assert_array_equal(art.complete_rgb, c)
        # FPS to fused_points, then the outlier mask
        assert art.fused_xyz is not None and 0 < len(art.fused_xyz) <= 128
        assert np.isfinite(art.fused_xyz).all()


def test_reg_on_a_mesh_matches_reference(pieces):
    """The per-object reg of one mesh completion, with the InstantMesh
    orientation fix (the partial's outliers removed, the completion
    turned x 90°, y 90°), in both packages: the fused clouds' CD to the
    partial within 1e-5, EMD within 2 %, scored by the reference."""
    from genpc_tpu.io.glb import Mesh as JMesh
    from genpc_tpu.metrics import metric as jmetric
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.registration import reg as jreg
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    from genpc_tpu_torch.pipeline.registration import reg
    kw = dict(save=False, generative_model="instantmesh", pose_iters=4,
              pose_render_size=32, pose_partial_points=256,
              pose_complete_points=256, icp_points=256, fine_scale_steps=2,
              glb_sample_points=2048, fused_points=600)
    _, got = pieces["f32"]
    v, f = tlrm.mesh_from_sdf(got["sdf"][0].numpy())
    rgb = np.random.default_rng(3).random(v.shape).astype(np.float32)
    r = np.random.default_rng(4)
    xyz = (v[r.choice(len(v), 700)] * 0.4).astype(np.float32)
    xyz = xyz[xyz[:, 0] > -0.05]
    col = np.full_like(xyz, 0.5)
    fused = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        art = JArt("01184", color_xyz=xyz, color_rgb=col,
                   complete_mesh=JMesh(v, f, rgb))
        jreg(jconfig.load_config(**kw), art, verbose=False)
        fused["ref"] = art.fused_xyz
        art = ObjectArtifacts("01184", color_xyz=xyz, color_rgb=col,
                              complete_mesh=tlrm.Mesh(v, f, rgb))
        reg(tconfig.load_config(device="cpu", **kw), art, verbose=False)
        fused["port"] = art.fused_xyz
        gt = (v * 0.4).astype(np.float32)
        mj = jmetric.evaluate_pair(fused["ref"], gt, num_points=512)
        mt = jmetric.evaluate_pair(fused["port"], gt, num_points=512)
    print(f"reg on a mesh: CD {mt['cd']:.6e} vs {mj['cd']:.6e}, EMD "
          f"{mt['emd']:.6e} vs {mj['emd']:.6e}")
    assert fused["port"].shape == fused["ref"].shape
    assert abs(mt["cd"] - mj["cd"]) <= 1e-5
    assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


#: test_torch_generate.py's tiny run_batched config (registration path)
#: with the InstantMesh backend
TINY = dict(
    save=False, control_model="synthetic", model_size="tiny",
    rembg_model="synthetic", generative_model="instantmesh",
    trust_aligned_completion=False, view_num=16, downsample_num=256,
    res=64, cam_res=64, generate_res=64, input_points=4096,
    inpaint_iters=10, glb_sample_points=512, pose_complete_points=64,
    icp_points=64, pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)


def test_run_batched_with_instantmesh_end_to_end(backends, tmp_path):
    """run_batched on the registration path with the InstantMesh backend
    in both packages, each built by the pipeline from the same weights
    (the reference trees) and, in the port, handed the reference's draws:
    every object scored, finite, with a mesh of more than one face; the
    per-object gap in CD and EMD is printed (the meshes are cut from bf16
    SDF grids, where a value near the median can fall to either side)."""
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    j, _ = backends
    write_dataset(str(tmp_path), FLAGS, seed=0, n_gt=8192)
    draws = ref_draws(jax.random.PRNGKey(0), 2, j.mv_steps, j)[1:]
    states, meshes, results = {}, {}, {}
    for pkg, cfg in (("genpc_tpu", jconfig.load_config(**TINY)),
                     ("genpc_tpu_torch", tconfig.load_config(
                         device="cpu", **TINY))):
        lrm = importlib.import_module(f"{pkg}.models.lrm")
        br = importlib.import_module(f"{pkg}.parallel.batched_runner")
        cls = lrm.InstantMeshBackend
        sa = importlib.import_module(f"{pkg}.pipeline.scale_adapter")
        orig = sa.ScaleAdapter.scale_adapter_batch

        def rec(self, arts, orig=orig, pkg=pkg):
            orig(self, arts)
            meshes[pkg] = [a.complete_mesh for a in arts]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(genpc_tpu.native, "voxel_down_sample_native",
                       native_off)
            mp.setattr(sa.ScaleAdapter, "scale_adapter_batch", rec)
            if pkg == "genpc_tpu":
                mp.setattr(cls, "_init_params", lambda self: j._params)
            else:
                init = cls.init_params

                def init_from_ref(self, state=None, init=init):
                    init(self, states.setdefault(
                        "port", port_states(self, j._params)))

                mp.setattr(cls, "init_params", init_from_ref)
                mp.setattr(cls, "draws", lambda self, b: draws)
            results[pkg] = br.run_batched(cfg, FLAGS, str(tmp_path))
    ref, got = results["genpc_tpu"], results["genpc_tpu_torch"]
    assert set(got) == set(ref) == set(FLAGS)
    for f, m, jm in zip(FLAGS, meshes["genpc_tpu_torch"],
                        meshes["genpc_tpu"]):
        assert len(m.faces) > 1 and len(jm.faces) > 1
        print(f"run_batched instantmesh {f}: faces {len(m.faces)} vs "
              f"{len(jm.faces)}; CD {got[f]['cd']:.6e} vs {ref[f]['cd']:.6e}"
              f" (gap {abs(got[f]['cd'] - ref[f]['cd']):.3e}); EMD "
              f"{got[f]['emd']:.6e} vs {ref[f]['emd']:.6e}")
        assert all(np.isfinite(got[f][k]) for k in ("cd", "emd"))

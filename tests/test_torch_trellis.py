"""Parity of the port's TRELLIS and SF3D image-to-3D backends
(genpc_tpu_torch/models/trellis.py, models/sf3d.py) with the JAX
reference on the CPU.

Each port network gets the reference's parameter trees through
``weights.from_flax`` and the same seeded numpy inputs, in both precision
modes of torch_models_ref.py, held to ``TOL``.  The TRELLIS sampler runs
on the reference's jax.random draws (one key an object, split into the
structure flow's and the SLAT flow's), handed to the port's pure
``generate``.
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
from genpc_tpu.models import lrm as jlrm
from genpc_tpu.models import sf3d as jsf
from genpc_tpu.models import trellis as jtr
from genpc_tpu.models import weights as jw
from genpc_tpu_torch.models import sf3d as tsf
from genpc_tpu_torch.models import trellis as ttr
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.tracing import recording
from torch_trellis_ref import ref_trellis_draws, trellis_backends, \
    trellis_inits

K = jax.random.PRNGKey(0)
#: max |port - reference| of the TRELLIS SDF volume after both flows (12
#: steps each) on the reference's draws, over max |reference|, by
#: precision mode (the issue's sampler bound in bf16)
SDF_TOL = {"bf16": 0.08, "f32": 1e-4}
#: the reference's parameter counts at full size (jax.eval_shape), by
#: tree; held in test_full_parameter_counts_match_the_reference
TRELLIS_PARAMS = {"encoder": 18_105_216, "struct": 146_536_705,
                  "slat": 168_568_328, "decoder": 72_463_939}
SF3D_PARAMS = 378_826_062


@pytest.fixture(autouse=True, scope="module")
def _fresh_jit_caches():
    """The reference jits its methods with a static ``self``: clear the
    traced programs around this module, whose f32 mode traces them
    anew."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def trellis_pair():
    return trellis_backends()


def _trellis_case(part, j, t):
    tc = j.tc
    p = j._params
    r = np.random.default_rng(41)
    s, r3 = tc.img_size, tc.slat_res ** 3
    n_tok = (s // tc.patch) ** 2
    img = r.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    tok = r.normal(size=(2, n_tok, tc.img_dim)).astype(np.float32)
    ts = np.array([0.93, 0.41], np.float32)
    xs = r.normal(size=(2, tc.struct_res ** 3, 1)).astype(np.float32)
    xl = r.normal(size=(2, r3, tc.slat_dim)).astype(np.float32)
    occ = r.random((2, r3, 1)).astype(np.float32)
    T = torch.from_numpy
    if part == "encoder":
        return (lambda a: j.encoder.apply(p["encoder"], a), (img,),
                lambda: t.net.encoder(nchw(img)))
    if part == "struct":
        return (lambda a, b, c: j.struct_flow.apply(p["struct"], a, b, c),
                (xs, ts, tok),
                lambda: t.net.struct_flow(T(xs), T(ts), T(tok)))
    if part == "slat":
        return (lambda a, b, c, d: j.slat_flow.apply(p["slat"], a, b, c,
                                                     extra=d),
                (xl, ts, tok, occ),
                lambda: t.net.slat_flow(T(xl), T(ts), T(tok), T(occ)))
    assert part == "decoder"
    return (lambda a: j.decoder.apply(p["decoder"], a), (xl,),
            lambda: t.net.decoder(T(xl)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("part", ["encoder", "struct", "slat", "decoder"])
def test_trellis_modules_match(trellis_pair, part, mode):
    """The image encoder, the structure and SLAT flows' velocity at one
    step (the SLAT flow with the occupancy channel), and the SLAT
    decoder's SDF sub-grids and colours."""
    j, t = trellis_pair
    ref_fn, args, got_fn = _trellis_case(part, j, t)
    with precision(mode, t.net), torch.no_grad():
        ref = jax.jit(ref_fn)(*args)
        got = got_fn()
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        close(a, np.asarray(b), TOL[mode])


def _images(n=2, seed=0, size=48):
    r = np.random.default_rng(seed)
    return [r.random((size, size, 4)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def trellis_runs(trellis_pair):
    """Both packages' device program over 2 objects on the reference's
    draws (the reference's _generate an object), in each precision mode:
    (sdf, rgb, occupancy) of each."""
    from genpc_tpu.models.backends import prep_rgb
    j, t = trellis_pair
    imgs = np.stack([prep_rgb(im, j.tc.img_size) for im in _images()])
    _, keys, sn, ln = ref_trellis_draws(j.rng, 2, j.tc)
    out = {}
    for mode in MODES:
        jax.clear_caches()
        with precision(mode, t.net):
            ref = [j._generate(j._params, jnp.asarray(im * 2 - 1)[None], k,
                               j.steps) for im, k in zip(imgs, keys)]
            ref = tuple(np.stack([np.asarray(r[i]) for r in ref])
                        for i in (0, 2, 3))
            x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()) * 2 - 1
            got = tuple(a.numpy() for a in t.generate(x, sn, ln))
        out[mode] = (ref, got)
    jax.clear_caches()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_trellis_sampler_matches_on_reference_draws(trellis_runs, mode):
    """Both flows (12 steps each), the soft occupancy, the decode and the
    dense SDF assembly on the reference's draws.  The occupancy within
    SDF_TOL; a voxel whose occupancy the two packages put on either side
    of 0.5 (inactive: +1) must lie within SDF_TOL of 0.5; every other
    SDF sample and voxel colour within SDF_TOL of the largest |value|."""
    (rsdf, rrgb, rocc), (gsdf, grgb, gocc) = trellis_runs[mode]
    assert gsdf.shape == rsdf.shape == (2, 16, 16, 16)
    assert grgb.shape == rrgb.shape == (2, 8 ** 3, 3)
    assert gocc.shape == rocc.shape == (2, 8, 8, 8)
    assert np.abs(gocc - rocc).max() <= SDF_TOL[mode]
    flip = (gocc < 0.5) != (rocc < 0.5)
    assert np.abs(rocc[flip] - 0.5).max(initial=0.0) <= SDF_TOL[mode]
    keep = ~np.repeat(np.repeat(np.repeat(flip, 2, 1), 2, 2), 2, 3)
    sdf_gap = float(np.abs(gsdf - rsdf)[keep].max()) / float(
        np.abs(rsdf).max())
    rgb_gap = float(np.abs(grgb - rrgb).max()) / float(np.abs(rrgb).max())
    print(f"trellis sampler, {mode}: occupancy max |d| "
          f"{np.abs(gocc - rocc).max():.3e}, {int(flip.sum())} voxels "
          f"flipped; SDF {sdf_gap:.3e}, colours {rgb_gap:.3e} of max |ref|")
    assert sdf_gap <= SDF_TOL[mode] and rgb_gap <= SDF_TOL[mode]


def test_trellis_meshes_match_in_f32(trellis_pair):
    """generate_meshes_batch in both packages on the reference's draws,
    every layer in fp32: each object has the same faces (corners within
    1e-4) and vertex colours (nearest voxel, within 1e-4)."""
    j, t = trellis_pair
    images = _images(seed=3)
    saved = j.rng
    _, _, sn, ln = ref_trellis_draws(j.rng, 2, j.tc)
    jax.clear_caches()
    with precision("f32", t.net), pytest.MonkeyPatch.context() as mp:
        mp.setattr(t, "draws", lambda b: (sn, ln))
        ref = j.generate_meshes_batch(["a", "b"], images)
        got = t.generate_meshes_batch(["a", "b"], images)
    jax.clear_caches()
    j.rng = saved
    assert sum(len(m.faces) > 100 for m in ref) >= 1
    for m, jm in zip(got, ref):
        assert len(m.faces) == len(jm.faces)
        for x, y in ((m.vertices, jm.vertices),
                     (m.vertex_colors, jm.vertex_colors)):
            assert np.abs(x[m.faces] - y[jm.faces]).max() <= 1e-4


def test_trellis_vertex_colors_round_half_to_even(trellis_pair):
    """The nearest-voxel colour lookup, points on exact half-way grid
    coordinates included, equals the reference's _colors_at."""
    j, t = trellis_pair
    r = t.tc.slat_res
    rgb = np.random.default_rng(5).random((r ** 3, 3)).astype(np.float32)
    half = (np.arange(r - 1) + 0.5) / (r - 1) * 2 - 1
    pts = np.concatenate([
        np.stack([half, half[::-1], np.full_like(half, -1)], 1),
        np.random.default_rng(6).uniform(-1.1, 1.1, (500, 3))]).astype(
        np.float32)
    ref = np.clip(np.asarray(j._colors_at(jnp.asarray(rgb),
                                          jnp.asarray(pts))), 0, 1)
    np.testing.assert_array_equal(t.vertex_colors(pts, rgb), ref)


# ------------------------------------------------------------------ SF3D

LRM = jlrm.LRMConfig.preset("tiny")


@pytest.fixture(scope="module")
def sf3d_pair():
    j = jsf.SF3DBackend(jconfig.load_config(model_size="tiny"))
    s = LRM.img_size
    j._params = ref_params(lambda: j.net.init(
        K, jnp.zeros((1, s, s, 3)), jnp.zeros((8, 3))), 50)
    t = tsf.SF3DBackend(tconfig.load_config(device="cpu", model_size="tiny"))
    t.init_params(tw.from_flax("sf3d", j._params, t.net))
    return j, t


@pytest.mark.parametrize("mode", MODES)
def test_sf3d_planes_and_queries_match(sf3d_pair, mode):
    """forward_planes (the ViT on the global embedding, the triplane
    transformer) and query (SDF, colour, material) on one tree."""
    j, t = sf3d_pair
    r = np.random.default_rng(51)
    s = LRM.img_size
    img = r.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    planes = r.normal(size=(3, 8, 8, LRM.triplane_dim)).astype(np.float32)
    pts = r.uniform(-1.1, 1.1, (64, 3)).astype(np.float32)
    with precision(mode, t.net), torch.no_grad():
        ref_planes = run_jit(lambda p, a: j.net.apply(
            p, a, method=jsf.SF3DNet.forward_planes), j._params, img)
        ref_q = run_jit(lambda p, a, b: j.net.apply(
            p, a, b, method=jsf.SF3DNet.query), j._params, planes, pts)
        got_planes = t.net.forward_planes(nchw(img))
        got_q = t.net.query(torch.from_numpy(planes), torch.from_numpy(pts))
    close(got_planes, np.asarray(ref_planes), TOL[mode])
    for a, b in zip(got_q, ref_q):
        assert a.dtype == torch.float32
        close(a, np.asarray(b), TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_sf3d_grid_and_meshes_match(sf3d_pair, mode):
    """generate_meshes_batch over 2 objects in both packages: the SDF grids
    within TOL of the largest |sdf| (through the reference's jitted
    _planes_and_grid_batch), and, every layer in fp32, each mesh's faces
    and colours as test_trellis_meshes_match_in_f32 holds them."""
    from genpc_tpu.models.backends import prep_rgb
    j, t = sf3d_pair
    images = _images(seed=7)
    imgs = np.stack([prep_rgb(im, LRM.img_size) for im in images])
    jax.clear_caches()
    with precision(mode, t.net):
        _, rsdf = j._planes_and_grid_batch(j._params,
                                           jnp.asarray(imgs * 2 - 1))
        x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy())
        _, gsdf = t.density_grid(x * 2 - 1)
        close(gsdf.flatten(1), np.asarray(rsdf).reshape(2, -1), TOL[mode])
        if mode == "f32":
            ref = j.generate_meshes_batch(["a", "b"], images)
            got = t.generate_meshes_batch(["a", "b"], images)
    jax.clear_caches()
    if mode == "f32":
        for m, jm in zip(got, ref):
            assert len(m.faces) == len(jm.faces) > 100
            for a, b in ((m.vertices, jm.vertices),
                         (m.vertex_colors, jm.vertex_colors)):
                assert np.abs(a[m.faces] - b[jm.faces]).max() <= 1e-4


# ------------------------------------------------------------- registry

@pytest.mark.parametrize("name", ["trellis", "trellis_2", "sf3d"])
def test_registry_builds_on_the_asked_device_and_releases(name):
    """get_image23d builds the port's backend on cfg.device (the card
    unless asked: it raises without one); release() leaves every
    parameter on the meta device and the next call materialises the same
    seeded weights (SF3D draws nothing: the same mesh; TRELLIS draws anew
    an object)."""
    from genpc_tpu_torch.models.backends import get_image23d
    b = get_image23d(name, tconfig.load_config(device="cpu",
                                               model_size="tiny"))
    assert b.device.type == "cpu"
    assert isinstance(b, tsf.SF3DBackend if name == "sf3d"
                      else ttr.TrellisBackend)
    if name != "sf3d":
        assert b.variant == name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_image23d(name, tconfig.load_config(model_size="tiny"))
    img = _images(1, seed=9, size=64)[0]
    with recording() as rec:
        m1 = b("01184", img)
        w = next(iter(b.net.state_dict().values())).clone()
        b.release()
        assert all(p.is_meta for p in b.net.parameters())
        m2 = b("01184", img)
        assert torch.equal(next(iter(b.net.state_dict().values())), w)
        for m in (m1, m2):
            assert m.vertices.shape[1] == 3 and m.faces.shape[1] == 3
            assert m.vertex_colors.shape == m.vertices.shape
            assert np.all(np.abs(m.vertices) <= 1.0 + 1e-5)
        if name == "sf3d":
            np.testing.assert_array_equal(m1.vertices, m2.vertices)
    assert "release" in {s.name for s in rec.spans}


def test_full_parameter_counts_match_the_reference():
    """At full size, on the meta device: each TRELLIS network and SF3D
    have the reference's parameter count (jax.eval_shape), and every
    port parameter maps to a reference leaf of its shape."""
    j = jtr.TrellisBackend(jconfig.load_config(model_size="full"))
    t = ttr.TrellisBackend(tconfig.load_config(device="cpu",
                                               model_size="full"))
    shapes = {k: jw.tree_shapes({k: jax.eval_shape(f)})
              for k, f in trellis_inits(j).items()}
    flat = {p: s for d in shapes.values() for p, s in d.items()}
    sd = t.net.state_dict()
    assert {tw.flax_path("trellis", n) for n in sd} == set(flat)
    for n, v in sd.items():
        assert jw.converted_shape(tuple(v.shape),
                                  flat[tw.flax_path("trellis", n)]) == \
            flat[tw.flax_path("trellis", n)], n
    for k, d in shapes.items():
        assert sum(int(np.prod(s)) for s in d.values()) == TRELLIS_PARAMS[k]
    assert sum(v.numel() for v in sd.values()) == sum(TRELLIS_PARAMS.values())
    c = jlrm.LRMConfig.preset("full")
    jn = jsf.SF3DNet(c)
    flat = jw.tree_shapes(jax.eval_shape(lambda: jn.init(
        K, jnp.zeros((1, c.img_size, c.img_size, 3)), jnp.zeros((8, 3)))))
    assert sum(int(np.prod(s)) for s in flat.values()) == SF3D_PARAMS
    sd = tsf.SF3DBackend(tconfig.load_config(device="cpu",
                                             model_size="full")).net
    assert sum(v.numel() for v in sd.state_dict().values()) == SF3D_PARAMS

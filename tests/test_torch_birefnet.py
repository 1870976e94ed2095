"""Parity of the port's BiRefNet / RMBG-2.0 matting (genpc_tpu_torch/
models/birefnet.py, models/rmbg.py) with the JAX reference on the CPU.

The port's network gets the reference's parameter tree through
``weights.from_flax`` (BatchNorm's running statistics included) and the
same seeded numpy inputs, in both precision modes of torch_models_ref.py
("bf16": the packages' own compute types; "f32": every bf16 layer in fp32
on both sides), held to ``TOL``.  Besides the tiny preset, a ``SHIFTED``
configuration gives every stage a shifted-window block and pads its last
two stages' grids to the window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import MODES, TOL, close, nchw, port, precision, \
    ref_params, run_jit
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu_torch.config as tconfig
from genpc_tpu.models import birefnet as jb
from genpc_tpu.models import checkpoint_specs as specs
from genpc_tpu.models import weights as jw
from genpc_tpu.models.rmbg import RMBGMatting as JRMBG
from genpc_tpu_torch.models import birefnet as tb
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.rmbg import RMBGMatting
from genpc_tpu_torch.tracing import recording

K = jax.random.PRNGKey(0)
#: two blocks a stage (the second shifted), 96² input: 24², 12², 6² and
#: 3² token grids, the last two padded to the window of 4
SHIFTED = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
               window=4, patch=4, img_size=96, dec_inter=8, gdt_ch=8)
#: the reference's parameter count of the full preset (jax.eval_shape;
#: batch_stats included), held in test_full_spec_loads_strictly
FULL_PARAMS = 201_026_555


def _cfgs(name):
    if name == "tiny":
        return jb.BiRefNetConfig.preset("tiny"), \
            tb.BiRefNetConfig.preset("tiny")
    return jb.BiRefNetConfig(**SHIFTED), tb.BiRefNetConfig(**SHIFTED)


def ref_tree(jcfg, seed):
    """The reference's tree from ref_params, with running variances in
    [0.5, 1.5] (ref_params draws them about 0)."""
    j = jb.BiRefNet(jcfg)
    s = jcfg.img_size
    p = ref_params(lambda: j.init(K, jnp.zeros((1, s, s, 3))), seed)
    r = np.random.default_rng(seed + 100)
    p["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.5 + r.random(a.shape)).astype(np.float32)
        if str(path[-1].key) == "var" else a, p["batch_stats"])
    return j, p


@pytest.fixture(scope="module", params=["tiny", "shifted"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    j, p = ref_tree(jcfg, 31)
    t = port(tb.BiRefNet, tcfg, kind="birefnet", params=p)
    x = np.random.default_rng(32).random(
        (2, jcfg.img_size, jcfg.img_size, 3)).astype(np.float32) - 0.5
    return jcfg, j, p, t, x


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_is_jax_bilinear_resize(factor):
    """F.interpolate(bilinear, align_corners=False) by 2 and 4 equals
    jax.image.resize(..., "bilinear"), the edge rows and columns
    included."""
    x = np.random.default_rng(factor).normal(size=(2, 5, 7, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(
        x, (2, 5 * factor, 7 * factor, 3), "bilinear"))
    got = tb._upsample(nchw(x), factor).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()


def test_window_helpers_and_shift_mask_match():
    x = np.random.default_rng(3).normal(size=(2, 8, 12, 5)).astype(
        np.float32)
    w = jb.window_partition(jnp.asarray(x), 4)
    np.testing.assert_array_equal(
        tb.window_partition(torch.from_numpy(x), 4).numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tb.window_reverse(torch.from_numpy(np.asarray(w)), 4, 8, 12).numpy(),
        x)
    np.testing.assert_array_equal(tb.relative_position_index(12),
                                  jb.relative_position_index(12))
    # the shifted-window mask on a padded 36 x 36 grid, window 12 (the
    # full preset's last stage): -1e9 across regions
    m = tb.shift_mask(36, 36, 12, 6)
    assert m.shape == (9, 144, 144)
    assert set(np.unique(m)) == {0.0, np.float32(-1e9)}
    assert (m[0] == 0).all() and (m[-1] != 0).any()


@pytest.mark.parametrize("mode", MODES)
def test_swin_stages_match(pair, mode):
    """Each Swin stage's out-normed features (strides 4, 8, 16, 32)."""
    jcfg, _, p, t, x = pair
    bb = {"params": p["params"]["bb"]}
    with precision(mode, t), torch.no_grad():
        ref = run_jit(jb.SwinBackbone(jcfg).apply, bb, x)
        got = t.bb(nchw(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        close(g.permute(0, 3, 1, 2), np.asarray(r), TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_matte_matches(pair, mode):
    """The whole network: the sigmoid matte [B, 1, H, W]."""
    _, j, p, t, x = pair
    with precision(mode, t), torch.no_grad():
        ref = run_jit(j.apply, p, x)
        got = t(nchw(x))
    assert got.dtype == torch.float32 and got.shape[1] == 1
    assert float(np.asarray(ref).std()) > 1e-3
    close(got, ref, TOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_rmbg_matting_matches(mode):
    """RMBGMatting on a 48 x 40 RGBA image in both packages (the host
    resizes through uint8, the device matte, the resize back): RGB
    carried exactly, the alpha within one uint8 level in fp32 (the
    matte's rounding to uint8 may flip a level) and within TOL in
    bf16."""
    jcfg, tcfg = _cfgs("tiny")
    _, p = ref_tree(jcfg, 33)
    # the reference's backend without its flax init (~40 s here): the
    # attributes its __init__ sets, the parameters from the tree
    jr = JRMBG.__new__(JRMBG)
    jr.cfg, jr.net_cfg, jr.params = {}, jcfg, p
    jr.net = jb.BiRefNet(jcfg)
    tr = RMBGMatting(tconfig.load_config(device="cpu", model_size="tiny"))
    tr.init_params(tw.from_flax("birefnet", p, tr.net))
    img = np.random.default_rng(34).random((48, 40, 4)).astype(np.float32)
    with precision(mode, tr.net):
        jr._apply = jax.jit(jr.net.apply)
        ref = jr(img)
        got = tr(img)
    assert got.shape == ref.shape == (48, 40, 4)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    gap = float(np.abs(got[..., 3] - ref[..., 3]).max())
    assert gap <= (1.0 / 255 + 1e-6 if mode == "f32" else TOL[mode]), gap
    assert 0.0 <= got[..., 3].min() and got[..., 3].max() <= 1.0


def test_spec_names_load_strictly():
    """Every RMBG-2.0 key of the tiny spec (a synthetic checkpoint, with
    the registered buffers a real one carries) loads strictly into the
    port's BiRefNet through load_matting, and the port's forward on it
    matches the reference's load of the same checkpoint (fp32)."""
    import os
    import tempfile
    from safetensors.numpy import save_file
    jcfg, tcfg = _cfgs("tiny")
    spec = specs.spec_birefnet(jcfg)
    ckpt = jw.synthetic_checkpoint(spec, seed=5)
    for k in [k for k in ckpt if k.endswith("running_var")]:
        ckpt[k] = np.abs(ckpt[k]) + 0.5
    ckpt["bb.layers.0.blocks.0.attn.relative_position_index"] = \
        np.zeros((jcfg.window ** 2, jcfg.window ** 2), np.int64)
    ckpt["squeeze_module.0.bn_in.num_batches_tracked"] = np.zeros(
        (), np.int64)
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "rmbg"))
        save_file(ckpt, os.path.join(d, "rmbg", "model.safetensors"))
        j = jb.BiRefNet(jcfg)
        s = jcfg.img_size
        p = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         jax.eval_shape(lambda: j.init(
                             K, jnp.zeros((1, s, s, 3)))))
        p = jw.load_matting(d, p)
        with torch.device("meta"):
            t = tb.BiRefNet(tcfg)
        tw.materialize(t, "cpu", torch.float32)
        tw.load_matting(d, t)
    for name, v in t.state_dict().items():
        assert torch.equal(v, torch.from_numpy(ckpt[name])), name
    x = np.random.default_rng(6).random((1, s, s, 3)).astype(np.float32)
    with precision("f32", t), torch.no_grad():
        close(t(nchw(x)), run_jit(j.apply, p, x), TOL["f32"])


def test_full_spec_loads_strictly():
    """At full size (Swin-v1-Large, 1024²): the port's state-dict names
    and shapes are the RMBG-2.0 spec's (no other key), its reference
    paths are the reference tree's, and the parameter count is the
    reference's (jax.eval_shape)."""
    jcfg, tcfg = jb.BiRefNetConfig.preset("full"), \
        tb.BiRefNetConfig.preset("full")
    with torch.device("meta"):
        t = tb.BiRefNet(tcfg)
    sd = {k: tuple(v.shape) for k, v in t.state_dict().items()}
    assert sd == specs.spec_birefnet(jcfg)
    j = jb.BiRefNet(jcfg)
    shapes = jw.tree_shapes(jax.eval_shape(lambda: j.init(
        K, jnp.zeros((1, 1024, 1024, 3)))))
    paths = {tw.flax_path("birefnet", k): k for k in sd}
    assert set(paths) == set(shapes)
    for path, name in paths.items():
        assert jw.converted_shape(sd[name], shapes[path]) == shapes[path]
    n = sum(int(np.prod(v)) for v in shapes.values())
    assert n == FULL_PARAMS
    assert sum(v.numel() for v in t.state_dict().values()) == n


def test_registry_builds_on_the_asked_device_and_releases():
    """get_rembg('rmbg' | 'RMBG') builds the port's backend on cfg.device
    (the card unless asked: it raises without one); a call materialises
    the seeded weights, release() frees them, and the next call gives
    the same matte."""
    from genpc_tpu_torch.models.backends import get_rembg
    for name in ("rmbg", "RMBG"):
        b = get_rembg(name, tconfig.load_config(device="cpu",
                                                model_size="tiny"))
        assert isinstance(b, RMBGMatting) and b.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            get_rembg("rmbg", tconfig.load_config(model_size="tiny"))
    img = np.random.default_rng(7).random((30, 50, 3)).astype(np.float32)
    with recording() as rec:
        a = b(img)
        b.release()
        assert all(p.is_meta for p in b.net.parameters())
        np.testing.assert_array_equal(b(img), a)
    assert {s.name for s in rec.spans} == {"init", "matte", "release"}

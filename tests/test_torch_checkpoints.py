"""Checkpoints of the port's generative models (genpc_tpu_torch/models/
weights.py): the parameter names a real diffusers / HF checkpoint loads
by, their coverage of the JAX reference's trees, the safetensors reader,
one synthetic checkpoint loaded by both packages, ``from_flax``'s
refusals, and seeded random weights that repeat across processes."""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import TOL, close, nchw, precision, run_jit
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.models import checkpoint_specs as specs
from genpc_tpu.models import text_encoder as jte
from genpc_tpu.models import weights as jw
from genpc_tpu.models.adapter import T2IAdapter as JAdapter
from genpc_tpu.models.unet import ControlNet as JControlNet
from genpc_tpu.models.unet import UNet2DCondition as JUNet
from genpc_tpu.models.unet import UNetConfig as JUNetConfig
from genpc_tpu.models.vae import AutoencoderKL as JVAE
from genpc_tpu.models.vae import VAEConfig as JVAEConfig
from genpc_tpu_torch.models import text_encoder as tte
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.adapter import T2IAdapter
from genpc_tpu_torch.models.unet import ControlNet, UNet2DCondition, UNetConfig
from genpc_tpu_torch.models.vae import AutoencoderKL, VAEConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COND_CH = (16, 32, 96, 256)


def _zeros_tree(init):
    """Zeros of the shapes of a reference ``init()`` (traced, never run)."""
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                        fnn.meta.unbox(jax.eval_shape(init)))


def _port_names_to_flax(kind, module):
    levels = tw._levels(module)
    return {tw.flax_path(kind, k, levels): tuple(v.shape)
            for k, v in module.state_dict().items()}


@pytest.mark.parametrize("preset", ["tiny", "sdxl"])
def test_spec_coverage_for_real_checkpoints(preset):
    """The port's state-dict names and shapes are the diffusers / HF
    checkpoints' (checkpoint_specs), so a checkpoint loads with
    strict=True; mapped by the port's name maps they land on every leaf
    of the reference tree (jax.eval_shape) with the transposed shapes."""
    cfg = JUNetConfig.preset(preset)
    l_name, g_name = ("tiny", "tiny_g") if preset == "tiny" \
        else ("clip_l", "clip_g")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.preset(preset))
        cn = ControlNet(UNetConfig.preset(preset), COND_CH)
        clip_l = tte.CLIPTextModel(tte.CLIPTextConfig.preset(l_name))
        clip_g = tte.CLIPTextModel(tte.CLIPTextConfig.preset(g_name))
    lat = jnp.zeros((1, 8, 8, 4))
    ctx = jnp.zeros((1, 16, cfg.context_dim))
    added = jnp.zeros((1, cfg.addition_embed_dim))
    t = jnp.zeros((1,))
    k = jax.random.PRNGKey(0)
    trees = {
        "unet": jax.eval_shape(lambda: JUNet(cfg).init(
            k, lat, t, ctx, added_cond=added)),
        "controlnet": jax.eval_shape(lambda: JControlNet(cfg, COND_CH).init(
            k, lat, t, ctx, jnp.zeros((1, 64, 64, 3)), added_cond=added)),
    }
    for kind, name in (("clip_l", l_name), ("clip_g", g_name)):
        jm = jte.CLIPTextModel(jte.CLIPTextConfig.preset(name))
        trees[kind] = jax.eval_shape(lambda jm=jm: jm.init(
            k, jnp.zeros((1, 77), jnp.int32)))
    ports = {"unet": (unet, specs.spec_unet(cfg)),
             "controlnet": (cn, specs.spec_controlnet(cfg, COND_CH)),
             "clip_l": (clip_l, specs.spec_clip_text(
                 jte.CLIPTextConfig.preset(l_name))),
             "clip_g": (clip_g, specs.spec_clip_text(
                 jte.CLIPTextConfig.preset(g_name)))}
    for kind, (mod, spec) in ports.items():
        names = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        assert names == spec, kind
        missing, mismatched, uncovered = jw.verify_spec_coverage(
            jw.tree_shapes(trees[kind]), _port_names_to_flax(kind, mod))
        assert not missing and not mismatched and not uncovered, \
            (kind, missing[:4], mismatched[:4], uncovered[:4])


def test_vae_and_adapter_names_cover_the_reference_tree():
    """The full-size VAE and the SDXL-width adapter (which have no
    checkpoint inventory in the reference) cover their trees too."""
    with torch.device("meta"):
        vae = AutoencoderKL(VAEConfig())
        ad = T2IAdapter((320, 320, 640), 8)
    k = jax.random.PRNGKey(0)
    img = jnp.zeros((1, 64, 64, 3))
    trees = {"vae": jax.eval_shape(lambda: JVAE(JVAEConfig()).init(k, img)),
             "adapter": jax.eval_shape(lambda: JAdapter(
                 (320, 320, 640), 8).init(k, img))}
    for kind, mod in (("vae", vae), ("adapter", ad)):
        missing, mismatched, uncovered = jw.verify_spec_coverage(
            jw.tree_shapes(trees[kind]), _port_names_to_flax(kind, mod))
        assert not missing and not mismatched and not uncovered, kind


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import save_file
    r = torch.Generator().manual_seed(0)
    src = {"a.weight": torch.randn(3, 5, generator=r),
           "b": torch.randn(7, generator=r).to(torch.bfloat16),
           "c": torch.randn(2, 2, 2, generator=r).to(torch.float16),
           "d": torch.arange(6, dtype=torch.int64).reshape(2, 3),
           "e": torch.zeros(0)}
    save_file(src, str(tmp_path / "x.safetensors"))
    got = tw.read_safetensors(str(tmp_path / "x.safetensors"))
    assert set(got) == set(src)
    for k, v in src.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_synthetic_checkpoint_loads_in_both_packages(tmp_path):
    """One synthetic diffusers-named UNet checkpoint, loaded by the
    reference's load_sdxl_controlnet and by the port's reader and
    load_state_dict(strict=True): the same weights, the same forward
    (every layer in fp32 on both sides, torch_models_ref.precision)."""
    from safetensors.numpy import save_file
    cfg = JUNetConfig.preset("tiny")
    ckpt = jw.synthetic_checkpoint(specs.spec_unet(cfg), seed=3)
    os.makedirs(tmp_path / "unet")
    save_file(ckpt, str(tmp_path / "unet" / "model.safetensors"))
    r = np.random.default_rng(0)
    lat = r.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ctx = r.normal(size=(1, 77, cfg.context_dim)).astype(np.float32)
    added = r.normal(size=(1, cfg.addition_embed_dim)).astype(np.float32)
    t = np.array([613.0], np.float32)
    j = JUNet(cfg)
    params = {"unet": _zeros_tree(lambda: j.init(
        jax.random.PRNGKey(0), jnp.asarray(lat), jnp.asarray(t),
        jnp.asarray(ctx), added_cond=jnp.asarray(added)))}
    params = jw.load_sdxl_controlnet(str(tmp_path), params)
    with torch.device("meta"):
        tu = UNet2DCondition(UNetConfig.preset("tiny"))
    tw.materialize(tu, "cpu", torch.float32)
    tw.load_sdxl_controlnet(str(tmp_path), tu)
    for name, v in tu.state_dict().items():
        assert torch.equal(v, torch.from_numpy(ckpt[name])), name
    with precision("f32", tu), torch.no_grad():
        ref = run_jit(lambda p, a, b, c, d: j.apply(p, a, b, c, added_cond=d),
                      params["unet"], lat, t, ctx, added)
        got = tu(nchw(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                 added_cond=torch.from_numpy(added))
    close(got, ref, TOL["f32"])


def test_from_flax_refuses_a_partial_tree():
    with torch.device("meta"):
        t = UNet2DCondition(UNetConfig.preset("tiny"))
    cfg = JUNetConfig.preset("tiny")
    tree = _zeros_tree(lambda: JUNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 8, cfg.context_dim)),
        added_cond=jnp.zeros((1, cfg.addition_embed_dim))))
    assert set(tw.from_flax("unet", tree, t)) == set(t.state_dict())
    inner = dict(tree["params"])
    inner.pop("conv_out")
    with pytest.raises(KeyError, match="conv_out"):
        tw.from_flax("unet", {"params": inner}, t)
    extra = dict(tree["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="stray"):
        tw.from_flax("unet", {"params": extra}, t)


_DIGEST = (
    "import hashlib, torch\n"
    "from genpc_tpu_torch.models.controlnet_depth import ControlNetDepth\n"
    "b = ControlNetDepth({'device': 'cpu', 'model_size': 'tiny'})\n"
    "b.init_params()\n"
    "h = hashlib.sha1()\n"
    "for kind, m in b.models().items():\n"
    "    for k, v in m.state_dict().items():\n"
    "        h.update(k.encode()); h.update(v.numpy().tobytes())\n"
    "print(h.hexdigest())\n")


def test_random_weights_repeat_across_processes():
    """The random weights are seeded by a CRC-32 of each tensor's name,
    not by the salted builtin hash() the reference folds in
    (genpc_tpu/models/weights.py:168): two interpreters with different
    hash seeds draw the same weights."""
    outs = []
    for hash_seed in ("1", "2"):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, PYTHONHASHSEED=hash_seed)
        outs.append(subprocess.run(
            [sys.executable, "-c", _DIGEST], check=True, cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120).stdout.strip())
    assert outs[0] == outs[1] and len(outs[0]) == 40
    # norm scales 1, biases 0, the rest N(0, 0.02)
    with torch.device("meta"):
        u = UNet2DCondition(UNetConfig.preset("tiny"))
    tw.materialize(u, "cpu", torch.bfloat16, seed=0, prefix="unet")
    sd = u.state_dict()
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert torch.all(sd["conv_norm_out.weight"] == 1)
    assert torch.all(sd["conv_out.bias"] == 0)
    w = sd["down_blocks.1.attentions.0.proj_in.weight"].float()
    assert abs(float(w.std()) - 0.02) < 0.002


# ------------------------------------------------------------ InstantMesh

def _from_flax_shapes(kind, module, shapes):
    """``weights.from_flax`` at the level of shapes: every port parameter
    takes its reference leaves (fused ones concatenated), with the
    transposed shape, and no leaf is left over."""
    flat = dict(shapes)
    levels = tw._levels(module)
    for name, p in module.state_dict().items():
        paths = tw.flax_path(kind, name, levels)
        paths = (paths,) if isinstance(paths, str) else paths
        got = [tw.flax_layout(path, np.broadcast_to(
            np.float32(0), flat.pop(path))).shape for path in paths]
        whole = (sum(s[0] for s in got),) + got[0][1:]
        assert whole == tuple(p.shape), (kind, name, whole, p.shape)
    assert not flat, (kind, sorted(flat)[:4])


def _ref_instantmesh_shapes(size):
    """The reference backend's parameter tree at ``size`` from
    jax.eval_shape (its _init_params with the random fill left out)."""
    import genpc_tpu.config as jconfig
    from genpc_tpu.models.lrm import InstantMeshBackend as JIM
    j = JIM(jconfig.load_config(model_size=size))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jw, "random_bf16_params", lambda tree, seed=0: tree)
        return j, fnn.meta.unbox(jax.eval_shape(j._init_params))


@pytest.fixture(scope="module", params=["tiny", "full"])
def instantmesh_pair(request):
    from genpc_tpu_torch.models.lrm import InstantMeshBackend
    j, tree = _ref_instantmesh_shapes(request.param)
    t = InstantMeshBackend({"device": "cpu", "model_size": request.param})
    return request.param, j, tree, t


def test_instantmesh_names_match_the_specs(instantmesh_pair):
    """The port's LRM, zero123plus UNet (SD2 layout at full size) and CLIP
    vision tower carry the InstantMesh / diffusers / HF checkpoint names
    and shapes (checkpoint_specs), on the meta device; mapped by the
    port's name maps they take every leaf of the reference's trees."""
    from dataclasses import replace
    size, j, tree, t = instantmesh_pair
    specs_of = {
        "lrm": specs.spec_instantmesh(j.lrm_cfg),
        "unet": specs.spec_unet(replace(j.unet_cfg, addition_embed_dim=0)),
        "clip_vision": specs.spec_clip_vision(j.vis_cfg),
        "clip_text": specs.spec_clip_text(j.txt_cfg)}
    for kind, mod in t.models().items():
        assert all(p.is_meta for p in mod.parameters())
        names = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        if kind in specs_of:
            assert names == specs_of[kind], (size, kind)
        _from_flax_shapes(kind, mod, jw.tree_shapes(tree[kind]))
    assert tuple(tree["ramping"].shape) == (j.txt_cfg.max_len,)


def test_instantmesh_parameter_count_matches_the_reference(instantmesh_pair):
    """The port's parameters (meta device) and the 77 ramping
    coefficients count what the reference's tree counts: at full size
    2,301,454,692, bench_artifacts/instantmesh.json's count."""
    size, _, tree, t = instantmesh_pair
    ref = sum(int(np.prod(s)) for s in jw.tree_shapes(tree).values())
    got = sum(p.numel() for m in t.models().values()
              for p in m.parameters()) + t.txt_cfg.max_len
    assert got == ref
    if size == "full":
        assert got == 2_301_454_692


def test_load_instantmesh_matches_the_reference(tmp_path):
    """One synthetic checkpoint of every InstantMesh directory (the LRM
    with its lrm_generator. prefix, the zero123plus UNet, VAE, text and
    vision towers with their position_ids buffers) and a ramping JSON,
    loaded by the reference's load_instantmesh and by the port's: the
    same tensors, the same ramping, and with every layer in fp32 the same
    context, condition latents, UNet output and triplanes.  Both backends
    carry an SD2-shaped tiny UNet (four levels): the reference's loader
    maps the UNet's names for four levels only."""
    import json
    from dataclasses import replace
    from safetensors.numpy import save_file
    import genpc_tpu.config as jconfig
    from genpc_tpu.models import lrm as jlrm
    from genpc_tpu.models.unet import UNet2DCondition as JU
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models import lrm as tlrm
    ucfg = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
                transformer_depths=(1, 1, 1, 0), mid_depth=1,
                context_dim=64, attention_head_dim=16)
    j = jlrm.InstantMeshBackend(jconfig.load_config(model_size="tiny"))
    j.unet_cfg = JUNetConfig(**ucfg)
    j.unet = JU(j.unet_cfg)
    t = tlrm.InstantMeshBackend(load_config(
        device="cpu", model_size="tiny", weights_dir=str(tmp_path)))
    t.unet_cfg = UNetConfig(**ucfg)
    with torch.device("meta"):
        t.unet = UNet2DCondition(t.unet_cfg)
    ckpts = {
        "instantmesh": {f"lrm_generator.{k}": v for k, v in
                        jw.synthetic_checkpoint(specs.spec_instantmesh(
                            j.lrm_cfg), seed=1).items()},
        "zero123plus_unet": jw.synthetic_checkpoint(
            specs.spec_unet(j.unet_cfg), seed=2),
        "zero123plus_vae": jw.synthetic_checkpoint(
            {k: tuple(v.shape) for k, v in t.vae.state_dict().items()},
            seed=3),
        "zero123plus_text_encoder": jw.synthetic_checkpoint(
            specs.spec_clip_text(j.txt_cfg), seed=4),
        "zero123plus_vision_encoder": jw.synthetic_checkpoint(
            specs.spec_clip_vision(j.vis_cfg), seed=5)}
    ckpts["zero123plus_text_encoder"][
        "text_model.embeddings.position_ids"] = np.arange(77)[None]
    ckpts["zero123plus_vision_encoder"][
        "vision_model.embeddings.position_ids"] = np.arange(17)[None]
    for sub, ck in ckpts.items():
        os.makedirs(tmp_path / sub)
        save_file(ck, str(tmp_path / sub / "model.safetensors"))
    ramp = np.random.default_rng(6).random(77).astype(np.float32)
    (tmp_path / "zero123plus_config.json").write_text(json.dumps(
        {"ramping_coefficients": ramp.tolist()}))

    k, z = jax.random.PRNGKey(0), jnp.zeros
    params = {
        "lrm": _zeros_tree(lambda: j.lrm.init(
            k, z((1, 6, 32, 32, 3)), z((1, 6, 16)), z((8, 3)))),
        "unet": _zeros_tree(lambda: j.unet.init(
            k, z((1, 16, 16, 4)), z((1,)), z((1, 16, 64)))),
        "vae": _zeros_tree(lambda: j.vae.init(k, z((1, 32, 32, 3)))),
        "clip_text": _zeros_tree(lambda: j.clip_text.init(
            k, z((1, 77), jnp.int32))),
        "clip_vision": _zeros_tree(lambda: j.clip_vision.init(
            k, z((1, 32, 32, 3)))),
        "ramping": np.linspace(0.0, 1.0, 77, dtype=np.float32)}
    params = jw.load_instantmesh(str(tmp_path), params)
    t.init_params()
    np.testing.assert_array_equal(np.asarray(params["ramping"]), ramp)
    np.testing.assert_array_equal(t.ramping.numpy(), ramp)
    lrm_sd = t.lrm.state_dict()
    for k, v in ckpts["instantmesh"].items():
        assert torch.equal(lrm_sd[k[len("lrm_generator."):]],
                           torch.from_numpy(v)), k
    r = np.random.default_rng(7)
    imgs = r.random((2, 32, 32, 3)).astype(np.float32)
    lat = r.normal(size=(2, 16, 16, 4)).astype(np.float32)
    views = r.random((1, 6, 32, 32, 3)).astype(np.float32)
    cams = jlrm.zero123plus_cameras()[None]
    j._params = params
    with precision("f32", *t.models().values()), torch.no_grad():
        ctx = np.asarray(j._encode_context_batch(params, imgs))
        cond = run_jit(lambda p, x: j.vae.apply(
            p, x, method=type(j.vae).encode), params["vae"], imgs * 2 - 1)
        eps = run_jit(lambda p, a, c: j.unet.apply(
            p, a, jnp.full((2,), 613.0), c), params["unet"], lat,
            ctx[:, 1])
        planes = run_jit(lambda p, v, c: j.lrm.apply(
            p, v, c, method=jlrm.TriplaneLRM.forward_planes),
            params["lrm"], views, cams)
        tctx = t.encode_context(imgs)
        tcond = t.vae.encode(nchw(imgs * 2 - 1))
        teps = t.unet(nchw(lat), torch.full((2,), 613.0), tctx[:, 1])
        tplanes = t.lrm.forward_planes(
            torch.from_numpy(views.transpose(0, 1, 4, 2, 3).copy()),
            torch.from_numpy(cams))
    close(tctx.flatten(0, 1), ctx.reshape(-1, 77, 64), TOL["f32"])
    close(tcond, cond, TOL["f32"])
    close(teps, eps, TOL["f32"])
    close(tplanes, planes, TOL["f32"])

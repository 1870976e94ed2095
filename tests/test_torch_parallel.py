"""Parity of the port's multi-device path (genpc_tpu_torch/parallel/mesh.py
and the mesh paths of the batched runners and evaluate_pair) with the
JAX reference on the CPU: the port's meshes repeat the CPU device, the
reference's run on the 8 virtual CPU devices of tests/conftest.py.  Each
test of tests/test_parallel.py has its counterpart here."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_models_ref import close, port, precision
from torch_replay import native_off
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.native
from genpc_tpu.config import load_config as jload
from genpc_tpu.metrics.losses import chamfer_l1 as jchamfer_l1
from genpc_tpu.metrics.metric import evaluate_pair as jevaluate_pair
from genpc_tpu.parallel import mesh as jmesh
from genpc_tpu_torch.config import load_config as tload
from genpc_tpu_torch.io.synthetic_data import write_dataset
from genpc_tpu_torch.metrics.metric import evaluate_pair
from genpc_tpu_torch.parallel import mesh as tmesh

jbr = importlib.import_module("genpc_tpu.parallel.batched_runner")
tbr = importlib.import_module("genpc_tpu_torch.parallel.batched_runner")


def _cpus(n):
    return ["cpu"] * n


def test_make_mesh_shapes():
    # the reference's shapes and error, on repeated CPU devices; the
    # default device list is every CUDA device (none here)
    mesh = tmesh.make_mesh({"dp": 4, "sp": 2}, devices=_cpus(8))
    ref = jmesh.make_mesh({"dp": 4, "sp": 2}, devices=jax.devices("cpu"))
    assert mesh.axis_names == ref.axis_names == ("dp", "sp")
    assert mesh.devices.shape == ref.devices.shape == (4, 2)
    assert mesh.shape == dict(ref.shape)
    assert mesh.axis_devices("dp") == [torch.device("cpu")] * 4
    for make, devs in ((tmesh.make_mesh, _cpus(8)),
                       (jmesh.make_mesh, jax.devices("cpu"))):
        with pytest.raises(ValueError):
            make({"dp": 64}, devices=devs)
    with pytest.raises(ValueError):
        tmesh.make_mesh({"dp": 1})
    assert tmesh.get_mesh(tload(device="cpu")) is None
    m = tmesh.get_mesh(tload(device="cpu", mesh_shape={"dp": 2}))
    assert m.shape == {"dp": 2} and tmesh.dp_size(m) == 2
    assert tmesh.dp_size(None) == tmesh.dp_size(
        tmesh.make_mesh({"sp": 2}, _cpus(2))) == 1


def test_sharded_chamfer_matches_single_device(rng):
    # within 1e-5 of the reference's sharded and single-device chamfer
    x = rng.random((512, 3)).astype(np.float32)
    y = rng.random((512, 3)).astype(np.float32)
    mesh = tmesh.make_mesh({"dp": 4, "sp": 2}, devices=_cpus(8))
    got = float(tmesh.sharded_chamfer_l1(torch.tensor(x), torch.tensor(y),
                                         mesh, axis="sp"))
    jm = jmesh.make_mesh({"dp": 4, "sp": 2}, devices=jax.devices("cpu"))
    ref = float(jmesh.sharded_chamfer_l1(jnp.asarray(x), jnp.asarray(y), jm,
                                         axis="sp"))
    assert abs(got - ref) < 1e-5
    assert abs(got - float(jchamfer_l1(jnp.asarray(x), jnp.asarray(y)))) \
        < 1e-5
    with pytest.raises(ValueError):
        tmesh.sharded_chamfer_l1(torch.tensor(x[:511]), torch.tensor(y),
                                 mesh, axis="sp")


def test_stage1_core_dp_matches_single_device():
    # the reference test's config and bounds: the port's dp=2 core
    # against its unsharded core and against the reference's dp=2 core
    # (viewpoints equal, uv within 1e-5, depth within 1e-4)
    from genpc_tpu.geometry.cameras import create_cameras
    kw = dict(save=False, view_num=16, downsample_num=128, res=64,
              input_points=512, inpaint_iters=10)
    _, viewpoints = create_cameras(num_views=16, distance=1.6, fovy=49.1,
                                   res=256)
    r = np.random.default_rng(0)
    xyz = (r.normal(size=(2, 512, 3)) * 0.2).astype(np.float32)
    rgb = np.full((2, 512, 3), 0.5, np.float32)
    cfg = tload(device="cpu", **kw)
    single = tbr.make_stage1_core(cfg, viewpoints)(torch.tensor(xyz),
                                                   torch.tensor(rgb))
    mesh = tmesh.make_mesh({"dp": 2}, devices=_cpus(2))
    sharded = tbr.make_stage1_core(cfg, viewpoints, mesh=mesh)(
        *tmesh.dp_sharded(mesh, xyz, rgb))
    jm = jmesh.make_mesh({"dp": 2}, devices=jax.devices("cpu")[:2])
    ref = jbr.make_stage1_core(jload(**kw), viewpoints, mesh=jm)(
        *jmesh.dp_sharded(jm, jnp.asarray(xyz), jnp.asarray(rgb)))
    uv, vp, _, depth, _, _ = (t.numpy() for t in sharded)
    for other in ([t.numpy() for t in single], [np.asarray(a) for a in ref]):
        np.testing.assert_array_equal(vp, other[1])
        np.testing.assert_allclose(uv, other[0], atol=1e-5)
        np.testing.assert_allclose(depth, other[3], atol=1e-4)


def _reg_arts(pkg, n):
    """tests/test_parallel.py's objects: a partial and its mirrored,
    noisy completion."""
    arts_mod = importlib.import_module(f"{pkg}.pipeline.artifacts")
    arts = []
    for i in range(n):
        r = np.random.default_rng(i)
        partial = r.normal(size=(256, 3)).astype(np.float32) * 0.2
        complete = np.concatenate([partial, -partial + r.normal(
            size=(256, 3)).astype(np.float32) * 0.02])
        art = arts_mod.ObjectArtifacts(flag=f"obj{i}", xyz=partial,
                                       rgb=np.full((256, 3), 0.5, np.float32))
        art.color_xyz = partial
        art.color_rgb = np.full((256, 3), 0.5, np.float32)
        art.complete_xyz = complete
        art.complete_rgb = np.full((len(complete), 3), 0.5, np.float32)
        arts.append(art)
    return arts


REG = dict(save=False, output_path="/tmp/test_ws",
           trust_aligned_completion=False, glb_sample_points=256,
           pose_complete_points=64, icp_points=64, pose_iters=3,
           pose_render_size=32, fused_points=128, fine_scale_steps=2)


def test_batched_reg_dp_matches_single_device(monkeypatch):
    # the production batched_reg at dp=4: the fused clouds within 1e-5 of
    # the unsharded port's (a batch of 1 sums in another order: measured
    # 6.6e-7) and within 2e-3 of the reference's dp=4 run
    # (tests/test_parallel.py:103); the reference's voxel downsample
    # pinned to its numpy algorithm
    monkeypatch.setattr(genpc_tpu.native, "voxel_down_sample_native",
                        native_off)
    cfg = tload(device="cpu", **REG)
    single = _reg_arts("genpc_tpu_torch", 4)
    tbr.batched_reg(cfg, single)
    sharded = _reg_arts("genpc_tpu_torch", 4)
    tbr.batched_reg(cfg, sharded,
                    mesh=tmesh.make_mesh({"dp": 4}, devices=_cpus(4)))
    ref = _reg_arts("genpc_tpu", 4)
    jbr.batched_reg(jload(**REG), ref, mesh=jmesh.make_mesh(
        {"dp": 4}, devices=jax.devices("cpu")[:4]))
    for a, b, c in zip(single, sharded, ref):
        assert a.fused_xyz.shape == b.fused_xyz.shape == c.fused_xyz.shape
        np.testing.assert_allclose(b.fused_xyz, a.fused_xyz, atol=1e-5)
        np.testing.assert_allclose(b.fused_xyz, c.fused_xyz, atol=2e-3)
    # three objects do not split over dp=4: the mesh is dropped
    odd = _reg_arts("genpc_tpu_torch", 3)
    tbr.batched_reg(cfg, odd, mesh=tmesh.make_mesh({"dp": 4}, _cpus(4)))
    for a, b in zip(single, odd):
        np.testing.assert_allclose(b.fused_xyz, a.fused_xyz, atol=1e-5)


def test_evaluate_pair_sp_sharded_matches_single_device(rng):
    # CD with sp=4 within 1e-5 of the port's unsharded CD and of the
    # reference's sp=4 CD
    pred = rng.normal(size=(3000, 3)).astype(np.float32)
    gt = rng.normal(size=(4000, 3)).astype(np.float32)
    single = evaluate_pair(pred, gt, num_points=1024, with_emd=False,
                           device="cpu")
    out = evaluate_pair(pred, gt, num_points=1024, with_emd=False,
                        mesh=tmesh.make_mesh({"sp": 4}, _cpus(4)),
                        device="cpu")
    ref = jevaluate_pair(pred, gt, num_points=1024, with_emd=False,
                         mesh=jmesh.make_mesh({"sp": 4},
                                              jax.devices("cpu")[:4]))
    assert abs(out["cd"] - single["cd"]) < 1e-5
    assert abs(out["cd"] - ref["cd"]) < 1e-5


def test_tp_sharded_dit_forward_matches():
    # the tiny MMDiT with the reference's weights (its flax init under
    # PRNGKey(0)) and every layer in fp32: the port's tp=2 forward within
    # 1e-5 of its unsharded forward, and within 1e-5 of the largest |v|
    # of the reference's tp=2 forward (sums in another order: measured
    # 1.5e-5 of 2.9), with the same number of split layers
    from genpc_tpu.models.dit import DiTConfig as JCfg, MMDiT as JMMDiT
    from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
    import flax.linen as nn
    cfg = JCfg.preset("tiny")
    f32 = jnp.float32
    args = (jnp.zeros((1, 8, 8, cfg.in_channels), f32),
            jnp.full((1,), 0.5, f32), jnp.zeros((1, 16, cfg.text_dim), f32))
    kw = dict(pooled=jnp.zeros((1, cfg.pooled_dim), f32),
              cond_latents=jnp.zeros((1, 8, 8, cfg.cond_channels), f32),
              guidance=jnp.ones((1,), f32))
    tp = tmesh.make_mesh({"tp": 2}, _cpus(2))
    jtp = jmesh.make_mesh({"tp": 2}, jax.devices("cpu")[:2])
    with precision("f32"):
        params = jax.jit(lambda: nn.meta.unbox(JMMDiT(cfg).init(
            jax.random.PRNGKey(0), *args, **kw)))()
        ref, n_ref = jmesh.tp_sharded_dit_forward(jtp)
    jax.clear_caches()
    m = port(MMDiT, DiTConfig.preset("tiny"), kind="dit",
             params=jax.tree.map(np.asarray, params))
    with precision("f32", m):
        got, n = tmesh.tp_sharded_dit_forward(tp, model=m)
        single, _ = tmesh.tp_sharded_dit_forward(
            tmesh.make_mesh({"tp": 1}, _cpus(1)), model=m)
    assert n == n_ref == 40
    assert (got - single).abs().max() <= 1e-5
    close(got, ref, 1e-5)


def test_batched_pose_step_matches():
    # one Adam step at dp=4 over 8 objects on the reference's example:
    # losses and updated parameters within 1e-4 of the reference's step
    # on its dp=4, sp=2 mesh
    mesh = tmesh.make_mesh({"dp": 4, "sp": 2}, _cpus(8))
    step, make_example, shardings = tmesh.batched_pose_step(mesh)
    params, opt, comp, comp_col, partial, size = make_example(
        batch=8, n_complete=128, n_partial=64, render_size=16)
    p_out, o_out, losses = step(*shardings(params, opt, comp, comp_col,
                                           partial), 0.05, size)
    assert len(losses) == 4
    losses = torch.cat(losses).numpy()
    p_out = {k: torch.cat([p[k] for p in p_out]).numpy() for k in params}

    jm = jmesh.make_mesh({"dp": 4, "sp": 2}, devices=jax.devices("cpu"))
    jstep, jexample, jshard = jmesh.batched_pose_step(jm)
    jp, jo, jc, jcc, jpa, _ = jexample(batch=8, n_complete=128,
                                       n_partial=64, render_size=16)
    for a, b in ((comp, jc), (partial, jpa), (params["rot6d"], jp["rot6d"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with jm:
        jpo, _, jl = jax.jit(lambda p, o, c, cc, pa: jstep(
            p, o, c, cc, pa, jnp.float32(0.05), 16))(
            *jshard(jp, jo, jc, jcc, jpa))
    assert losses.shape == (8,) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, np.asarray(jl), atol=1e-4)
    for k in params:
        np.testing.assert_allclose(p_out[k], np.asarray(jpo[k]), atol=1e-4)
    assert np.abs(p_out["rot6d"] - params["rot6d"].numpy()).max() > 0
    assert int(torch.cat([o["count"] for o in o_out]).min()) == 1


@pytest.mark.parametrize("aligned", [False, True])
def test_run_batched_dp_matches_unsharded(tmp_path, monkeypatch, aligned):
    # a tiny run_batched (registration, or the aligned path) with
    # mesh_shape {'dp': 2}: 3 objects padded to 4, every object's CD and
    # EMD equal to the run without a mesh.  The symmetry search (stage
    # 2's cost here) is replaced by one fixed plane in both runs.
    syn = importlib.import_module("genpc_tpu_torch.models.synthetic")
    monkeypatch.setattr(
        syn.SyntheticImage23D, "plan_symmetry_batched",
        staticmethod(lambda pts, **k: [(np.float32([1, 0, 0]), 0.0)]
                     * len(pts)))
    flags = ["01184", "05117", "06127"]
    write_dataset(str(tmp_path), flags, seed=0, n_gt=2048)
    kw = dict(REG, control_model="synthetic", rembg_model="synthetic",
              generative_model="synthetic", view_num=16,
              downsample_num=128, res=32, cam_res=32, generate_res=32,
              input_points=1024, inpaint_iters=5, metric_points=128,
              trust_aligned_completion=aligned)
    single = tbr.run_batched(tload(device="cpu", **kw), flags,
                             str(tmp_path))
    timings = {}
    sharded = tbr.run_batched(tload(device="cpu", mesh_shape={"dp": 2},
                                    **kw), flags, str(tmp_path),
                              timings=timings)
    assert set(single) == set(sharded) == set(flags)
    for f in flags:
        assert single[f] == sharded[f], f
        assert np.isfinite(sharded[f]["cd"])
    assert timings["stage3"] >= 0 and ("reg_pose" in timings) != aligned

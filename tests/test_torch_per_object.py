"""Parity of the port's per-object pipeline (metrics, tracing, exact HPR,
workspace persistence, DepthPrompting.get_depth, registration.reg,
main.run_pipeline) with the JAX reference on the CPU."""

import copy
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu.native
import genpc_tpu_torch.config as tconfig
from genpc_tpu.metrics import metric as jmetric
from genpc_tpu.ops import hpr as jhpr
from genpc_tpu.ops.fps import _fps_indices_xla
from genpc_tpu.ops.outliers import statistical_outlier_mask as jmask
from genpc_tpu_torch.io.synthetic_data import make_object, write_dataset
from genpc_tpu_torch.metrics import metric as tmetric
from genpc_tpu_torch.ops import hpr as thpr
from genpc_tpu_torch.ops.fps_kernel import fps_batched
from genpc_tpu_torch.ops.outliers import statistical_outlier_mask as tmask
from torch_replay import REG_STEP_TOL, held, native_off, tape

FLAGS = ["01184", "05117"]
#: the reference's tiny pipeline config (tests/test_pipeline.py:16-28),
#: without saving, and with the metric's FPS below the fused size (the
#: default 16,384 would leave the two clouds of unequal size for EMD)
TINY = dict(
    save=False, view_num=32, cam_res=64, res=64, generate_res=128,
    downsample_num=512, input_points=2048, pose_iters=8,
    pose_render_size=48, pose_partial_points=512, pose_complete_points=512,
    icp_points=512, fine_scale_steps=3, glb_sample_points=4096,
    fused_points=1500, metric_points=1024, control_model="synthetic",
    rembg_model="synthetic", generative_model="synthetic", inpainter="jax")


def _t(a):
    return torch.as_tensor(np.asarray(a))


#: the registration steps of reg whose results (transforms, scales) are
#: held to the reference step by step, and how the reference's result is
#: handed to the port
REG_STEPS = {
    "object_pose_optimization": lambda out: np.asarray(out),
    "coarse_scale_sweep": lambda out: (out[0], np.asarray(out[1]), out[2]),
    "iterative_scale_search": lambda out: (np.asarray(out[0]), out[1],
                                           np.asarray(out[2])),
    "anisotropic": lambda out: torch.tensor(np.asarray(out))[None],
}

def _reg_step_targets(pkg):
    """(owner, attribute) of each REG_STEPS entry in one package."""
    if pkg == "genpc_tpu":
        jreg = importlib.import_module("genpc_tpu.pipeline.registration")
        jicp = importlib.import_module("genpc_tpu.registration.icp")
        return {"object_pose_optimization": (jreg, "object_pose_optimization"),
                "coarse_scale_sweep": (jreg, "coarse_scale_sweep"),
                "iterative_scale_search": (jreg, "iterative_scale_search"),
                "anisotropic": (jicp, "anisotropic_icp")}
    treg = importlib.import_module("genpc_tpu_torch.pipeline.registration")
    ticp = importlib.import_module("genpc_tpu_torch.registration.icp")
    return {"object_pose_optimization": (treg, "object_pose_optimization"),
            "coarse_scale_sweep": (ticp, "coarse_scale_sweep"),
            "iterative_scale_search": (ticp, "iterative_scale_search"),
            "anisotropic": (treg._REFINE, "anisotropic")}


def _run_pipeline(pkg, cfg, root, tapes):
    """run_pipeline of one package, recording each object's stage-1
    viewpoint and its artifacts as stage 3 receives them.

    The reference's run records, and the port's run replays (``tapes``):
      * the symmetry search of the completion (a model-free stand-in,
        held to the reference in test_torch_pipeline.py);
      * the depth->image generation, whose input carries the standing
        1-ulp raw-depth mismatch (XLA's FMA, ROADMAP queue 3) that its
        uint8 resize turns into colour differences of up to 3e-3;
      * the result of each registration step (REG_STEPS).  The port
        runs every step on its own inputs, which must equal the
        reference's, and its result must agree within REG_STEP_TOL
        (``seen["steps"]``: input and output errors); then the chain
        goes on with the reference's result.  Without the replay, a
        transform that differs at rounding level moves points across
        voxel edges in the host preparation of the next step and
        resamples another subset (ROADMAP queue 3, registration through
        voxel binning), and the fused cloud's FPS can pick another
        sequence from near-tied distances.
    So the whole host chain of reg, the fusion and the metric are held to
    the reference on the same numbers; stage 1 is held by the viewpoints
    here and by test_get_depth_matches_reference; test_reg_matches_reference
    runs reg with no replay."""
    main = importlib.import_module(f"{pkg}.main")
    syn = importlib.import_module(f"{pkg}.models.synthetic")
    seen = {"stage3_in": {}, "fused": {}, "steps": []}
    reg = main.reg
    plan = tape(syn.SyntheticImage23D.plan_symmetry_batched, tapes["plans"])
    generate = tape(syn.SyntheticDepth2Image.generate, tapes["images"])

    def rec_reg(cfg, art, **k):
        seen["stage3_in"][art.flag] = copy.deepcopy(art)
        out = reg(cfg, art, **k)
        seen["fused"][art.flag] = art.fused_xyz
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(plan))
        mp.setattr(syn.SyntheticDepth2Image, "generate", generate)
        mp.setattr(main, "reg", rec_reg)
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        for name, (owner, attr) in _reg_step_targets(pkg).items():
            fn = owner[attr] if isinstance(owner, dict) else \
                getattr(owner, attr)
            step = held(name, fn, tapes["steps"].setdefault(name, []),
                        seen["steps"], REG_STEPS[name])
            if isinstance(owner, dict):
                mp.setitem(owner, attr, step)
            else:
                mp.setattr(owner, attr, step)
        seen["results"] = main.run_pipeline(cfg, FLAGS, root)
    return seen


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic_redwood_per_object"))
    write_dataset(root, FLAGS, seed=0, n_gt=8192)
    return root


@pytest.fixture(scope="module")
def pipelines(dataset):
    tapes = {"plans": [], "images": [], "steps": {}}
    ref = _run_pipeline("genpc_tpu", jconfig.load_config(**TINY), dataset,
                        tapes)
    got = _run_pipeline("genpc_tpu_torch",
                        tconfig.load_config(device="cpu", **TINY), dataset,
                        tapes)
    return ref, got


def test_run_pipeline_matches_reference(pipelines):
    # two synthetic objects, per object: stage 1 (FPS, z-buffer view
    # selection, splat, inpaint), stage 2, reg (8 pose steps at 48², ICP
    # on 512 points, a 3³ fine grid), the metric: the same viewpoints,
    # each registration step within REG_STEP_TOL on the same inputs, CD
    # within 1e-5 absolute, EMD within 2 % relative
    ref, got = pipelines
    assert set(got["results"]) == set(ref["results"]) == set(FLAGS)
    # every step of both objects ran on the reference's inputs
    assert len(got["steps"]) == len(REG_STEPS) * len(FLAGS)
    for name, err_in, err_out in got["steps"]:
        assert err_in == 0.0, name
        assert err_out <= REG_STEP_TOL, name
    for f in FLAGS:
        np.testing.assert_array_equal(got["stage3_in"][f].viewpoint,
                                      ref["stage3_in"][f].viewpoint)
        mj, mt = ref["results"][f], got["results"][f]
        assert np.isfinite(mt["cd"]) and np.isfinite(mt["emd"])
        assert abs(mt["cd"] - mj["cd"]) <= 1e-5
        assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


def test_reg_matches_reference(pipelines, dataset):
    # the port's reg on the reference's stage-2 artifacts of one object:
    # the fused cloud's CD to GT within 1e-5, EMD within 2 %, both scored
    # by the reference's evaluate_pair
    from genpc_tpu.io.ply import load_xyz
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    from genpc_tpu_torch.pipeline.registration import reg
    ref, _ = pipelines
    flag = FLAGS[0]
    src = ref["stage3_in"][flag]
    art = ObjectArtifacts(**{k: copy.deepcopy(v) for k, v in
                             vars(src).items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        reg(tconfig.load_config(device="cpu", **TINY), art,
            cd_inv_weight=0.5, diff_init=True, reg_fine_xyz=True,
            verbose=False)
        gt, _ = load_xyz(os.path.join(dataset, "GT", f"{flag}.ply"))
        mj = jmetric.evaluate_pair(ref["fused"][flag], gt, num_points=1024)
        mt = jmetric.evaluate_pair(art.fused_xyz, gt, num_points=1024)
    assert abs(mt["cd"] - mj["cd"]) <= 1e-5
    assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


def _partial(seed=11, n=2048):
    part, _, _, _ = make_object(seed, n_gt=3 * n)
    idx = np.random.default_rng(0).choice(len(part), n,
                                          replace=len(part) < n)
    return part[idx]


@pytest.mark.parametrize("visibility", ["zbuffer", "hpr"])
def test_get_depth_matches_reference(visibility):
    # viewpoint selection (FPS, then the z-buffer selector or the exact
    # HPR loop over the rig), the best-vs-opposite choice, the splat and
    # the inpaint: the same viewpoint, UVs within 1e-5, hole masks equal,
    # raw depth within 1 ulp on pixels one point hits (queue 3: the
    # reference's scatter has no defined winner on shared pixels)
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.depth_prompting import DepthPrompting as JDP
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts as TArt
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting as TDP
    xyz = _partial()
    rgb = np.random.default_rng(1).uniform(0.1, 1, xyz.shape) \
        .astype(np.float32)
    kw = dict(TINY, visibility=visibility, removal_radius=100.0)
    aj = JDP(jconfig.load_config(**kw)).get_depth(JArt("01184", xyz, rgb))
    at = TDP(tconfig.load_config(device="cpu", **kw)).get_depth(
        TArt("01184", xyz, rgb))
    np.testing.assert_array_equal(at.viewpoint, aj.viewpoint)
    np.testing.assert_allclose(at.point_uv, aj.point_uv, atol=1e-5)
    np.testing.assert_array_equal(at.mask, aj.mask)
    res = TINY["res"]
    pix = np.clip((at.point_uv * res).astype(np.int64)[:, ::-1], 0, res - 1)
    hits = np.zeros((res, res), int)
    np.add.at(hits, (pix[:, 0], pix[:, 1]), 1)
    single = (hits == 1)[::-1]
    assert single.sum() > 100
    np.testing.assert_allclose(at.raw_depth[:, single],
                               aj.raw_depth[:, single], rtol=1.2e-7)


def test_hidden_point_removal_matches():
    # exact Katz HPR, float64 on the host in both: masks equal
    xyz = _partial(seed=12, n=1500)
    eyes = np.array([[1.6, 0.3, 0.0], [0.0, -1.6, 0.2], [-0.9, 0.9, 0.9]])
    for eye in eyes:
        np.testing.assert_array_equal(
            thpr.hidden_point_removal(xyz, eye, 100.0),
            jhpr.hidden_point_removal(xyz, eye, 100.0))
    np.testing.assert_array_equal(
        thpr.visible_points(xyz, eyes, 100.0, method="hpr"),
        jhpr.visible_points(xyz, eyes, 100.0, method="hpr"))


def test_completion_loss_and_evaluate_pair_match():
    # CD within 1e-5 absolute, EMD within 2 % relative (a near-tied bid
    # can send the auction down another path)
    from genpc_tpu.metrics.losses import CompletionLoss as JLoss
    from genpc_tpu_torch.metrics.losses import CompletionLoss as TLoss
    r = np.random.default_rng(2)
    p = r.random((600, 3)).astype(np.float32)
    g = (r.random((600, 3)) * 0.9 + 0.05).astype(np.float32)
    for name in ("cd_l1", "cd_l2", "emd"):
        lj = float(JLoss(name).get_loss(jnp.asarray(p), jnp.asarray(g)))
        lt = float(TLoss(name).get_loss(_t(p), _t(g)))
        tol = 0.02 * lj if name == "emd" else 1e-5
        assert abs(lt - lj) <= tol, name
    pred = r.random((900, 3)).astype(np.float32)
    gt = r.random((1300, 3)).astype(np.float32)
    mj = jmetric.evaluate_pair(pred, gt, num_points=512)
    mt = tmetric.evaluate_pair(pred, gt, num_points=512, device="cpu")
    assert abs(mt["cd"] - mj["cd"]) <= 1e-5
    assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]
    # a mesh sampled (bit-equal draws), fitted into the GT's box, scored
    from genpc_tpu.io.glb import Mesh as JMesh
    from genpc_tpu_torch.io.glb import Mesh as TMesh
    v = r.random((40, 3)).astype(np.float32)
    f = r.integers(0, 40, (60, 3)).astype(np.int32)
    c = r.random((40, 3)).astype(np.float32)
    for kw in ({}, {"normalize_by_gt_bbox": False, "with_emd": True}):
        mj = jmetric.evaluate_mesh(JMesh(v, f, c), gt, num_points=512, **kw)
        mt = tmetric.evaluate_mesh(TMesh(v, f, c), gt, num_points=512,
                                   device="cpu", **kw)
        assert set(mt) == set(mj)
        assert abs(mt["cd"] - mj["cd"]) <= 1e-5
        if "emd" in mj:
            assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


def test_uhd_matches():
    r = np.random.default_rng(3)
    part = r.random((700, 3)).astype(np.float32)
    comp = r.random((2000, 3)).astype(np.float32)
    for pct in (100.0, 95.0):
        assert abs(tmetric.uhd(part, comp, pct, device="cpu")
                   - jmetric.uhd(part, comp, pct)) <= 1e-6


def _ped_cloud(seed=13, unique=400, n=4096):
    """A PED-sized scan drawn with replacement, as run_batched_lidar draws
    PED scans up to input_points: every point repeats ~10 times."""
    r = np.random.default_rng(seed)
    base = _partial(seed, n=unique)
    return base[r.choice(unique, n, replace=True)]


def test_fps_at_the_ped_duplicate_shape_matches():
    # 400 unique points drawn to 4,096, k = 1,024: after the first 400
    # picks every minimum distance is 0, a tie at every pick; the plain
    # twin must give the reference's sequence exactly
    pts = _ped_cloud()
    got = fps_batched(_t(pts)[None], 1024)[0].numpy()
    want = np.asarray(_fps_indices_xla(jnp.asarray(pts), 1024))
    np.testing.assert_array_equal(got, want)


def test_outlier_mask_at_the_ped_duplicate_shape_matches():
    # with 20 neighbours and ~10 copies of each point, many per-point
    # means tie and sigma is small: the masks must be equal
    pts = _ped_cloud()
    np.testing.assert_array_equal(
        tmask(_t(pts), 20, 2.5).numpy(),
        np.asarray(jmask(jnp.asarray(pts), 20, 2.5)))


def test_workspace_round_trip_and_cross_load(pipelines, tmp_path):
    # every file the stages write, under the reference's names: the
    # port's workspace reloads its own files, and each package loads the
    # other's to the same arrays
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.artifacts import Workspace as JWs
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts as TArt
    from genpc_tpu_torch.pipeline.artifacts import Workspace as TWs
    _, got = pipelines
    art = copy.deepcopy(got["stage3_in"][FLAGS[0]])
    art.fused_xyz = art.color_xyz[:300]
    art.fused_rgb = art.color_rgb[:300]
    tws = TWs(str(tmp_path / "t"), "synthetic")
    jws = JWs(str(tmp_path / "j"), "synthetic")
    for ws in (tws, jws):
        ws.save_stage1(art)
        ws.save_stage2(art)
        ws.save_fused(art)
    assert sorted(os.listdir(tws.dir(art.flag))) == \
        sorted(os.listdir(jws.dir(art.flag)))
    own = tws.load_stage2(art.flag, tws.load_stage1(art.flag))
    np.testing.assert_array_equal(own.point_uv, art.point_uv)
    np.testing.assert_array_equal(own.viewpoint, art.viewpoint)
    np.testing.assert_allclose(own.depth, art.depth, atol=1 / 255 + 1e-6)
    np.testing.assert_allclose(own.color_xyz, art.color_xyz, atol=1e-7)
    np.testing.assert_allclose(own.complete_xyz, art.complete_xyz,
                               atol=1e-7)
    for a, b in ((tws, JWs(jws.root, "synthetic")),
                 (TWs(jws.root, "synthetic"), jws)):
        ta = a.load_stage2(art.flag, a.load_stage1(art.flag, TArt(art.flag)))
        jb = b.load_stage2(art.flag, b.load_stage1(art.flag, JArt(art.flag)))
        for k in ("point_uv", "viewpoint", "depth", "image", "color_xyz",
                  "color_rgb", "complete_xyz", "complete_rgb"):
            np.testing.assert_array_equal(getattr(ta, k), getattr(jb, k),
                                          err_msg=k)
    from genpc_tpu.io.ply import load_ply
    fused, _ = load_ply(tws.fused_path(art.flag))
    np.testing.assert_allclose(fused, art.fused_xyz, atol=1e-7)


def test_load_xyz_down_sample_matches(tmp_path):
    # the voxel downsample of load_xyz, the reference pinned to the numpy
    # algorithm: equal points and colours
    from genpc_tpu.io.ply import load_xyz as jload
    from genpc_tpu_torch.io.ply import load_xyz as tload, save_ply
    part, rgb, _, _ = make_object(14, n_gt=6000)
    path = str(tmp_path / "scan.ply")
    save_ply(path, part, rgb)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        pj, cj = jload(path, down_sample=0.05)
    pt, ct = tload(path, down_sample=0.05)
    assert len(pt) < len(part)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)


def test_stage_timer_and_trace(tmp_path):
    # nested spans as in the reference, on the recorder; trace() writes a
    # Chrome trace that holds each span as a range
    import json
    import time
    from genpc_tpu_torch.tracing import recording, span, trace
    with trace(str(tmp_path / "prof")), recording() as rec:
        with span("a"):
            with span("b"):
                time.sleep(0.01)
                torch.ones(8).sum()
    d = {s.path: s for s in rec.spans}
    assert set(d) == {"a", "a/b"} and d["a/b"].parent == "a"
    assert d["a"].seconds >= d["a/b"].seconds >= 0.01
    assert rec.flat()["a"] == d["a"].seconds
    path = tmp_path / "prof" / "trace.json"
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"a", "b"} <= names

"""Parity of the port's pipeline (config, generation backends, fusion,
metric, run_batched end to end) with the JAX reference on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu_torch.io.synthetic_data import make_object, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["01184", "05117"]
#: the tiny run_batched config of test_parallel.py:194-202, with 4096
#: input points instead of 1024: the symmetry search samples 4096 points
#: per object, and padding 1024 up to 4096 by repetition leaves no plane
#: acceptable, so the mirror completion would never run
TINY = dict(
    save=False, output_path="/tmp/test_ws_rb",
    control_model="synthetic", rembg_model="synthetic",
    generative_model="synthetic", trust_aligned_completion=True,
    view_num=16, downsample_num=256, res=64, cam_res=64,
    generate_res=64, input_points=4096, inpaint_iters=10,
    glb_sample_points=512, pose_complete_points=64, icp_points=64,
    pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _recorded_run(pkg, cfg, root, plans=None):
    """run_batched of one package, recording the symmetry plans and the
    stage-1 viewpoints it computes on the way.  With ``plans`` given, the
    symmetry search returns them instead of searching again."""
    import importlib
    br = importlib.import_module(f"{pkg}.parallel.batched_runner")
    syn = importlib.import_module(f"{pkg}.models.synthetic")
    seen = {}
    plan = syn.SyntheticImage23D.plan_symmetry_batched
    stage1 = br.batched_stage1

    def rec_plan(*a, **k):
        seen["plans"] = plan(*a, **k) if plans is None else plans
        return seen["plans"]

    def rec_stage1(cfg, arts, *a, **k):
        stage1(cfg, arts, *a, **k)
        seen["viewpoints"] = np.stack([x.viewpoint for x in arts])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(rec_plan))
        mp.setattr(br, "batched_stage1", rec_stage1)
        seen["results"] = br.run_batched(cfg, FLAGS, root, with_emd=True)
    return seen


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic_redwood"))
    write_dataset(root, FLAGS, seed=0, n_gt=8192)
    return root


@pytest.fixture(scope="module")
def runs(dataset):
    ref = _recorded_run("genpc_tpu", jconfig.load_config(**TINY), dataset)
    got = _recorded_run("genpc_tpu_torch",
                        tconfig.load_config(device="cpu", **TINY), dataset)
    return ref, got


@pytest.fixture(scope="module")
def reg_runs(dataset, runs):
    """Both packages' run_batched with registration on (the headline
    path) over the same objects, the reference's voxel downsample pinned
    to its numpy algorithm (its native helper emits another voxel order,
    ROADMAP queue 3).  Stages 1-2 do not depend on the registration
    switch, so each package's symmetry search replays the plans of its
    own aligned run (compared in test_plan_symmetry_batched_plans_match)
    instead of searching again."""
    import genpc_tpu.native

    def native_off(*_a, **_k):
        raise RuntimeError("native voxel helper pinned off")

    cfg = dict(TINY, trust_aligned_completion=False)
    ref_aligned, got_aligned = runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        ref = _recorded_run("genpc_tpu", jconfig.load_config(**cfg), dataset,
                            plans=ref_aligned["plans"])
    got = _recorded_run("genpc_tpu_torch",
                        tconfig.load_config(device="cpu", **cfg), dataset,
                        plans=got_aligned["plans"])
    return ref, got


def test_run_batched_registration_matches_reference(reg_runs):
    # registration on, end to end on 2 synthetic objects (3 pose steps at
    # 32², ICP on 64 points, a 2³ fine grid): the same viewpoints,
    # per-object CD within 1e-5 absolute (measured: equal, and 5.2e-8),
    # EMD within 2 % relative (measured: equal, and 0.37 %)
    ref, got = reg_runs
    np.testing.assert_array_equal(got["viewpoints"], ref["viewpoints"])
    assert set(got["results"]) == set(ref["results"]) == set(FLAGS)
    for f in FLAGS:
        mj, mt = ref["results"][f], got["results"][f]
        assert np.isfinite(mt["cd"]) and np.isfinite(mt["emd"])
        assert abs(mt["cd"] - mj["cd"]) <= 1e-5
        assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


def test_plan_symmetry_batched_plans_match(runs):
    # the plans decide the completion: the same azimuth and offset index,
    # i.e. the same normal and offset values, and a plane for each object
    ref, got = runs
    assert all(p is not None for p in ref["plans"])
    for (nj, cj), (nt, ct) in zip(ref["plans"], got["plans"]):
        np.testing.assert_array_equal(nt, nj)
        assert ct == cj


def test_run_batched_matches_reference(runs):
    # end to end on 2 synthetic objects: the same viewpoints, per-object
    # CD within 1e-5 absolute; EMD within 2 % relative, because a near-tied
    # bid that rounds differently sends the auction down another path
    # (measured here: equal CDs, EMDs within 2e-7 relative)
    ref, got = runs
    np.testing.assert_array_equal(got["viewpoints"], ref["viewpoints"])
    assert set(got["results"]) == set(ref["results"]) == set(FLAGS)
    for f in FLAGS:
        mj, mt = ref["results"][f], got["results"][f]
        assert np.isfinite(mt["cd"]) and np.isfinite(mt["emd"])
        assert abs(mt["cd"] - mj["cd"]) <= 1e-5
        assert abs(mt["emd"] - mj["emd"]) <= 0.02 * mj["emd"]


def test_fuse_clouds_matches():
    # dedup, FPS and the outlier mask are all exact: equal outputs
    from genpc_tpu.registration.fusion import fuse_clouds as jfuse
    from genpc_tpu_torch.registration.fusion import fuse_clouds as tfuse
    part, part_rgb, gt, gt_rgb = make_object(3, n_gt=6000)
    r = np.random.default_rng(0)
    src = part[r.choice(len(part), 1500, replace=False)]
    pj, cj = jfuse(src, gt, np.full_like(src, 0.5), gt_rgb,
                   num_points=1000)
    pt, ct = tfuse(src, gt, np.full_like(src, 0.5), gt_rgb,
                   num_points=1000, device="cpu")
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(ct, cj)


def test_fuse_clouds_batched_matches_per_object():
    # three objects, one of them below num_points after the dedup (no
    # FPS): one batched FPS over the other two gives, point for point and
    # colour for colour, the per-object fusion of the port and of the
    # reference
    from genpc_tpu.registration.fusion import fuse_clouds as jfuse
    from genpc_tpu_torch.registration.fusion import (fuse_clouds,
                                                     fuse_clouds_batched)
    r = np.random.default_rng(4)
    srcs, tgts, src_cols, tgt_cols = [], [], [], []
    for seed, n_src, n_tgt in ((5, 1500, 6000), (6, 200, 500),
                               (7, 1200, 4000)):
        part, _, gt, gt_rgb = make_object(seed, n_gt=n_tgt)
        srcs.append(part[r.choice(len(part), n_src, replace=False)])
        src_cols.append(r.random((n_src, 3)).astype(np.float32))
        tgts.append(gt)
        tgt_cols.append(gt_rgb)
    got = fuse_clouds_batched(srcs, tgts, src_cols, tgt_cols,
                              num_points=1000, device="cpu")
    assert len(got) == 3
    assert len(srcs[1]) + len(tgts[1]) < 1000
    for i, (pt, ct) in enumerate(got):
        pa, ca = fuse_clouds(srcs[i], tgts[i], src_cols[i], tgt_cols[i],
                             num_points=1000, device="cpu")
        pj, cj = jfuse(srcs[i], tgts[i], src_cols[i], tgt_cols[i],
                       num_points=1000)
        for a, b in ((pt, pa), (ct, ca), (pt, pj), (ct, cj)):
            np.testing.assert_array_equal(a, b)


def test_batched_metric_sampled_matches():
    # CD: exact NN, mean order only (rtol 1e-6); EMD: 1e-3 relative, as
    # in test_torch_ops
    from genpc_tpu.parallel.batched_runner import \
        batched_metric_sampled as jmetric
    from genpc_tpu_torch.parallel.batched_runner import \
        batched_metric_sampled as tmetric
    r = np.random.default_rng(1)
    p = r.random((2, 400, 3)).astype(np.float32)
    g = r.random((2, 400, 3)).astype(np.float32)
    cdj, emdj = jmetric(jnp.asarray(p), jnp.asarray(g))
    cdt, emdt = tmetric(_t(p), _t(g))
    np.testing.assert_allclose(cdt.numpy(), np.asarray(cdj), rtol=1e-6)
    np.testing.assert_allclose(emdt.numpy(), np.asarray(emdj), rtol=1e-3)


def test_config_and_rig_cross_over():
    # the same DEFAULTS (device is the port's real device key), the same
    # merged redwood values, and the same camera rig
    from genpc_tpu.pipeline.depth_prompting import DepthPrompting as JDP
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting
    assert tconfig.DEFAULTS["device"] == "cuda"
    strip = lambda d: {k: v for k, v in d.items() if k != "device"}  # noqa
    assert strip(tconfig.DEFAULTS) == strip(jconfig.DEFAULTS)
    path = os.path.join(REPO, "configs", "redwood.yaml")
    assert strip(tconfig.load_config(path)) == strip(jconfig.load_config(path))
    dj = JDP(jconfig.load_config(path))
    dt = DepthPrompting(tconfig.load_config(path, device="cpu"))
    np.testing.assert_array_equal(dt.viewpoints, dj.viewpoints)
    np.testing.assert_allclose(dt.cameras.rot.numpy(),
                               np.asarray(dj.cameras.rot), atol=1e-6)


@pytest.mark.parametrize("n", [300, 1000, 2500])
def test_resample_fixed_matches(n):
    from genpc_tpu.pipeline.registration import resample_fixed as jres
    from genpc_tpu_torch.pipeline.registration import resample_fixed as tres
    r = np.random.default_rng(2)
    pts = r.random((1000, 3)).astype(np.float32)
    cols = r.random((1000, 3)).astype(np.float32)
    for a, b in zip(tres(pts, n, cols), jres(pts, n, cols)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_depth2image_matches():
    # the port resizes with torch instead of PIL: colours only, within
    # 2/255 (PIL rounds its fixed-point bilinear to uint8 on its own)
    from genpc_tpu.models.synthetic import SyntheticDepth2Image as J
    from genpc_tpu_torch.models.synthetic import SyntheticDepth2Image as T
    r = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:64] / 63.0
    d = np.clip(0.9 - (xx - 0.5) ** 2 - (yy - 0.4) ** 2
                + 0.02 * r.random((64, 64)), 0, 1)
    d[:, :8] = 0.0                              # background
    depth = np.repeat(d[None], 3, 0).astype(np.float32)
    a = T().generate(depth, "01184", size=128)
    b = J().generate(depth, "01184", size=128)
    np.testing.assert_allclose(a, b, atol=2 / 255)


def test_import_leaves_jax_out():
    # the port and every module in it, the per-object and Waymo entry
    # points, the generative models, the device mesh and the toolkit
    # modules among them, import no jax (only tests do)
    code = (
        "import importlib, pkgutil, sys\n"
        "import genpc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'genpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['main', 'main_lidar', 'metrics.metric', 'tracing',\n"
        "        'pipeline.artifacts', 'pipeline.depth_prompting',\n"
        "        'pipeline.registration', 'pipeline.scale_adapter',\n"
        "        'models.layers', 'models.schedulers', 'models.vae',\n"
        "        'models.text_encoder', 'models.unet', 'models.adapter',\n"
        "        'models.controlnet_depth', 'models.weights',\n"
        "        'models.lrm', 'models.graphs', 'models.backends',\n"
        "        'models.dit', 'models.qwen_vl', 'models.dit_depth',\n"
        "        'models.birefnet', 'models.rmbg', 'models.trellis',\n"
        "        'models.sf3d', 'models.ddnm', 'render.inpaint',\n"
        "        'io.glb', 'ops.marching', 'parallel.mesh',\n"
        "        'geometry.sh', 'geometry.densify', 'geometry.mesh_utils',\n"
        "        'render.image_ops', 'metrics.image_metrics',\n"
        "        'models.segmentation', 'metric_cli', 'vis',\n"
        "        'utils_logging']\n"
        "missing = [n for n in need if 'genpc_tpu_torch.' + n\n"
        "           not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'genpc_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def test_every_port_test_file_pins_one_thread():
    # the thread pin is written once (tests/torch_threads.py); every port
    # test file imports it and none sets the thread count itself
    files = sorted(Path(REPO, "tests").glob("test_torch_*.py"))
    assert files
    unpinned, own = [], []
    for f in files:
        tree = ast.parse(f.read_text())
        if not any(isinstance(n, ast.ImportFrom)
                   and n.module == "torch_threads"
                   and any(a.name == "one_torch_thread" for a in n.names)
                   for n in tree.body):
            unpinned.append(f.name)
        if any(isinstance(n, ast.Attribute) and n.attr == "set_num_threads"
               for n in ast.walk(tree)):
            own.append(f.name)
    assert not unpinned, f"no torch_threads.one_torch_thread: {unpinned}"
    assert not own, f"sets torch's thread count itself: {own}"

"""Parity of the port's Waymo LiDAR path (run_batched_lidar with the UHD,
the held-out wedge and the fusion attribution; list_scans) with the JAX
reference on the CPU, on generated LiDAR-like scans."""

import importlib
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu.native
import genpc_tpu_torch.config as tconfig
from genpc_tpu_torch.io.synthetic_data import (LIDAR_POINTS,
                                               write_lidar_dataset)
from torch_replay import REG_STEP_TOL, held, native_off, tape

#: the tiny run_batched config of test_torch_pipeline.py, with stage 1's
#: FPS above a PED scan's unique points (~350-500 drawn to 4,096), so
#: that its later picks are all ties, as at the full config
TINY = dict(
    save=False, control_model="synthetic", rembg_model="synthetic",
    generative_model="synthetic", trust_aligned_completion=True,
    view_num=16, downsample_num=1024, res=64, cam_res=64,
    generate_res=64, input_points=4096, inpaint_iters=10,
    glb_sample_points=512, pose_complete_points=64, icp_points=64,
    pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)
COUNTS = {"CAR": 2, "PED": 2}
#: the batched registration steps held to the reference step by step
#: (see _run), and how the reference's result is handed to the port
REG_STEPS = {
    "batched_pose_optim": lambda out: torch.tensor(np.asarray(out)),
    "batched_coarse_sweep": lambda out: tuple(torch.tensor(np.asarray(o))
                                              for o in out),
    "batched_fine_search": lambda out: tuple(np.asarray(o) for o in out),
    "batched_similarity_refine": lambda out: torch.tensor(np.asarray(out)),
}


def _run(pkg, cfg, root, category, tapes, **kw):
    """run_batched_lidar of one package.  The reference's run records and
    the port's replays the model-free stand-ins (the symmetry search and
    the depth->image generation, as in test_torch_per_object.py) and the
    result of each registration step; the port runs each step on its own
    inputs, which must equal the reference's, and its result must agree
    within REG_STEP_TOL (``steps``), then the chain goes on with the
    reference's result (a rounding-level transform change would move
    points across voxel edges in the next step's host preparation,
    ROADMAP queue 3).  Returns (results, steps)."""
    br = importlib.import_module(f"{pkg}.parallel.batched_runner")
    syn = importlib.import_module(f"{pkg}.models.synthetic")
    steps = []
    if tapes["plans"] is None:
        def plan(pts_list, *_a, **_k):
            return [None] * len(pts_list)
    else:
        plan = tape(syn.SyntheticImage23D.plan_symmetry_batched,
                    tapes["plans"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(plan))
        mp.setattr(syn.SyntheticDepth2Image, "generate",
                   tape(syn.SyntheticDepth2Image.generate, tapes["images"]))
        mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
        for name, convert in REG_STEPS.items():
            mp.setattr(br, name, held(name, getattr(br, name),
                                      tapes["steps"].setdefault(name, []),
                                      steps, convert))
        out = br.run_batched_lidar(cfg, FLAGS[category], root, category,
                                   **kw)
    return out, steps


FLAGS = {}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic_waymo"))
    FLAGS.update(write_lidar_dataset(root, COUNTS, seed=0))
    return root


def _both(root, category, aligned, debug=False, mirror=True, **kw):
    """Both packages' run_batched_lidar over one category; with debug,
    also their fusion attributions.  With mirror False both packages'
    symmetry searches find no plane, so the completion is the partial
    densified by jitter: the search (held to the reference in
    test_torch_pipeline.py) takes ~50 s a batch in the reference on the
    CPU, and one run with it is enough here."""
    tapes = {"plans": [] if mirror else None, "images": [], "steps": {}}
    cfg = dict(TINY, trust_aligned_completion=aligned)
    dj, dt = ({}, {}) if debug else (None, None)
    ref, _ = _run("genpc_tpu", jconfig.load_config(**cfg), root, category,
                  tapes, fusion_debug=dj, **kw)
    got, steps = _run("genpc_tpu_torch",
                      tconfig.load_config(device="cpu", **cfg), root,
                      category, tapes, fusion_debug=dt, **kw)
    return ref, got, steps, dj, dt


@pytest.fixture(scope="module")
def car_registered(dataset):
    """CAR scans with registration on and the fusion attribution."""
    return _both(dataset, "CAR", False, debug=True)


def _check_uhd(ref, got):
    """The same flags and keys; UHD and held-out UHD within 1e-5."""
    assert set(got) == set(ref) and ref
    for f in ref:
        assert set(got[f]) == set(ref[f]), f
        for k in ref[f]:
            assert np.isfinite(got[f][k])
            assert abs(got[f][k] - ref[f][k]) <= 1e-5, (f, k)


def test_run_batched_lidar_registered_matches(car_registered):
    # CAR scans, registration on (3 pose steps, ICP on 64 points, a 2³
    # grid): every registration step on the reference's inputs within
    # REG_STEP_TOL, then the partial->fused UHD within 1e-5
    ref, got, steps, _, _ = car_registered
    assert [s[0] for s in steps] == list(REG_STEPS)
    for name, err_in, err_out in steps:
        assert err_in == 0.0, name
        assert err_out <= REG_STEP_TOL, name
    _check_uhd(ref, got)


def test_fusion_debug_matches(car_registered):
    # the fusion attribution (registration residual, UHD to the
    # concatenation, to the FPS sample and to the fused cloud, the
    # partial's share after the FPS, the outlier mask's survival): the
    # same keys, values within 1e-3 (they are rounded to 3-4 digits)
    _, _, _, dj, dt = car_registered
    assert set(dt) == set(dj) == set(FLAGS["CAR"])
    for f in dj:
        assert set(dt[f]) == set(dj[f]), f
        for k, v in dj[f].items():
            if v is None:
                assert dt[f][k] is None, (f, k)
            else:
                assert abs(dt[f][k] - v) <= 1e-3, (f, k)


@pytest.mark.parametrize("category,wedge", [("PED", 0.0), ("CAR", 60.0),
                                            ("PED", 60.0)])
def test_run_batched_lidar_aligned_matches(dataset, category, wedge):
    # the aligned path (stage 1 with PED's all-tie FPS picks, stage 2
    # without the mirror, fusion, the UHD), plain and with a 60° held-out
    # wedge: the same held-out flags, UHD and held-out UHD within 1e-5
    ref, got, steps, _, _ = _both(dataset, category, True, mirror=False,
                                  holdout_wedge_deg=wedge)
    assert not steps
    _check_uhd(ref, got)
    held = [f for f in ref if "holdout_uhd" in ref[f]]
    assert bool(held) == (wedge > 0)


def test_lidar_scans_and_list_scans(dataset):
    # the generated scans: sizes within each category's range; the
    # listing of both packages equal, sorted, and cut by limit
    from genpc_tpu.main_lidar import list_scans as jlist
    from genpc_tpu_torch.io.ply import load_xyz
    from genpc_tpu_torch.main_lidar import list_scans as tlist
    for category, flags in FLAGS.items():
        assert tlist(dataset, category) == jlist(dataset, category) == flags
        assert tlist(dataset, category, limit=1) == flags[:1]
        lo, hi = LIDAR_POINTS[category]
        for f in flags:
            pts, _ = load_xyz(f"{dataset}/{category}/{f}.ply")
            assert lo <= len(pts) < hi


def test_run_lidar_split_workflow(dataset, tmp_path):
    # main_lidar.run_lidar --stage 1 saves each scan's stage-1 files, and
    # --stage 2 resumes from them (the reference's split workflow): a
    # finite UHD a scan, and the reference's workspace file names
    from genpc_tpu_torch.main_lidar import run_lidar
    cfg = tconfig.load_config(
        device="cpu", **dict(TINY, save=True, output_path=str(tmp_path),
                             trust_aligned_completion=False,
                             pose_partial_points=64, fused_points=512))
    flags = FLAGS["CAR"][:1]
    with pytest.MonkeyPatch.context() as mp:
        syn = importlib.import_module("genpc_tpu_torch.models.synthetic")
        mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
                   staticmethod(lambda pts, *a, **k: [None] * len(pts)))
        assert run_lidar(cfg, flags, dataset, "CAR", stage="1") == {}
        out = run_lidar(cfg, flags, dataset, "CAR", stage="2")
    assert set(out) == set(flags) and np.isfinite(out[flags[0]])
    files = set(os.listdir(tmp_path / flags[0]))
    assert {"depth.png", "img.png", "point_uv.npy", "viewpoint.npy",
            "color_point.ply", f"{flags[0]}_synthetic.ply",
            f"{flags[0]}_fused.ply"} <= files


@pytest.mark.parametrize("module,args", [
    ("genpc_tpu_torch.main", []),
    ("genpc_tpu_torch.main", ["--batched"]),
    ("genpc_tpu_torch.main_lidar", ["--config", "absent.yaml"]),
])
def test_entry_points_run_on_the_card_unless_asked(dataset, module, args):
    # with no --device the CLIs ask for the card; on a machine without
    # one they raise instead of falling back to the CPU
    mod = importlib.import_module(module)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(["--data-dir", dataset] + args)

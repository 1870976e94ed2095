"""BASELINE config 5 at tiny widths on the CPU: the port's
run_batched_lidar with FLUX generating the images, RMBG-2.0 matting them
and TRELLIS lifting them to meshes (the reference's Waymo deployment:
configs/lidar.yaml's control and generative models), held against the
reference's run_batched_lidar on the same generated CAR scans, weights
and draws.

Every model computes in fp32 on both sides (torch_models_ref.precision).
Stage 1's depths differ from the reference's at pixels where points
collide (test_torch_stage1.py), so each package's FLUX images are held to
the bf16 image bound and the reference's images then go on into both
packages' stage 2.  The mattes and the TRELLIS draws are then the same,
so the meshes must be equal (face corners within 1e-4); the reference's
meshes go on into both packages' registration, whose steps are held one
by one (torch_replay.held), and the UHD must agree within 1e-5.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
import torch_flux_ref as fr
from torch_models_ref import precision, ref_params
from torch_replay import REG_STEP_TOL, held, hold_coarse_sweep, native_off
from torch_threads import one_torch_thread  # noqa: F401
from torch_trellis_ref import ref_trellis_draws, trellis_backends

import genpc_tpu.config as jconfig
import genpc_tpu.native
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models import birefnet as jb
from genpc_tpu.models.dit_depth import DiTDepthEdit as JDiT
from genpc_tpu.models.rmbg import RMBGMatting as JRMBG
from genpc_tpu_torch.io.synthetic_data import write_lidar_dataset
from genpc_tpu_torch.models import weights as tw
from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
from genpc_tpu_torch.models.rmbg import RMBGMatting

#: test_torch_lidar.py's tiny Waymo config, registration on, with
#: config 5's backends
TINY = dict(
    save=False, control_model="flux", rembg_model="rmbg",
    generative_model="trellis", trust_aligned_completion=False,
    view_num=16, downsample_num=1024, res=fr.SIZE, cam_res=64,
    generate_res=fr.SIZE, input_points=4096, inpaint_iters=10,
    glb_sample_points=512, pose_complete_points=64, icp_points=64,
    pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)
REG_STEPS = ("batched_pose_optim", "batched_coarse_sweep",
             "batched_fine_search", "batched_similarity_refine")


def _convert(name):
    if name == "batched_fine_search":
        return lambda out: tuple(np.asarray(o) for o in out)
    if name == "batched_coarse_sweep":
        return lambda out: tuple(torch.tensor(np.asarray(o)) for o in out)
    return lambda out: torch.tensor(np.asarray(out))


def _run(pkg, cfg, root, flags, backends, tapes, mp):
    """run_batched_lidar of one package with its three backends injected,
    recording its images and meshes.  The reference's run records the
    images and registration steps; the port's run hands the recorded
    images to stage 2 and holds each registration step."""
    br = importlib.import_module(f"{pkg}.parallel.batched_runner")
    dpm = importlib.import_module(f"{pkg}.pipeline.depth_prompting")
    sam = importlib.import_module(f"{pkg}.pipeline.scale_adapter")
    gen_b, rembg_b, i23_b = backends
    mp.setattr(dpm, "get_depth2image", lambda name, cfg: gen_b)
    mp.setattr(sam, "get_rembg", lambda name, cfg: rembg_b)
    mp.setattr(sam, "get_image23d", lambda name, cfg: i23_b)
    mp.setattr(genpc_tpu.native, "voxel_down_sample_native", native_off)
    images, meshes, steps = [], [], []
    gen = br._generate_images

    def recording(cfg, dp, arts):
        gen(cfg, dp, arts)
        images.extend(np.array(a.image) for a in arts)
        if tapes["images"]:
            for a, im in zip(arts, tapes["images"]):
                a.image = im
        else:
            tapes["images"].extend(images)

    batch = i23_b.generate_meshes_batch
    mesh_cls = importlib.import_module(f"{pkg}.io.glb").Mesh

    def meshes_of(flags, imgs):
        out = batch(flags, imgs)
        meshes.extend(out)
        if not tapes["meshes"]:
            tapes["meshes"].extend(out)
            return out
        return [mesh_cls(m.vertices, m.faces, m.vertex_colors)
                for m in tapes["meshes"]]

    mp.setattr(br, "_generate_images", recording)
    mp.setattr(i23_b, "generate_meshes_batch", meshes_of)
    for name in REG_STEPS:
        mp.setattr(br, name, held(name, getattr(br, name),
                                  tapes["steps"].setdefault(name, []),
                                  steps, _convert(name)))
    out = br.run_batched_lidar(cfg, flags, root, "CAR")
    return out, images, meshes, steps


def test_config5_tiny_matches_the_reference(tmp_path):
    """Two generated CAR scans through both packages' run_batched_lidar
    (FLUX -> RMBG -> TRELLIS, registration on): the port's FLUX images
    within the bf16 image bound of the reference's, the same TRELLIS
    meshes (face corners and colours within 1e-4), every registration
    step on equal inputs within REG_STEP_TOL (the coarse ICP sweep
    scan by scan, where a scan's candidate may part only at a printed
    Kabsch tie), and each scan's UHD within 1e-5; the port frees its
    three backends."""
    flags = write_lidar_dataset(str(tmp_path), {"CAR": 2}, seed=0)["CAR"]
    trees = fr.trees(0)
    jgen = JDiT(fr.cfg("ref", **TINY), variant="flux")
    fr.install_ref(jgen, trees)
    tgen = DiTDepthEdit(fr.cfg("port", **TINY), variant="flux")
    fr.install_port(tgen, trees)
    lat = fr.reference_draws(jgen, 2)
    bcfg = jb.BiRefNetConfig.preset("tiny")
    s = bcfg.img_size
    btree = ref_params(lambda: jb.BiRefNet(bcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, s, s, 3), np.float32)), 70)
    btree["batch_stats"] = jax.tree.map(np.ones_like, btree["batch_stats"])
    jrm = JRMBG.__new__(JRMBG)
    jrm.cfg, jrm.net_cfg, jrm.params = {}, bcfg, btree
    jrm.net = jb.BiRefNet(bcfg)
    trm = RMBGMatting(tconfig.load_config(device="cpu", model_size="tiny"))
    trm.init_params(tw.from_flax("birefnet", btree, trm.net))
    jtr, ttr = trellis_backends(seed=71)
    _, _, sn, ln = ref_trellis_draws(jtr.rng, 2, jtr.tc)
    tapes = {"images": [], "meshes": [], "steps": {}}
    port_modules = [*tgen.models().values(), trm.net, ttr.net]
    jax.clear_caches()
    with precision("f32", *port_modules), \
            pytest.MonkeyPatch.context() as mp:
        jrm._apply = jax.jit(jrm.net.apply)
        ref, rimgs, rmeshes, _ = _run(
            "genpc_tpu", jconfig.load_config(model_size="tiny", **TINY),
            str(tmp_path), flags, (jgen, jrm, jtr), tapes, mp)
        mp.setattr(tgen, "draws", lambda b, hw: lat)
        mp.setattr(ttr, "draws", lambda b: (sn, ln))
        got, gimgs, gmeshes, steps = _run(
            "genpc_tpu_torch", tconfig.load_config(
                device="cpu", model_size="tiny", **TINY),
            str(tmp_path), flags, (tgen, trm, ttr), tapes, mp)
    jax.clear_caches()
    assert len(gimgs) == len(rimgs) == 2
    for a, b in zip(gimgs, rimgs):
        assert a.shape == b.shape == (fr.SIZE, fr.SIZE, 3)
        assert np.abs(a - b).max() <= fr.IMAGE_TOL["bf16"]
    assert len(gmeshes) == len(rmeshes) == 2
    for m, jm in zip(gmeshes, rmeshes):
        assert len(m.faces) == len(jm.faces)
        for x, y in ((m.vertices, jm.vertices),
                     (m.vertex_colors, jm.vertex_colors)):
            assert np.abs(x[m.faces] - y[jm.faces]).max() <= 1e-4
    assert sum(len(m.faces) > 100 for m in gmeshes) >= 1
    assert [s[0] for s in steps] == list(REG_STEPS)
    for name, err_in, err_out in steps:
        print(f"config 5, {name}: inputs max |d| {err_in:.3e}, result "
              f"max |d| {err_out:.3e}")
        assert err_in == 0.0, name
        if name != "batched_coarse_sweep":
            assert err_out <= REG_STEP_TOL, name
    # the sweep object by object: a scan whose candidate ICP meets a
    # Kabsch tie (two inliers after the scale jump, a rank-1 H) may end
    # in another minimum; the tie is printed, and every other scan is
    # held within REG_STEP_TOL (ROADMAP queue 3)
    sweep_args, _ = tapes["steps"]["batched_coarse_sweep"][0]
    hold_coarse_sweep(*sweep_args, label="config 5")
    assert set(got) == set(ref) == set(flags)
    for f in flags:
        assert np.isfinite(got[f]["uhd"])
        assert abs(got[f]["uhd"] - ref[f]["uhd"]) <= 1e-5, f
    assert all(p.is_meta for m in port_modules for p in m.parameters())

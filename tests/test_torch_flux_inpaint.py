"""Parity of the port's FLUX inpainter (genpc_tpu_torch/models/
dit_depth.py ``FluxInpainter``) with the JAX reference's on the CPU: the
sampler on the reference's draws (the known pixels exact), DepthPrompting
with inpainter="flux" per object, and run_batched with
control_model="flux" and inpainter="flux" against the reference's.
Both packages carry the same weights (torch_flux_ref.trees)."""

import importlib

import jax
import numpy as np
import pytest
import torch_flux_ref as fr
from torch_models_ref import precision
from torch_threads import one_torch_thread  # noqa: F401

import genpc_tpu.config as jconfig
import genpc_tpu_torch.config as tconfig
from genpc_tpu.models.dit_depth import DiTDepthEdit as JDiT
from genpc_tpu.models.dit_depth import FluxInpainter as JInp
from genpc_tpu_torch.io.synthetic_data import write_dataset
from genpc_tpu_torch.models.dit_depth import DiTDepthEdit, FluxInpainter
from genpc_tpu_torch.tracing import recording


def _hole_case(seed=5):
    r = np.random.default_rng(seed)
    img = r.random((3, fr.SIZE, fr.SIZE)).astype(np.float32)
    mask = np.zeros((3, fr.SIZE, fr.SIZE), np.float32)
    mask[:, 20:44, 10:50] = 1.0
    mask[:, r.random((fr.SIZE, fr.SIZE)) > 0.9] = 1.0
    return img, mask


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_inpainter_matches_the_reference(mode):
    """FluxInpainter.paint on a CHW image with a block hole and scattered
    hole pixels: the image within IMAGE_TOL, the known pixels bit-equal to
    the reference's (both keep the known image)."""
    trees = fr.trees(0)
    ji = JInp(fr.cfg("ref"))
    fr.install_ref(ji.backend, trees)
    ti = FluxInpainter(fr.cfg("port"))
    fr.install_port(ti.backend, trees)
    img, mask = _hole_case()
    be = ji.backend
    (noise,), _ = fr.paint_draws(be.rng, 1, fr.SIZE // be.factor,
                                 be.dit_cfg.in_channels)
    jax.clear_caches()
    with precision(mode, *ti.backend.models().values()), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(ti, "paint_draws", lambda hw: noise)
        ref = ji.paint(img, mask)
        with recording() as rec:
            got = ti.paint(img, mask)
    jax.clear_caches()
    assert got.shape == ref.shape == (3, fr.SIZE, fr.SIZE)
    known = mask.max(axis=0) < 0.5
    np.testing.assert_array_equal(got[:, known], ref[:, known])
    assert float(ref[:, ~known].std()) > 0.01
    assert np.abs(got - ref).max() <= fr.IMAGE_TOL[mode]
    assert {s.name for s in rec.spans} == {"encode", "inpaint"}


def test_depth_prompting_paints_with_flux_per_object():
    """DepthPrompting(inpainter="flux").get_depth: the same hole mask as
    the reference's, and the port's raw depth painted by its FLUX
    inpainter as the reference's inpainter paints that raw depth (bf16
    bound), with the known pixels kept; DDNM and cv2 build and paint,
    keeping the known pixels."""
    from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
    from genpc_tpu.pipeline.depth_prompting import DepthPrompting as JDP
    from genpc_tpu_torch.io.synthetic_data import make_object
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts as TArt
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting as TDP
    kw = dict(save=False, view_num=32, cam_res=64, res=fr.SIZE,
              downsample_num=512, control_model="synthetic",
              inpainter="flux")
    xyz, rgb = make_object(0, n_gt=8192)[:2]
    trees = fr.trees(0)
    jdp = JDP(jconfig.load_config(model_size="tiny", **kw))
    fr.install_ref(jdp.inpainter.backend, trees)
    tdp = TDP(tconfig.load_config(device="cpu", model_size="tiny", **kw))
    fr.install_port(tdp.inpainter.backend, trees)
    assert tdp.owns_inpainter
    jbe = jdp.inpainter.backend
    noises, _ = fr.paint_draws(jbe.rng, 2, fr.SIZE // jbe.factor,
                             jbe.dit_cfg.in_channels)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdp.inpainter, "paint_draws", lambda hw: noises[1])
        at = tdp.get_depth(TArt("01184", xyz, rgb))
        aj = jdp.get_depth(JArt("01184", xyz, rgb))
    np.testing.assert_array_equal(at.mask, aj.mask)
    assert at.depth.shape == (3, fr.SIZE, fr.SIZE)
    known = at.mask.max(axis=0) < 0.5
    assert known.any() and (~known).any()
    np.testing.assert_array_equal(at.depth[:, known],
                                  ((at.raw_depth * 2 - 1) / 2.0 + 0.5)
                                  [:, known])
    ref = jdp.inpainter.paint(at.raw_depth, at.mask,
                              prompt="complete the depth map. ")
    assert np.abs(at.depth - ref).max() <= fr.IMAGE_TOL["bf16"]
    for name in ("DDNM", "cv2"):
        dp = TDP(tconfig.load_config(device="cpu", **dict(kw,
                                                          inpainter=name)))
        if name == "DDNM":
            dp.inpainter.steps = 2
        art = dp.get_depth(TArt("01184", xyz, rgb))
        assert art.depth.shape == (3, fr.SIZE, fr.SIZE)
        assert np.isfinite(art.depth).all()
        known = art.mask.max(axis=0) < 0.5
        assert known.any() and (~known).any()
        # DDNM maps the known pixels to [-1, 1] and back; cv2 takes them
        # through uint8
        tol = 1e-6 if name == "DDNM" else 1.0 / 255
        assert np.abs(art.depth - art.raw_depth)[:, known].max() <= tol


#: test_torch_dit_depth.py's tiny run_batched config, with FLUX for both
#: the depth->image stage and the inpainter
TINY = dict(
    save=False, control_model="flux", inpainter="flux",
    rembg_model="synthetic", generative_model="synthetic",
    trust_aligned_completion=True, view_num=16, downsample_num=256,
    res=fr.SIZE, cam_res=64, generate_res=fr.SIZE, input_points=4096,
    inpaint_iters=10, glb_sample_points=512, pose_complete_points=64,
    icp_points=64, pose_iters=3, pose_render_size=32, fused_points=256,
    fine_scale_steps=2, metric_points=256)


def _fixed_planes(pts_list, *a, **k):
    """One vertical mirror plane through each cloud's centroid."""
    n = np.array([1.0, 0.0, 0.0])
    return [(n, float(np.asarray(p)[:, 0].mean())) for p in pts_list]


def _run(pkg, cfg, root, backend, install, flags, mp):
    """run_batched of one package with ``backend`` injected as its
    depth->image generator (kept alive past the stage's release) and its
    DepthPrompting's inpainter given the test's weights by ``install``,
    the symmetry search replaced by fixed planes; -> (depths, images,
    results)."""
    br = importlib.import_module(f"{pkg}.parallel.batched_runner")
    dpm = importlib.import_module(f"{pkg}.pipeline.depth_prompting")
    syn = importlib.import_module(f"{pkg}.models.synthetic")
    depths, images = [], []
    gen = br._generate_images

    def recording(cfg, dp, arts):
        depths.extend(np.asarray(a.depth) for a in arts)
        gen(cfg, dp, arts)
        images.extend(np.asarray(a.image) for a in arts)

    mp.setattr(br, "_generate_images", recording)
    mp.setattr(syn.SyntheticImage23D, "plan_symmetry_batched",
               staticmethod(_fixed_planes))
    mp.setattr(backend, "release", lambda: None)
    dp = dpm.DepthPrompting(cfg, depth2image=backend)
    install(dp.inpainter)
    results = br.run_batched(cfg, flags, root, dp=dp)
    return dp, np.stack(depths), np.stack(images), results


def test_run_batched_with_flux_matches_the_reference(tmp_path):
    """run_batched (aligned path) over two objects with FLUX generating
    the images and painting the depths in both packages: the images
    within IMAGE_TOL (bf16), per-object CD within 1e-5 and EMD within
    2 % (test_torch_pipeline.py's bounds), the port's painted depths
    keeping their known pixels, and the port's inpainter freed after
    stage 1."""
    flags = ["01184", "05117"]
    write_dataset(str(tmp_path), flags, seed=0, n_gt=8192)
    trees = fr.trees(0)
    j = JDiT(fr.cfg("ref", **TINY), variant="flux")
    fr.install_ref(j, trees)
    t = DiTDepthEdit(fr.cfg("port", **TINY), variant="flux")
    fr.install_port(t, trees)
    lat = fr.reference_draws(j, 2)
    hw = fr.SIZE // j.factor
    noises, _ = fr.paint_draws(jax.random.PRNGKey(0), 2, hw,
                             j.dit_cfg.in_channels)

    def port_inpainter(inp):
        fr.install_port(inp.backend, trees)
        it = iter(noises)
        inp.paint_draws = lambda hw: next(it)

    with pytest.MonkeyPatch.context() as mp:
        _, _, ref_imgs, ref = _run(
            "genpc_tpu", fr.cfg("ref", **TINY), str(tmp_path), j,
            lambda inp: fr.install_ref(inp.backend, trees), flags, mp)
        mp.setattr(t, "draws", lambda b, hw: lat)
        dp, got_depths, got_imgs, got = _run(
            "genpc_tpu_torch", fr.cfg("port", **TINY),
            str(tmp_path), t, port_inpainter, flags, mp)
    assert dp.inpainter is None
    assert got_depths.shape == (2, 3, fr.SIZE, fr.SIZE)
    assert got_imgs.shape == ref_imgs.shape == (2, fr.SIZE, fr.SIZE, 3)
    assert np.abs(got_imgs - ref_imgs).max() <= fr.IMAGE_TOL["bf16"]
    assert set(got) == set(ref) == set(flags)
    for f in flags:
        assert np.isfinite(got[f]["cd"]) and np.isfinite(got[f]["emd"])
        assert abs(got[f]["cd"] - ref[f]["cd"]) <= 1e-5
        assert abs(got[f]["emd"] - ref[f]["emd"]) <= 0.02 * ref[f]["emd"]

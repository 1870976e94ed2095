"""Parity of the port's toolkit modules with the JAX reference on the CPU,
on the same seeded numpy inputs: the footprint-scatter renderer,
apml_loss, SH, 2D image ops and metrics, densification, mesh utilities,
segmentation, the metric CLI, the debug PNG renderer and the logger.
The properties that tests/test_extras.py and tests/test_utils.py check
on the reference are checked on the port too."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.geometry import densify as jdensify
from genpc_tpu.geometry import mesh_utils as jmu
from genpc_tpu.geometry import sh as jsh
from genpc_tpu.io.glb import Mesh as JMesh
from genpc_tpu.metrics import image_metrics as jim
from genpc_tpu.metrics import losses as jlosses
from genpc_tpu.models import segmentation as jseg
from genpc_tpu.render import image_ops as jops
from genpc_tpu.render import point_renderer as jpr
from genpc_tpu_torch.geometry import densify as tdensify
from genpc_tpu_torch.geometry import mesh_utils as tmu
from genpc_tpu_torch.geometry import sh as tsh
from genpc_tpu_torch.io.glb import Mesh
from genpc_tpu_torch.metrics import image_metrics as tim
from genpc_tpu_torch.metrics import losses as tlosses
from genpc_tpu_torch.models import segmentation as tseg
from genpc_tpu_torch.render import image_ops as tops
from genpc_tpu_torch.render import point_renderer as tpr


def _t(a):
    return torch.as_tensor(np.array(a))


# ------------------------------------------------------ scatter renderer

def _cloud(seed, n=600):
    r = np.random.default_rng(seed)
    return ((r.normal(size=(n, 3)) * 0.3).astype(np.float32),
            r.random((n, 3)).astype(np.float32))


@pytest.mark.parametrize("res,footprint", [(32, 3), (48, 2)])
@pytest.mark.parametrize("deterministic", [False, True])
def test_scatter_render_and_grad_match(res, footprint, deterministic):
    # the default renderer: image within 1e-5, the gradient of a weighted
    # mean w.r.t. the points within 1e-4 of jax.grad (measured: 1.2e-6
    # and 1.8e-6 of the largest component)
    pts, cols = _cloud(res + footprint)
    w = np.random.default_rng(1).random((res, res, 3)).astype(np.float32)
    camj = jpr.RenderCamera.default(res)

    def jloss(p):
        img = jpr.render_points(p, jnp.asarray(cols), 0.02, camj,
                                footprint=footprint,
                                deterministic=deterministic)
        return jnp.mean(img * w), img

    (_, img_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(pts))
    p = _t(pts).requires_grad_(True)
    img_t = tpr.render_points(p, _t(cols), 0.02, tpr.RenderCamera.default(res),
                              footprint=footprint,
                              deterministic=deterministic)
    (img_t * _t(w)).mean().backward()
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_j), atol=1e-4)


def test_scatter_deterministic_sums_and_batch():
    # fixed-point sums against float sums within 1e-5; two calls repeat
    # bit for bit; renders are independent along the batch axis
    clouds = [_cloud(s, 800) for s in (3, 4)]
    cam = tpr.RenderCamera.default(40)
    pts = _t(np.stack([c[0] for c in clouds]))
    cols = _t(np.stack([c[1] for c in clouds]))
    det = [tpr.render_points(pts, cols, 0.02, cam, deterministic=True)
           for _ in range(2)]
    assert torch.equal(det[0], det[1])
    flt = tpr.render_points(pts, cols, 0.02, cam)
    assert (det[0] - flt).abs().max() <= 1e-5
    for i in range(2):
        one = tpr.render_points(pts[i], cols[i], 0.02, cam,
                                deterministic=True)
        assert torch.equal(one, det[0][i])
    with pytest.raises(ValueError):
        tpr.render_points(pts, cols, 0.02, cam, method="pulsar")


# ------------------------------------------------------------ apml loss

@pytest.mark.parametrize("batched", [False, True])
def test_apml_loss_and_grad_match(batched):
    # value within 1e-5 relative, both gradients within 1e-5 of the
    # largest component
    r = np.random.default_rng(7)
    shape = (2, 96, 3) if batched else (96, 3)
    a = (r.normal(size=shape) * 0.2).astype(np.float32)
    b = (r.normal(size=shape[:-2] + (80, 3)) * 0.2).astype(np.float32)
    vj, (ga, gb) = jax.value_and_grad(jlosses.apml_loss, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    at, bt = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    vt = tlosses.apml_loss(at, bt)
    vt.backward()
    assert abs(float(vt) - float(vj)) <= 1e-5 * abs(float(vj))
    for g, ref in ((at.grad, ga), (bt.grad, gb)):
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------------- SH

def test_sh_matches_and_properties():
    r = np.random.default_rng(0)
    sh = r.normal(size=(5, 3, 25)).astype(np.float32)
    dirs = r.normal(size=(5, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for deg in range(5):
        np.testing.assert_allclose(
            tsh.eval_sh(deg, _t(sh), _t(dirs)).numpy(),
            np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
            atol=1e-5)
    rgb = r.random((10, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(rgb)), atol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(_t(rgb))).numpy(),
                               rgb, atol=1e-6)
    out = tsh.eval_sh(0, torch.ones((5, 3, 1)), _t(dirs))
    np.testing.assert_allclose(out.numpy(), 0.28209479, rtol=1e-6)
    with pytest.raises(ValueError):
        tsh.eval_sh(5, _t(sh), _t(dirs))


# ------------------------------------------------------------- image ops

def test_morphology_matches_and_properties():
    m = (np.random.default_rng(2).random((24, 24)) < 0.2).astype(np.float32)
    for it in (1, 2):
        for fj, ft in ((jops.dilate, tops.dilate), (jops.erode, tops.erode),
                       (jops.fill_hole, tops.fill_hole)):
            np.testing.assert_array_equal(ft(_t(m), it).numpy(),
                                          np.asarray(fj(jnp.asarray(m), it)))
    # test_extras.py::test_morphology on the port
    one = torch.zeros((16, 16))
    one[8, 8] = 1.0
    d = tops.dilate(one, 1)
    assert float(d.sum()) == 9 and float(tops.erode(d, 1).sum()) == 1
    ring = torch.zeros((16, 16))
    ring[6:11, 6:11] = 1
    ring[8, 8] = 0
    assert float(tops.fill_hole(ring, 1)[8, 8]) == 1.0


def test_edges_filter_inpaint_and_cat_match():
    r = np.random.default_rng(3)
    img = r.random((20, 24, 3)).astype(np.float32)
    e_j = np.asarray(jops.scharr_edges(jnp.asarray(img)))
    np.testing.assert_allclose(tops.scharr_edges(_t(img)).numpy(), e_j,
                               atol=1e-5 * np.abs(e_j).max())
    np.testing.assert_allclose(tops.scharr_edges(_t(img[..., 0])).numpy(),
                               np.asarray(jops.scharr_edges(img[..., 0])),
                               atol=1e-4)
    np.testing.assert_allclose(tops.bilateral_filter(_t(img)).numpy(),
                               np.asarray(jops.bilateral_filter(
                                   jnp.asarray(img))), atol=1e-5)
    mask = (r.random((20, 24)) < 0.1).astype(np.float32)
    np.testing.assert_array_equal(tops.naive_inpainting(img, mask),
                                  jops.naive_inpainting(img, mask))
    ims = [r.random((4, 4, 3)) for _ in range(3)]
    for axis, pad in ((1, 2), (0, 1), (1, 0)):
        np.testing.assert_array_equal(tops.cat_images(ims, axis, pad),
                                      jops.cat_images(ims, axis, pad))
    # test_extras.py::test_scharr_and_bilateral on the port
    step = torch.zeros((16, 16, 3))
    step[:, 8:] = 1.0
    e = tops.scharr_edges(step)
    assert float(e[:, 7:9].max()) > float(e[:, 0:4].max()) + 1
    sm = tops.bilateral_filter(step)
    assert float(sm[8, 6, 0]) < 0.3 and float(sm[8, 10, 0]) > 0.7
    flat = np.ones((16, 16, 3)) * 0.5
    flat[8, 8] = 0
    hole = np.zeros((16, 16))
    hole[8, 8] = 1
    np.testing.assert_allclose(tops.naive_inpainting(flat, hole)[8, 8], 0.5,
                               atol=1e-6)
    assert tops.cat_images([np.zeros((4, 4, 3)), np.ones((4, 4, 3))],
                           axis=1, pad=2).shape == (4, 10, 3)


def test_image_metrics_match_and_properties():
    r = np.random.default_rng(4)
    a = r.random((32, 32, 3)).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for name in ("mse", "psnr", "ssim"):
        got = float(getattr(tim, name)(_t(a), _t(b)))
        ref = float(getattr(jim, name)(a, b))
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), name
    assert abs(float(tim.ssim(_t(a[..., 0]), _t(b[..., 0])))
               - float(jim.ssim(a[..., 0], b[..., 0]))) <= 1e-5
    for shape in ((4, 16, 16, 3), (3, 32, 24, 3), (2, 5, 7, 3), (9, 9, 3)):
        x = r.random(shape).astype(np.float32)
        np.testing.assert_allclose(tim.default_feature_extractor(x),
                                   jim.default_feature_extractor(x),
                                   atol=1e-5)
    fa, fb = r.random((12, 6)), r.random((12, 6))
    assert tim.frechet_distance(fa, fb) == jim.frechet_distance(fa, fb)
    imgs_a = r.random((8, 16, 16, 3))
    imgs_b = imgs_a + r.normal(0, 0.01, imgs_a.shape)
    assert abs(tim.fid(imgs_a, imgs_b) - jim.fid(imgs_a, imgs_b)) <= 1e-5
    # test_utils.py's properties on the port
    assert float(tim.psnr(_t(a), _t(a))) > 100
    assert abs(float(tim.ssim(_t(a), _t(a))) - 1.0) < 1e-5
    small = np.clip(a + r.normal(0, 0.01, a.shape), 0, 1)
    big = np.clip(a + r.normal(0, 0.2, a.shape), 0, 1)
    assert float(tim.psnr(a, small)) > float(tim.psnr(a, big))
    assert float(tim.ssim(a, small)) > float(tim.ssim(a, big))
    c = r.random((8, 16, 16, 3)) * 0.2
    assert tim.fid(imgs_a, imgs_b) < tim.fid(imgs_a, c)


# ------------------------------------------------------- densify, meshes

def test_densify_matches_and_properties():
    pts = np.random.default_rng(0).random((100, 3)).astype(np.float32)
    cols = np.random.default_rng(1).random((100, 3)).astype(np.float32)
    for frac in (1.0, 0.4):
        o_t, c_t = tdensify.linear_interpolation(pts, cols, frac=frac,
                                                 device="cpu")
        o_j, c_j = jdensify.linear_interpolation(pts, cols, frac=frac)
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(c_t, c_j)
    o_t, _ = tdensify.random_add_points(pts, 350, device="cpu")
    o_j, _ = jdensify.random_add_points(pts, 350)
    np.testing.assert_array_equal(o_t, o_j)
    assert len(o_t) == 350
    more, c = tdensify.linear_interpolation(pts, np.ones_like(pts) * 0.5,
                                            device="cpu")
    assert len(more) == 200 and len(c) == 200


def _tetra(pkg_mesh):
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    return pkg_mesh(v, f, np.ones((4, 3), np.float32) * 0.5)


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    if a.vertex_colors is None:
        assert b.vertex_colors is None
    else:
        np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)


def test_mesh_cleanup_matches_and_properties():
    from genpc_tpu_torch.ops.marching import marching_tetrahedra
    meshes = []
    for M in (Mesh, JMesh):
        m = _tetra(M)
        v = np.concatenate([m.vertices, m.vertices[:1] + 1e-9])
        f = m.faces.copy()
        f[0, 0] = 4
        meshes.append(M(v, f, np.ones((5, 3), np.float32)))
    _same_mesh(tmu.weld_vertices(meshes[0]), jmu.weld_vertices(meshes[1]))
    _same_mesh(tmu.clean_mesh(meshes[0], min_component_faces=1),
               jmu.clean_mesh(meshes[1], min_component_faces=1))
    assert len(tmu.weld_vertices(meshes[0]).vertices) == 4
    assert len(tmu.clean_mesh(meshes[0], min_component_faces=1).faces) == 4
    g = np.linspace(-1, 1, 24)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    v, f = marching_tetrahedra(0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2))
    dec = tmu.decimate_mesh(Mesh(v, f, np.ones_like(v) * 0.5), 300)
    _same_mesh(dec, jmu.decimate_mesh(JMesh(v, f, np.ones_like(v) * 0.5),
                                      300))
    assert len(dec.faces) < len(f)
    assert np.abs(np.linalg.norm(dec.vertices, axis=1) - 0.6).max() < 0.1
    comp = tmu.remove_small_components(Mesh(v, f), 10)
    _same_mesh(comp, jmu.remove_small_components(JMesh(v, f), 10))


def test_normals_and_poisson_match():
    # estimate_normals within 1e-5 (the same neighbours, numpy's eigh on
    # both sides) and poisson_reconstruct's vertices within 1e-5 and
    # faces equal; a sphere's normals point radially
    rng = np.random.default_rng(0)
    v = rng.normal(size=(1500, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    n_t = tmu.estimate_normals(v.astype(np.float32), device="cpu")
    np.testing.assert_allclose(n_t, jmu.estimate_normals(v.astype(
        np.float32)), atol=1e-5)
    assert np.abs(np.sum(n_t * v, axis=1)).mean() > 0.95
    cols = np.ones_like(v) * 0.5
    m_t = tmu.poisson_reconstruct(v, grid_res=32, colors=cols, device="cpu")
    m_j = jmu.poisson_reconstruct(v, grid_res=32, colors=cols)
    np.testing.assert_array_equal(m_t.faces, m_j.faces)
    np.testing.assert_allclose(m_t.vertices, m_j.vertices, atol=1e-5)
    np.testing.assert_array_equal(m_t.vertex_colors, m_j.vertex_colors)
    assert len(m_t.vertices) > 100
    assert abs(np.median(np.linalg.norm(m_t.vertices, axis=1)) - 1.0) < 0.15


# ------------------------------------------------------------ segmentation

def test_segmentation_matches():
    a = np.zeros((8, 8)); a[:4] = 1
    b = np.zeros((8, 8)); b[:4] = 1
    c = np.zeros((8, 8)); c[6:] = 1
    assert tseg.mask_iou(a, b) == jseg.mask_iou(a, b) == 1.0
    assert tseg.dedup_masks([a, b, c], 0.5) == jseg.dedup_masks([a, b, c],
                                                                0.5)
    assert tseg.match_masks([a], [b, c]) == jseg.match_masks([a], [b, c]) \
        == [0, None]
    img = np.zeros((64, 64, 3), np.float32)
    img[10:20, 30:45] = 0.8
    img[40:56, 5:20] = 0.5
    mask = (img[..., 0] > 0).astype(np.float32)
    for x, y in zip(tseg.crop_center_object(img, mask, 64),
                    jseg.crop_center_object(img, mask, 64)):
        np.testing.assert_array_equal(x, y)
    recs_t = tseg.process_scene_image(img)
    recs_j = jseg.process_scene_image(img)
    assert len(recs_t) == len(recs_j) == 2
    for rt, rj in zip(recs_t, recs_j):
        assert rt.keys() == rj.keys()
        for k in rt:
            np.testing.assert_array_equal(rt[k], rj[k])


# --------------------------------------------- metric CLI, vis, logger

def test_metric_cli_matches(tmp_path, capsys):
    from genpc_tpu.metrics.metric import evaluate_workspace
    from genpc_tpu_torch import metric_cli
    from genpc_tpu_torch.io.ply import save_ply
    r = np.random.default_rng(5)
    flags = ["01184", "05117"]
    (tmp_path / "GT").mkdir()
    for f in flags:
        (tmp_path / "ws" / f).mkdir(parents=True)
        save_ply(str(tmp_path / "ws" / f / f"{f}_fused.ply"),
                 r.normal(size=(300, 3)).astype(np.float32))
        save_ply(str(tmp_path / "GT" / f"{f}.ply"),
                 r.normal(size=(400, 3)).astype(np.float32))
    for rot in ([], ["--rotate-gt"]):
        avg = metric_cli.main(["--workspace", str(tmp_path / "ws"),
                               "--gt-dir", str(tmp_path / "GT"), "--flags",
                               *flags, "--no-emd", "--device", "cpu", *rot])
        ref = [evaluate_workspace(f, str(tmp_path / "ws"),
                                  str(tmp_path / "GT"), with_emd=False,
                                  rotate_gt_x180=bool(rot))["cd"]
               for f in flags]
        assert abs(avg["cd"] - np.mean(ref)) <= 1e-6
    assert "Average CD" in capsys.readouterr().out
    assert metric_cli.main(["--workspace", str(tmp_path / "none"),
                            "--gt-dir", str(tmp_path / "GT"),
                            "--device", "cpu"]) == {}


def test_vis_actors_renders_png(tmp_path):
    # test_extras.py::test_vis_actors_renders_png on the port
    from genpc_tpu_torch.vis import (
        ArrowActor, BoxActor, MeshActor, colorful_pc_actor, pc_actor,
        vis_actors, vis_scenes)
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    mesh = MeshActor(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                          np.float32),
        faces=np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]),
        vertex_colors=np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1],
                                [1, 1, 0]], np.float32))
    actors = [colorful_pc_actor(pts), pc_actor(pts[:50], color=(1, 0, 0)),
              mesh, BoxActor(np.array([0, 0, 0, 2, 2, 2, 0.3])),
              ArrowActor(np.zeros(3), np.array([0, 0, 1.5]))]
    out = tmp_path / "scene.png"
    img = vis_actors(actors, save_path=str(out), info="debug")
    assert out.exists() and out.stat().st_size > 1000
    assert img.ndim == 3 and img.shape[2] == 3 and img.std() > 1.0
    assert vis_scenes([actors[:2], actors[2:]], titles=["pc", "geo"]) \
        .shape[2] == 3
    with pytest.raises(TypeError):
        vis_actors([object()])


def test_logger(tmp_path):
    from genpc_tpu_torch.utils_logging import get_logger
    log = get_logger("test_genpc_torch", str(tmp_path / "x.log"))
    log.info("hello")
    assert (tmp_path / "x.log").read_text().strip().endswith("hello")
    assert get_logger("test_genpc_torch") is log

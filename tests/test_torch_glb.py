"""Bit-equality of the port's host-side mesh and image code with the JAX
reference on the CPU: marching tetrahedra (genpc_tpu_torch/ops/
marching.py), GLB IO and surface sampling (io/glb.py), a stage-2 mesh
through ``Workspace``, and the image resizes of the image-to-3D path
(``clip_preprocess``'s bicubic, ``prep_rgb``'s bilinear) and the
zero123plus cameras."""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from genpc_tpu.io import glb as jglb
from genpc_tpu.models.backends import prep_rgb as jprep_rgb
from genpc_tpu.models.lrm import zero123plus_cameras as jcams
from genpc_tpu.models.text_encoder import clip_preprocess as jclip_prep
from genpc_tpu.ops.marching import marching_tetrahedra as jmarch
from genpc_tpu.pipeline.artifacts import ObjectArtifacts as JArt
from genpc_tpu.pipeline.artifacts import Workspace as JWorkspace
from genpc_tpu_torch.io import glb as tglb
from genpc_tpu_torch.models.backends import prep_rgb
from genpc_tpu_torch.models.lrm import zero123plus_cameras
from genpc_tpu_torch.models.text_encoder import clip_preprocess
from genpc_tpu_torch.ops.marching import marching_tetrahedra
from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts, Workspace


def _sphere(res=20, radius=0.6):
    g = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return radius - np.sqrt(x ** 2 + y ** 2 + z ** 2)


def _fields():
    r = np.random.default_rng(0)
    smooth = r.normal(size=(12, 12, 12)).cumsum(0).cumsum(1)
    return {"random": (r.normal(size=(9, 10, 11)), 0.0),
            "random_median": (smooth, float(np.median(smooth))),
            "sphere": (_sphere(), 0.0),
            "sphere_level": (_sphere(16), 0.1),
            "no_crossing": (np.full((6, 6, 6), -1.0), 0.0)}


@pytest.mark.parametrize("name", sorted(_fields()))
def test_marching_tetrahedra_bit_equal(name):
    field, level = _fields()[name]
    v, f = marching_tetrahedra(field, level=level)
    jv, jf = jmarch(field, level=level)
    assert v.dtype == jv.dtype == np.float32 and f.dtype == jf.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    if name == "no_crossing":
        assert v.shape == (0, 3) and f.shape == (0, 3)
    else:
        assert len(f) > 0


def _mesh(pkg_mesh, seed=0, colors=True):
    v, f = marching_tetrahedra(_sphere(14), 0.0)
    r = np.random.default_rng(seed)
    c = r.random((len(v), 3)).astype(np.float32) if colors else None
    return pkg_mesh(v, f, c)


@pytest.mark.parametrize("colors", [True, False])
def test_sample_mesh_surface_bit_equal(colors):
    m, jm = _mesh(tglb.Mesh, colors=colors), _mesh(jglb.Mesh, colors=colors)
    for rng in (None, 5):
        p, c = tglb.sample_mesh_surface(
            m, 4096, None if rng is None else np.random.default_rng(rng))
        jp, jc = jglb.sample_mesh_surface(
            jm, 4096, None if rng is None else np.random.default_rng(rng))
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(m.face_areas(), jm.face_areas())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_glb_round_trip_across_packages(tmp_path, writer, monkeypatch):
    """A GLB written by one package loads in the other with the same
    vertices, faces and colours, and glb_to_points samples it alike (the
    reference's voxel downsample pinned to its numpy algorithm: its
    native helper emits the voxels in another order, ROADMAP queue 3)."""
    import genpc_tpu.native
    from torch_replay import native_off
    monkeypatch.setattr(genpc_tpu.native, "voxel_down_sample_native",
                        native_off)
    save, meshcls = ((tglb.save_glb, tglb.Mesh) if writer == "port"
                     else (jglb.save_glb, jglb.Mesh))
    m = _mesh(meshcls, seed=1)
    path = str(tmp_path / "m.glb")
    save(path, m)
    a, b = tglb.load_glb(path), jglb.load_glb(path)
    for x in (a, b):
        np.testing.assert_array_equal(x.vertices, m.vertices)
        np.testing.assert_array_equal(x.faces, m.faces)
        np.testing.assert_array_equal(x.vertex_colors, m.vertex_colors)
    for kw in ({}, {"seed": 3, "down_sample": 0.05}):
        p, c = tglb.glb_to_points(path, 2048, **kw)
        jp, jc = jglb.glb_to_points(path, 2048, **kw)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(c, jc)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_workspace_stage2_mesh_across_packages(tmp_path, writer):
    """Stage 2 with a mesh completion, saved by one package's Workspace
    and loaded by the other's: the mesh comes back as <flag>_<model>.glb."""
    r = np.random.default_rng(2)
    xyz = r.random((300, 3)).astype(np.float32)
    rgb = r.random((300, 3)).astype(np.float32)
    img = r.random((16, 16, 4)).astype(np.float32)
    arts = {"port": (ObjectArtifacts, Workspace, tglb.Mesh),
            "reference": (JArt, JWorkspace, jglb.Mesh)}
    art_cls, ws_cls, mesh_cls = arts[writer]
    m = _mesh(mesh_cls, seed=3)
    ws_cls(str(tmp_path), "instantmesh").save_stage2(art_cls(
        "01184", image_nobg=img, color_xyz=xyz, color_rgb=rgb,
        complete_mesh=m))
    assert (tmp_path / "01184" / "01184_instantmesh.glb").exists()
    assert not (tmp_path / "01184" / "01184_instantmesh.ply").exists()
    for art_cls, ws_cls, _ in arts.values():
        got = ws_cls(str(tmp_path), "instantmesh").load_stage2("01184")
        np.testing.assert_array_equal(got.complete_mesh.vertices,
                                      m.vertices)
        np.testing.assert_array_equal(got.complete_mesh.faces, m.faces)
        np.testing.assert_allclose(got.color_xyz, xyz, atol=1e-6)
        assert got.complete_xyz is None


@pytest.mark.parametrize("shape,size", [((320, 320, 3), 224),
                                        ((32, 32, 3), 32),
                                        ((100, 60, 3), 48),
                                        ((30, 70, 3), 64)])
def test_clip_preprocess_bit_equal(shape, size):
    img = np.random.default_rng(size).random(shape).astype(np.float32)
    img[:5] = 1.5                       # clipped, as the reference clips
    got = clip_preprocess(img, size)
    ref = jclip_prep(img, size)
    assert got.shape == (1, size, size, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape,size", [((512, 512, 4), 320),
                                        ((64, 64, 4), 32),
                                        ((40, 40, 3), 320),
                                        ((32, 32, 4), 32),
                                        ((150, 90, 4), 64)])
def test_prep_rgb_bit_equal(shape, size):
    img = np.random.default_rng(shape[0]).random(shape).astype(np.float32)
    got = prep_rgb(img, size)
    ref = jprep_rgb(img, size)
    assert got.shape == (size, size, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [6, 4])
def test_zero123plus_cameras_bit_equal(n):
    got = zero123plus_cameras(n)
    assert got.shape == (n, 16)
    np.testing.assert_array_equal(got, jcams(n))

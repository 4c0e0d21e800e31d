"""The port's Ogawa/Alembic stack (phosphorus_mk2_tpu_torch/io/ogawa.py,
abc.py, alembic.py) against the JAX package's, from tests/test_abc.py
and tests/test_abc_adversarial.py.

Archives written by the two packages for the same meshes are compared
byte for byte, and each package imports the other's archive: vertices,
faces, attributes and material ids equal array for array, the camera's
float fields within the JAX test's bounds. The adversarial archives of
test_abc_adversarial.py (hand-packed at the byte level, never emitted by
either writer) run through the port's reader and writer by rebinding the
JAX test module's AbcReader and OgawaWriter: the same data, or the same
exception types and messages. The BMW asset at scale 0.05 (43,564
triangles): byte-equal archives, and scenes whose built arrays are equal.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from phosphorus_mk2_tpu.core.camera import Camera as JCamera
from phosphorus_mk2_tpu.core.material import Material as JMaterial
from phosphorus_mk2_tpu.core.mesh import Mesh as JMesh
from phosphorus_mk2_tpu.core.scene import Scene as JScene
from phosphorus_mk2_tpu.io import abc as jabc
from phosphorus_mk2_tpu.io import alembic as jalembic
from phosphorus_mk2_tpu.io import ogawa as jogawa
from phosphorus_mk2_tpu_torch.core.camera import Camera as TCamera
from phosphorus_mk2_tpu_torch.core.material import Material as TMaterial
from phosphorus_mk2_tpu_torch.core.mesh import Mesh as TMesh
from phosphorus_mk2_tpu_torch.core.scene import Scene as TScene
from phosphorus_mk2_tpu_torch.io import abc as tabc
from phosphorus_mk2_tpu_torch.io import alembic as talembic
from phosphorus_mk2_tpu_torch.io import ogawa as togawa

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_abc_adversarial as adversarial  # noqa: E402

JAX = dict(Mesh=JMesh, Scene=JScene, Material=JMaterial, Camera=JCamera, alembic=jalembic)
PORT = dict(Mesh=TMesh, Scene=TScene, Material=TMaterial, Camera=TCamera, alembic=talembic)
PACKAGES = {"jax": JAX, "port": PORT}


def _mesh_fields(m):
    return {k: getattr(m, k) for k in ("vertices", "faces", "normals", "uvs", "material",
                                       "corner_normals", "corner_uvs", "name", "smooth")}


def _assert_meshes_equal(a, b):
    fa, fb = _mesh_fields(a), _mesh_fields(b)
    for k in fa:
        if fa[k] is None or isinstance(fa[k], (str, bool)):
            assert fa[k] == fb[k], k
        else:
            np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def _write_both(tmp_path, make_args, name):
    """Each package writes the archive of make_args(pkg); returns the paths
    after checking that the bytes are equal."""
    paths = {}
    for tag, pkg in PACKAGES.items():
        args, kw = make_args(pkg)
        paths[tag] = str(tmp_path / f"{name}_{tag}.abc")
        pkg["alembic"].write_alembic(paths[tag], *args, **kw)
    assert Path(paths["jax"]).read_bytes() == Path(paths["port"]).read_bytes()
    return paths


def _import_both_ways(paths, materials):
    """Each package imports the other's archive; returns (jax scene, port scene)."""
    scenes = {}
    for tag, other in (("jax", "port"), ("port", "jax")):
        pkg = PACKAGES[tag]
        scene = pkg["Scene"]()
        for m in materials:
            scene.add_material(pkg["Material"].diffuse(name=m))
        pkg["alembic"].import_alembic(paths[other], scene)
        scenes[tag] = scene
    assert len(scenes["jax"].meshes) == len(scenes["port"].meshes)
    for a, b in zip(scenes["jax"].meshes, scenes["port"].meshes):
        _assert_meshes_equal(a, b)
    return scenes["jax"], scenes["port"]


def test_ogawa_container_roundtrip_across_packages(tmp_path):
    """test_abc.py's container: the same bytes from both writers, and each
    reader reads the other's file."""
    def build(mod):
        w = mod.OgawaWriter()
        d1 = w.write_data(b"hello")
        d2 = w.write_data(b"")
        inner = w.write_group([d1, mod.EMPTY_GROUP, d2])
        d3 = w.write_data(bytes(range(256)))
        return w.freeze(w.write_group([inner, d3, mod.EMPTY_DATA]))

    blobs = {tag: build(mod) for tag, mod in (("jax", jogawa), ("port", togawa))}
    assert blobs["jax"] == blobs["port"]
    for tag, mod in (("jax", togawa), ("port", jogawa)):
        path = tmp_path / f"{tag}.ogawa"
        path.write_bytes(blobs[tag])
        r = mod.OgawaReader.open(str(path))
        kids = r.group(r.root)
        ik = r.group(kids[0])
        assert [r.data(ik[0]), r.group(ik[1]), r.data(ik[2])] == [b"hello", [], b""]
        assert r.data(kids[1]) == bytes(range(256)) and r.data(kids[2]) == b""


def test_archive_mesh_roundtrip_across_packages(tmp_path):
    """test_abc.py's mesh with normals, uvs, two face sets and a
    translation: byte-equal archives, each imported by the other package."""
    rng = np.random.default_rng(0)
    v = rng.random((8, 3)).astype(np.float32)
    f = np.array([[0, 1, 2], [2, 3, 4], [4, 5, 6], [6, 7, 0]], np.int32)
    n = rng.random((8, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    uv = rng.random((8, 2)).astype(np.float32)
    mat = np.array([0, 0, 1, 1], np.int32)
    xf = np.eye(4)
    xf[3, :3] = (1.0, 2.0, 3.0)

    def args(pkg):
        mesh = pkg["Mesh"](vertices=v, faces=f, material=mat, normals=n, uvs=uv, name="m")
        return ([[(mesh, xf)]], {})

    paths = _write_both(tmp_path, args, "roundtrip")
    _, got = _import_both_ways(paths, ("mat0", "mat1"))
    m = got.meshes[0]
    np.testing.assert_allclose(m.vertices, v + np.array([1, 2, 3], np.float32), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(m.material), mat)


def test_archive_quads_and_camera_across_packages(tmp_path):
    """Non-triangle faceCounts written through both AbcWriters (fan
    triangulation on import), and the camera round trip."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1], [2, 0, 0], [2, 0, 1]],
                     np.float32)
    indices = np.array([0, 1, 2, 3, 1, 4, 5, 2], np.int32)
    counts = np.array([4, 4], np.int32)
    paths = {}
    for tag, mod, schema in (("jax", jabc, jalembic.POLYMESH_SCHEMA),
                             ("port", tabc, talembic.POLYMESH_SCHEMA)):
        w = mod.AbcWriter()
        mo = w.object(w.top, "sheet", schema, f"{schema}:.geom")
        geom = w.compound(".geom")
        geom["children"] = [
            w.array("P", verts, extent=3),
            w.array(".faceIndices", indices, extent=1, pod=mod.POD_INT32),
            w.array(".faceCounts", counts, extent=1, pod=mod.POD_INT32),
        ]
        mo["props"] = [geom]
        paths[tag] = str(tmp_path / f"quads_{tag}.abc")
        w.save(paths[tag])
    assert Path(paths["jax"]).read_bytes() == Path(paths["port"]).read_bytes()
    _, got = _import_both_ways(paths, ("sheet",))
    assert got.meshes[0].faces.shape == (4, 3)

    def cam_args(pkg):
        cam = pkg["Camera"]()
        cam.focal_length, cam.sensor_width = 50.0, 36.0
        m = pkg["Mesh"](vertices=verts, faces=np.array([[0, 1, 2]], np.int32),
                        material="sheet", name="m")
        return ([[m]], {"camera": cam})

    cams = _import_both_ways(_write_both(tmp_path, cam_args, "cam"), ("sheet",))
    for scene in cams:
        assert abs(scene.camera.focal_length - 50.0) < 1e-6
        assert abs(scene.camera.sensor_width - 36.0) < 1e-5
        assert abs(scene.camera.fov - 2.0 * np.arctan2(18.0, 50.0)) < 1e-6
    assert cams[0].camera.fov == cams[1].camera.fov


def test_face_varying_attributes_across_packages(tmp_path):
    """Corner normals and uvs: byte-equal archives; resolve_corners splits
    the shared edge the same way in both packages."""
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n0 = np.array([0, 0, 1], np.float32)
    n1 = np.array([-0.5**0.5, 0, 0.5**0.5], np.float32)
    cn = np.stack([np.tile(n0, (3, 1)), np.tile(n1, (3, 1))]).reshape(2, 3, 3)
    cuv = np.arange(12, dtype=np.float32).reshape(2, 3, 2) / 12.0

    def args(pkg):
        return ([[pkg["Mesh"](vertices=v, faces=f, material="m", corner_normals=cn,
                              corner_uvs=cuv, name="m")]], {})

    js, ts = _import_both_ways(_write_both(tmp_path, args, "fv"), ("m",))
    np.testing.assert_allclose(ts.meshes[0].corner_normals, cn, rtol=1e-6)
    rj, rt = js.meshes[0].resolve_corners(), ts.meshes[0].resolve_corners()
    assert rt.vertices.shape[0] == 6
    _assert_meshes_equal(rj, rt)


@pytest.mark.parametrize("name", sorted(n for n in dir(adversarial) if n.startswith("test_")))
def test_adversarial_archives_in_the_port(name, tmp_path, monkeypatch):
    """Each test of test_abc_adversarial.py, its archives packed by the
    port's OgawaWriter and read by the port's AbcReader: the same data,
    or the same exception types and messages, as the JAX reader."""
    monkeypatch.setattr(adversarial, "AbcReader", tabc.AbcReader)
    monkeypatch.setattr(adversarial, "OgawaWriter", togawa.OgawaWriter)
    assert adversarial.ARRAY == tabc.ARRAY and adversarial.SCALAR == tabc.SCALAR
    getattr(adversarial, name)(tmp_path)


def test_missing_archive_raises_as_in_jax():
    with pytest.raises(FileNotFoundError):
        talembic.import_alembic(str(ROOT / "no_such_archive.abc"), TScene())


def test_bmw_asset_equal_in_both_packages(tmp_path):
    """tools/bmw_asset.py and the port's copy at scale 0.05: the same
    archive bytes; each package loads the other's archive, and the built
    scenes (the port's on the CPU) are equal array for array."""
    sys.path.insert(0, str(ROOT / "tools"))
    import bmw_asset as jbmw

    from phosphorus_mk2_tpu_torch.tools import bmw_asset as tbmw

    jp, tp = str(tmp_path / "j.abc"), str(tmp_path / "t.abc")
    jbmw.write_asset(jp, scale=0.05)
    tbmw.write_asset(tp, scale=0.05)
    assert Path(jp).read_bytes() == Path(tp).read_bytes()
    jd = jbmw.load_scene(tp, 24, 16).build()
    td = tbmw.load_scene(jp, 24, 16).build(device="cpu")
    assert td.num_tris == 43564
    for f in ("vertices", "faces", "normals", "uvs", "smooth", "tri_mat", "tri_mesh",
              "lobe_type", "lobe_weight", "lobe_param", "emission", "light_type",
              "light_mat", "light_tris", "light_area"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, f)), getattr(td, f).numpy(),
                                      err_msg=f)
    assert (jd.env_mat, jd.num_lights) == (td.env_mat, td.num_lights)
    jc, tc = jbmw.make_camera(24, 16), tbmw.make_camera(24, 16)
    np.testing.assert_array_equal(jc.to_world, tc.to_world)
    assert (jc.focal_length, jc.sensor_width) == (tc.focal_length, tc.sensor_width)

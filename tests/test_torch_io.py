"""The port's scene I/O (phosphorus_mk2_tpu_torch/io/exr.py, obj.py,
ply.py, yaml_scene.py) against the JAX package's, from tests/test_io.py.

Both packages run on the same numpy-seeded inputs. EXR: files written by
the two packages are byte-equal and each reads the other's bit for bit
(half channels equal to the float16 quantization). OBJ and PLY: the
meshes equal array for array. Materials: every lobe's type, weight,
params and texture equal. YAML scenes: both packages' ``scene.build()``
arrays are equal (the port's SceneData on the CPU). A custom node that
bakes a torch function equals the JAX package's bake of the same
function in jnp within 1e-6 (torch.sin and jnp.sin may differ in the
last place).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.io import exr as jexr
from phosphorus_mk2_tpu.io import obj as jobj
from phosphorus_mk2_tpu.io import ply as jply
from phosphorus_mk2_tpu.io import yaml_scene as jyaml
from phosphorus_mk2_tpu_torch.core.scene import Scene as TScene
from phosphorus_mk2_tpu_torch.io import exr as texr
from phosphorus_mk2_tpu_torch.io import obj as tobj
from phosphorus_mk2_tpu_torch.io import ply as tply
from phosphorus_mk2_tpu_torch.io import yaml_scene as tyaml

ROOT = Path(__file__).resolve().parents[1]
CORNELL = ROOT / "examples" / "cornell.yaml"

SCENE_FIELDS = ("vertices", "faces", "normals", "uvs", "smooth", "tri_mat", "tri_mesh",
                "lobe_type", "lobe_weight", "lobe_param", "lobe_flags", "n_lobes", "emission",
                "light_type", "light_mat", "light_offset", "light_count", "light_area",
                "light_tris", "lobe_tex", "emission_tex", "normal_tex", "tex_atlas", "tex_info")


def _assert_built_equal(jscene, tscene):
    jd, td = jscene.build(), tscene.build(device="cpu")
    for f in SCENE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jd, f)), getattr(td, f).numpy(),
                                      err_msg=f)
    for f in td.STATIC_FIELDS:
        assert getattr(jd, f) == getattr(td, f), f


def _assert_materials_equal(a, b):
    assert a.name == b.name and len(a.lobes) == len(b.lobes)
    assert tuple(a.emission) == tuple(b.emission)
    assert (a.emission_texture, a.normal_texture) == (b.emission_texture, b.normal_texture)
    for la, lb in zip(a.lobes, b.lobes):
        assert (la.type, la.texture) == (lb.type, lb.texture)
        np.testing.assert_array_equal(np.asarray(la.weight), np.asarray(lb.weight))
        np.testing.assert_array_equal(np.asarray(la.params), np.asarray(lb.params))


@pytest.mark.parametrize("comp,pixel_type", [("none", "float"), ("zips", "float"),
                                             ("zip", "float"), ("zips", "half"),
                                             ("zip", "half")])
def test_exr_round_trip_across_packages(tmp_path, comp, pixel_type):
    """test_io.py's float and compressed-half round trips: the same bytes
    from both writers; each reader reads the other's file."""
    rng = np.random.default_rng(3)
    channels = {
        "R": (rng.random((40, 9)) * 8).astype(np.float32),
        "G": rng.standard_normal((40, 9)).astype(np.float32),
        "normal.X": rng.random((40, 9)).astype(np.float32),
    }
    paths = {}
    for tag, mod in (("jax", jexr), ("port", texr)):
        paths[tag] = str(tmp_path / f"{tag}.exr")
        mod.write_exr(paths[tag], channels, compression=comp, pixel_type=pixel_type)
    assert Path(paths["jax"]).read_bytes() == Path(paths["port"]).read_bytes()
    for reader, path in ((texr, paths["jax"]), (jexr, paths["port"])):
        back = reader.read_exr(path)
        for k, v in channels.items():
            want = v if pixel_type == "float" else v.astype(np.float16).astype(np.float32)
            np.testing.assert_array_equal(back[k], want)


def test_write_film_and_png_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    film = {"color": rng.random((6, 4, 3)).astype(np.float32),
            "normal": rng.standard_normal((6, 4, 3)).astype(np.float32),
            "alpha": np.ones((6, 4), np.float32)}
    for name, write in (("film.exr", "write_film"), ("film.png", "write_png")):
        arg = film if write == "write_film" else film["color"]
        getattr(jexr, write)(str(tmp_path / f"j_{name}"), arg)
        getattr(texr, write)(str(tmp_path / f"t_{name}"), arg)
        assert (tmp_path / f"j_{name}").read_bytes() == (tmp_path / f"t_{name}").read_bytes()
    back = texr.read_exr(str(tmp_path / "j_film.exr"))
    np.testing.assert_array_equal(back["R"], film["color"][..., 0].astype(np.float16)
                                  .astype(np.float32))


def test_obj_loader_across_packages(tmp_path):
    """examples/cornell.obj and test_io.py's quad + tri file."""
    small = tmp_path / "m.obj"
    small.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 2 0 0\nvn 0 0 1\n"
                     "usemtl white\nf 1//1 2//1 3//1 4//1\nf 1//1 2//1 5//1\n")
    for path in (ROOT / "examples" / "cornell.obj", small):
        jm, tm = jobj.load_obj(str(path)), tobj.load_obj(str(path))
        assert len(jm) == len(tm) > 0
        for a, b in zip(jm, tm):
            assert (a.name, a.material, a.smooth) == (b.name, b.material, b.smooth)
            for f in ("vertices", "faces", "normals", "uvs"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f)
    assert tobj.load_obj(str(small))[0].faces.shape == (3, 3)


def _ply_files(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 1]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (5, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]], np.float32)
    polys = [[0, 1, 2, 3], [0, 1, 4]]
    props = "".join(f"property float {p}\n" for p in ("x", "y", "z", "nx", "ny", "nz", "s", "t"))
    files = []
    ascii_ply = tmp_path / "m.ply"
    with open(ascii_ply, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment test\nelement vertex 5\n" + props
                + "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
        for i in range(5):
            row = list(verts[i]) + list(normals[i]) + list(uvs[i])
            f.write(" ".join(str(float(x)) for x in row) + "\n")
        for poly in polys:
            f.write(f"{len(poly)} " + " ".join(map(str, poly)) + "\n")
    files.append(ascii_ply)
    for tag, bo in (("binary_little_endian", "<"), ("binary_big_endian", ">")):
        path = tmp_path / f"m_{tag}.ply"
        with open(path, "wb") as f:
            f.write((f"ply\nformat {tag} 1.0\nelement vertex 5\n" + props
                     + "element face 2\nproperty list uchar int vertex_indices\n"
                     + "end_header\n").encode())
            f.write(np.concatenate([verts, normals, uvs], axis=1).astype(bo + "f4").tobytes())
            for poly in polys:
                f.write(np.uint8(len(poly)).tobytes())
                f.write(np.asarray(poly, bo + "i4").tobytes())
        files.append(path)
    return files, verts


def test_ply_ascii_and_binary_across_packages(tmp_path):
    files, verts = _ply_files(tmp_path)
    for path in files:
        (jm,), (tm,) = jply.load_ply(str(path)), tply.load_ply(str(path))
        for f in ("vertices", "faces", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f), err_msg=f"{path} {f}")
        np.testing.assert_allclose(tm.vertices, verts)
        np.testing.assert_array_equal(tm.faces, [[0, 1, 2], [0, 2, 3], [0, 1, 4]])
    scene = TScene()
    tyaml.import_scene_data(str(files[0]), scene)  # the dispatch by extension
    assert scene.meshes[0].faces.shape == (3, 3)


NODE_SPECS = {
    "diffuse": {"shaders": [
        {"name": "diffuse_bsdf_node", "layer": "d",
         "parameters": [{"name": "Cs", "type": "rgb", "value": [0.5, 0.25, 0.125]}]},
        {"name": "material_node", "layer": "root"}],
        "connect": [{"from": {"layer": "d", "slot": "Cout"},
                     "to": {"layer": "root", "slot": "Cs"}}]},
    "glossy_rough": {"shaders": [{"name": "glossy_bsdf_node", "layer": "g", "parameters": [
        {"name": "roughness", "type": "float", "value": 0.3}]}]},
    "glossy_sharp": {"shaders": [{"name": "glossy_bsdf_node", "layer": "g", "parameters": [
        {"name": "distribution", "type": "string", "value": "sharp"}]}]},
    "mix": {"shaders": [
        {"name": "diffuse_bsdf_node", "layer": "a"},
        {"name": "diffuse_bsdf_node", "layer": "b",
         "parameters": [{"name": "roughness", "type": "float", "value": 20.0}]},
        {"name": "mix_closure_node", "layer": "mix",
         "parameters": [{"name": "fac", "type": "float", "value": 0.25}]}],
        "connect": [{"from": {"layer": "a", "slot": "Cout"}, "to": {"layer": "mix", "slot": "A"}},
                    {"from": {"layer": "b", "slot": "Cout"},
                     "to": {"layer": "mix", "slot": "B"}}]},
    "ramp": {"shaders": [
        {"name": "color_ramp_node", "layer": "ramp", "parameters": [
            {"name": "ramp", "type": "rgb[]", "value": [[0, 0, 0], [1, 0, 0], [1, 1, 1]]},
            {"name": "at", "type": "float", "value": 0.25}]},
        {"name": "diffuse_bsdf_node", "layer": "d"}],
        "connect": [{"from": {"layer": "ramp", "slot": "Cout"},
                     "to": {"layer": "d", "slot": "Cs"}}]},
}


@pytest.mark.parametrize("name", sorted(NODE_SPECS))
def test_compile_material_across_packages(name):
    spec = NODE_SPECS[name]
    _assert_materials_equal(jyaml.compile_material(name, spec),
                            tyaml.compile_material(name, spec))


def test_color_ramp_node_in_the_port():
    """test_io.py's ramp: lerp at 0.25, nearest-below without
    interpolation, clamped past the end."""
    spec = {k: [dict(s) for s in v] for k, v in NODE_SPECS["ramp"].items()}
    np.testing.assert_allclose(tyaml.compile_material("r", spec).lobes[0].weight, (0.5, 0, 0))
    spec["shaders"][0]["parameters"] = spec["shaders"][0]["parameters"] + [
        {"name": "interpolate", "type": "int", "value": 0}]
    np.testing.assert_allclose(tyaml.compile_material("r", spec).lobes[0].weight, (0, 0, 0))
    spec["shaders"][0]["parameters"] = [
        {"name": "ramp", "type": "rgb[]", "value": [[0, 0, 0], [1, 0, 0], [1, 1, 1]]},
        {"name": "at", "type": "float", "value": 2.0}]
    np.testing.assert_allclose(tyaml.compile_material("r", spec).lobes[0].weight, (1, 1, 1))


def test_unknown_node_error_mentions_registry():
    spec = {"shaders": [{"name": "no_such_node", "layer": "x"},
                        {"name": "material_node", "layer": "root"}],
            "connect": [{"from": {"layer": "x", "slot": "Cout"},
                         "to": {"layer": "root", "slot": "Cs"}}]}
    for mod in (jyaml, tyaml):
        with pytest.raises(ValueError, match="register_shader_node"):
            mod.compile_material("m", spec)


def test_import_cornell_yaml_across_packages():
    """examples/cornell.yaml (with cornell.obj): the same materials, the
    same camera, and equal built scenes."""
    js, ts = jyaml.import_scene(str(CORNELL)), tyaml.import_scene(str(CORNELL))
    assert len(js.materials) == len(ts.materials) and len(ts.meshes) == len(js.meshes) > 0
    for a, b in zip(js.materials, ts.materials):
        _assert_materials_equal(a, b)
    np.testing.assert_array_equal(js.camera.to_world, ts.camera.to_world)
    assert (js.camera.width, js.camera.height, js.camera.fov) == \
        (ts.camera.width, ts.camera.height, ts.camera.fov)
    _assert_built_equal(js, ts)


def test_npz_scene_data_across_packages(tmp_path):
    """test_io.py's npz mesh bundle through the YAML data: list."""
    np.savez(tmp_path / "mesh.npz", n_meshes=1,
             vertices=np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
             faces=np.array([[0, 1, 2]], np.int32), material="white", smooth=False)
    text = CORNELL.read_text()
    (tmp_path / "scene.yaml").write_text(text.replace("cornell.obj", "mesh.npz"))
    js = jyaml.import_scene(str(tmp_path / "scene.yaml"))
    ts = tyaml.import_scene(str(tmp_path / "scene.yaml"))
    assert len(ts.meshes) == 1
    _assert_built_equal(js, ts)


def test_custom_node_bakes_a_torch_function_as_jax_bakes_jnp():
    """A registered stripes node bakes a torch function in the port and
    the same function in jnp in the JAX package: the textures equal within
    1e-6. The registries are separate: a node registered in one package is
    unknown to the other."""
    baked = {}

    def loader(tag):
        def load(img):
            baked[tag] = np.asarray(img)
            return 7
        return load

    def stripes(sin, cat):
        def node(p, ctx):
            freq = float(p.get("frequency", 4.0))

            def f(uv):
                s = 0.5 + 0.5 * sin(uv[:, :1] * 2 * np.pi * freq)
                return cat([s, s * 0.2, 1.0 - s], 1)
            return ctx.texture_ref(ctx.bake(f, res=16))
        return node

    spec = {"shaders": [
        {"name": "stripes_texture_node", "layer": "t",
         "parameters": [{"name": "frequency", "type": "float", "value": 8.0}]},
        {"name": "diffuse_bsdf_node", "layer": "d"},
        {"name": "material_node", "layer": "root"}],
        "connect": [{"from": {"layer": "t", "slot": "Cout"}, "to": {"layer": "d", "slot": "Cs"}},
                    {"from": {"layer": "d", "slot": "Cout"},
                     "to": {"layer": "root", "slot": "Cs"}}]}
    tyaml.register_shader_node("stripes_texture_node", stripes(torch.sin, torch.cat))
    try:
        with pytest.raises(ValueError, match="register_shader_node"):
            jyaml.compile_material("m", spec, loader("none"))
        jyaml.register_shader_node("stripes_texture_node", stripes(jnp.sin, jnp.concatenate))
        jm = jyaml.compile_material("m", spec, loader("jax"))
        tm = tyaml.compile_material("m", spec, loader("port"))
    finally:
        jyaml._CUSTOM_NODES.pop("stripes_texture_node", None)
        tyaml._CUSTOM_NODES.pop("stripes_texture_node", None)
    assert tm.lobes[0].texture == jm.lobes[0].texture == 7
    assert baked["port"].shape == (16, 16, 3) and baked["port"].dtype == np.float32
    np.testing.assert_allclose(baked["port"], baked["jax"], rtol=0, atol=1e-6)
    assert np.ptp(baked["port"][..., 0]) > 0.5  # the stripes really vary


def test_write_exr_of_a_rendered_film_reads_back(tmp_path):
    """io/exr.write_film of a port render: read back bit for bit (float)."""
    import phosphorus_mk2_tpu_torch as pt

    scene = tyaml.import_scene(str(CORNELL))
    scene.camera.width = scene.camera.height = 8
    img = pt.Renderer(scene, pt.Options(use_bvh=False, samples_per_pixel=1, path_depth=2),
                      device="cpu").render()
    path = str(tmp_path / "film.exr")
    texr.write_film(path, img, pixel_type="float")
    back = texr.read_exr(path)
    for i, c in enumerate("RGB"):
        np.testing.assert_array_equal(back[c], img["color"][..., i])
    np.testing.assert_array_equal(back["A"], img["alpha"])

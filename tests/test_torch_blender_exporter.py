"""The port's Blender exporter (phosphorus_mk2_tpu_torch/blender/exporter.py)
against the JAX add-on's (plugins/blender/phosphorus_tpu/exporter.py).

Both exporters read the same duck-typed depsgraph objects, built with the
JAX add-on tests' own helpers (tests/test_blender_exporter.py), and must
return the same materials, meshes, textures, environment and camera,
field by field and equal, not close: both are host-side numpy and Python
float arithmetic in the same order. The JAX export's built SceneData,
carried across with convert.scene_data_from_numpy, must equal the port
export's Scene.build(device="cpu") array for array.
"""
import dataclasses
import sys
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu_torch.tools import blender_stub

blender_stub.install()

from phosphorus_mk2_tpu.core.scene import Scene as JScene  # noqa: E402
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData  # noqa: E402
from phosphorus_mk2_tpu_torch.blender import exporter as texp  # noqa: E402
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy  # noqa: E402
from phosphorus_mk2_tpu_torch.core.scene import Scene as TScene  # noqa: E402

sys.path.insert(0, "plugins/blender")

from phosphorus_tpu import exporter as jexp  # noqa: E402

from tests.test_blender_exporter import (  # noqa: E402
    _bl_scene,
    _cube_mesh,
    _gnode,
    _image,
    _mat,
    _node,
    _obj,
    _sock,
)

torch.set_num_threads(1)

EYE = np.eye(4, dtype=np.float32)


def _same(a, b, path="value"):
    """a (JAX) and b (port) equal: dataclasses field by field (the two
    packages' classes of one name), arrays in dtype and value, the rest
    with ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _same_scene(j, t):
    assert vars(j).keys() == vars(t).keys()
    for k in vars(j):
        _same(vars(j)[k], vars(t)[k], f"scene.{k}")


# ---- the stub inputs -------------------------------------------------------

def _principled(**inputs):
    base = {"Base Color": (0.8, 0.4, 0.2, 1.0), "Roughness": 0.3, "Metallic": 0.0,
            "IOR": 1.45, "Emission Color": (0, 0, 0, 1), "Emission Strength": 0.0}
    return _node("ShaderNodeBsdfPrincipled", **{**base, **inputs})


def _textured(idname, sock, tex, **more):
    """A node whose colour input `sock` is driven by texture node `tex`."""
    entries = [(sock, _sock((0.5, 0.5, 0.5, 1.0), link=tex))]
    entries += [(k, _sock(v)) for k, v in more.items()]
    return _gnode(idname, entries)


def _normal_mapped(idname, **inputs):
    tex = _gnode("ShaderNodeTexImage", [], image=_image("nrm", 4, 2))
    nm = _gnode("ShaderNodeNormalMap", [("Color", _sock((0.5, 0.5, 1.0, 1.0), link=tex))])
    entries = [(k, _sock(v)) for k, v in inputs.items()] + [("Normal", _sock(link=nm))]
    return _gnode(idname, entries)


def _mix(fac, a, b, fac_link=None):
    return _gnode("ShaderNodeMixShader", [("Fac", _sock(fac, link=fac_link)),
                                          ("Shader", _sock(link=a)), ("Shader", _sock(link=b))])


DIFF = lambda c=(0.6, 0.3, 0.1, 1.0), r=0.0: _node("ShaderNodeBsdfDiffuse", Color=c,  # noqa: E731
                                                   Roughness=r)
GLOSS = lambda r=0.3: _node("ShaderNodeBsdfGlossy", Color=(0.9, 0.9, 0.8, 1), Roughness=r)  # noqa
EMIT = lambda: _node("ShaderNodeEmission", Color=(1.0, 0.5, 0.25, 1.0), Strength=4.0)  # noqa


def _tex_image():
    return _gnode("ShaderNodeTexImage", [], image=_image("albedo", 3, 2))


# one entry per node mapping and per JAX exporter test: a list of
# materials converted in turn with one scene and one texture cache
MATERIALS = {
    "diffuse": lambda: [_mat("d", DIFF())],
    "diffuse_oren_nayar": lambda: [_mat("d", DIFF(r=0.4))],
    "glossy_rough": lambda: [_mat("g", GLOSS(0.4))],
    "glossy_mirror": lambda: [_mat("g", GLOSS(0.0))],
    "glossy_default_roughness": lambda: [_mat("g", _node("ShaderNodeBsdfGlossy",
                                                         Color=(1, 1, 1, 1)))],
    "anisotropic": lambda: [_mat("a", _node("ShaderNodeBsdfAnisotropic",
                                            Color=(0.7, 0.7, 0.7, 1), Roughness=0.2))],
    "refraction": lambda: [_mat("r", _node("ShaderNodeBsdfRefraction", Color=(1, 1, 1, 1),
                                           IOR=1.45, Roughness=0.0))],
    "refraction_rough": lambda: [_mat("r", _node("ShaderNodeBsdfRefraction",
                                                 Color=(0.9, 1, 1, 1), IOR=1.33,
                                                 Roughness=0.2))],
    "glass": lambda: [_mat("gl", _node("ShaderNodeBsdfGlass", Color=(1, 1, 1, 1), IOR=1.5,
                                       Roughness=0.0))],
    "glass_rough": lambda: [_mat("gl", _node("ShaderNodeBsdfGlass", Color=(1, 0.9, 1, 1),
                                             IOR=1.6, Roughness=0.1))],
    "velvet": lambda: [_mat("v", _node("ShaderNodeBsdfVelvet", Color=(0.5, 0.2, 0.7, 1),
                                       Sigma=0.3))],
    "sheen": lambda: [_mat("s", _node("ShaderNodeBsdfSheen", Color=(0.5, 0.2, 0.7, 1),
                                      Roughness=0.6))],
    "transparent": lambda: [_mat("t", _node("ShaderNodeBsdfTransparent",
                                            Color=(0.9, 0.8, 0.7, 1)))],
    "emission": lambda: [_mat("e", EMIT())],
    "principled_emissive": lambda: [_mat("p", _principled(
        **{"Emission Color": (1, 0, 0, 1), "Emission Strength": 3.0}))],
    "principled_mid_metallic": lambda: [_mat("p", _principled(
        Metallic=0.4, **{"Specular IOR Level": 0.5}))],
    "principled_metal": lambda: [_mat("p", _principled(Metallic=1.0))],
    "principled_transmission_blender4": lambda: [_mat("pt", _principled(
        Roughness=0.0, IOR=1.5, **{"Base Color": (1, 1, 1, 1), "Specular IOR Level": 0.5,
                                   "Transmission Weight": 1.0}))],
    "principled_blender3_names": lambda: [_mat("p3", _principled(
        Specular=0.25, Transmission=0.5))],
    "principled_blender4_before_3": lambda: [_mat("p4", _principled(
        Specular=0.9, Transmission=0.9,
        **{"Specular IOR Level": 0.3, "Transmission Weight": 0.2}))],
    "principled_no_coat": lambda: [_mat("p", _principled(**{"Specular IOR Level": 0.0}))],
    "principled_defaults": lambda: [_mat("p", _node("ShaderNodeBsdfPrincipled"))],
    "unknown_node": lambda: [_mat("u", _node("ShaderNodeWeirdFuture"))],
    "non_node_material": lambda: [NS(name="plain", use_nodes=False, node_tree=None,
                                     diffuse_color=(0.3, 0.6, 0.9, 1.0))],
    "no_surface_link": lambda: [NS(name="nolink", use_nodes=True, diffuse_color=(1, 1, 1, 1),
                                   node_tree=NS(nodes=[DIFF()]))],
    "mix_scales_lobes": lambda: [_mat("mix", _mix(0.25, DIFF((1, 0, 0, 1)), GLOSS()))],
    "mix_of_nothing": lambda: [_mat("mix0", _gnode("ShaderNodeMixShader",
                                                   [("Fac", _sock(0.5))]))],
    "mix_fresnel": lambda: [_mat("fmix", _mix(
        0.5, DIFF((1, 1, 1, 1)), GLOSS(0.0), fac_link=_gnode("ShaderNodeFresnel",
                                                             [("IOR", _sock(1.6))])))],
    "mix_fresnel_over_glass": lambda: [_mat("fglass", _mix(
        0.5, DIFF(), _node("ShaderNodeBsdfGlass", Color=(1, 1, 1, 1), IOR=1.5, Roughness=0.0),
        fac_link=_gnode("ShaderNodeFresnel", [("IOR", _sock(1.3))])))],
    "add_unions_lobes_and_emission": lambda: [_mat("add", _gnode(
        "ShaderNodeAddShader", [("Shader", _sock(link=EMIT())),
                                ("Shader", _sock(link=DIFF((0.2, 0.2, 0.2, 1))))]))],
    "nested_mix_add": lambda: [_mat("nest", _mix(0.7, _gnode(
        "ShaderNodeAddShader", [("Shader", _sock(link=GLOSS())),
                                ("Shader", _sock(link=EMIT()))]), DIFF()))],
    "image_on_diffuse_cached": lambda: (lambda d: [_mat("tex", d), _mat("tex2", d)])(
        _textured("ShaderNodeBsdfDiffuse", "Color", _tex_image(), Roughness=0.0)),
    "environment_texture_on_emission": lambda: [_mat("env", _textured(
        "ShaderNodeEmission", "Color", _gnode("ShaderNodeTexEnvironment", [],
                                              image=_image("sky", 4, 2)), Strength=2.0))],
    "image_without_image": lambda: [_mat("noimg", _textured(
        "ShaderNodeBsdfDiffuse", "Color", _gnode("ShaderNodeTexImage", [], image=None)))],
    "checker_on_glossy": lambda: [_mat("chk", _textured(
        "ShaderNodeBsdfGlossy", "Color", _gnode("ShaderNodeTexChecker", [
            ("Color1", _sock((0.9, 0.1, 0.1, 1))), ("Color2", _sock((0.1, 0.1, 0.9, 1))),
            ("Scale", _sock(6.0))]), Roughness=0.25))],
    "noise_on_principled_base": lambda: [_mat("noise", _textured(
        "ShaderNodeBsdfPrincipled", "Base Color",
        _gnode("ShaderNodeTexNoise", [("Scale", _sock(3.0))]), Metallic=0.5,
        Roughness=0.4))],
    "unknown_texture_node": lambda: [_mat("unk", _textured(
        "ShaderNodeBsdfDiffuse", "Color", _gnode("ShaderNodeTexWave", [])))],
    "normal_map_on_diffuse": lambda: [_mat("nmap", _normal_mapped(
        "ShaderNodeBsdfDiffuse", Color=(0.8, 0.8, 0.8, 1), Roughness=0.0))],
    "normal_map_on_glossy": lambda: [_mat("nmapg", _normal_mapped(
        "ShaderNodeBsdfGlossy", Color=(0.8, 0.8, 0.8, 1), Roughness=0.2))],
    "normal_map_on_principled": lambda: [_mat("nmapp", _normal_mapped(
        "ShaderNodeBsdfPrincipled", Roughness=0.5, Metallic=0.0, IOR=1.45))],
    "normal_map_through_mix": lambda: [_mat("nmix", _mix(
        0.5, DIFF(), _normal_mapped("ShaderNodeBsdfGlossy", Color=(1, 1, 1, 1),
                                    Roughness=0.2)))],
}


@pytest.mark.parametrize("with_scene", [True, False], ids=["scene", "no_scene"])
@pytest.mark.parametrize("case", sorted(MATERIALS))
def test_convert_material_matches_jax(case, with_scene):
    """Each node mapping: lobes (type, weight, params: roughness, IOR,
    fresnel mode), emission, the texture and normal-map ids and the
    textures the scene received (without a scene textures degrade to
    their colours in both)."""
    mats = MATERIALS[case]()
    out = {}
    for name, mod, scene_cls in (("jax", jexp, JScene), ("port", texp, TScene)):
        scene, cache = (scene_cls(), {}) if with_scene else (None, None)
        got = [mod.convert_material(m, scene=scene, tex_cache=cache) for m in mats]
        out[name] = (got, scene.textures if with_scene else None, cache)
    _same(out["jax"][0], out["port"][0], "materials")
    if with_scene:
        _same(out["jax"][1], out["port"][1], "textures")
        assert out["jax"][2].keys() == out["port"][2].keys()


def test_the_cases_cover_every_mapping():
    """Every node idname the JAX exporter maps appears in a case."""
    import ast
    import inspect

    seen = set()
    for build in MATERIALS.values():
        stack = list(build())
        while stack:
            x = stack.pop()
            for v in vars(x).values() if isinstance(x, NS) else ():
                stack.append(v)
            if isinstance(x, NS) and hasattr(x, "bl_idname"):
                seen.add(x.bl_idname)
            if hasattr(x, "sockets"):
                stack += list(x.sockets)
            if hasattr(x, "_kv"):
                stack += list(x._kv.values())
            if isinstance(x, list):
                stack += x
    named = {n.value for n in ast.walk(ast.parse(inspect.getsource(jexp)))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)
             and n.value.startswith("ShaderNode")}
    assert named - {"ShaderNodeOutputMaterial", "ShaderNodeBackground"} <= seen, named - seen


# ---- whole scenes ----------------------------------------------------------

def _transformed():
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[0.0, -2.0, 0.0], [1.5, 0.0, 0.0], [0.0, 0.0, 0.5]]  # rotate, scale
    m[:3, 3] = [0.25, -1.0, 3.0]
    return m


def _corner_mesh():
    """The JAX corner-attribute test's mesh: two triangles with a hard
    edge between them and a uv seam."""
    cube = _cube_mesh()
    tris = [NS(vertices=(0, 1, 2), material_index=0, use_smooth=True, loops=(0, 1, 2)),
            NS(vertices=(1, 3, 2), material_index=1, use_smooth=True, loops=(3, 4, 5))]
    loops = [NS(normal=(0, 0, 1)) for _ in range(3)] + [NS(normal=(1, 0, 0))
                                                         for _ in range(3)]
    uvdata = [NS(uv=(i * 0.1, i * 0.2)) for i in range(6)]
    return NS(vertices=cube.vertices, loop_triangles=tris, loops=loops,
              uv_layers=NS(active=NS(data=uvdata)), calc_loop_triangles=lambda: None,
              calc_normals_split=lambda: None)


def _scene_end_to_end():
    emit = _mat("lamp", _node("ShaderNodeEmission", Color=(1, 1, 1, 1), Strength=5.0))
    inst = NS(object=_obj("cube", _cube_mesh(), emit), matrix_world=EYE)
    return NS(object_instances=[inst]), _bl_scene()


def _scene_corners():
    inst = NS(object=_obj("hard", _corner_mesh(), None), matrix_world=EYE)
    return NS(object_instances=[inst]), _bl_scene()


def _scene_rich():
    """Several objects: a transformed one (vertex and corner normals
    through the inverse transpose), shared and per-slot materials, a
    slot index past the slots (the default material), textures of every
    kind, a non-mesh object; the world's Background; DoF focused on an
    object at 50% resolution."""
    textured = _mat("albedo", _textured("ShaderNodeBsdfDiffuse", "Color", _tex_image(),
                                        Roughness=0.0))
    glass = _mat("glass", _node("ShaderNodeBsdfGlass", Color=(1, 1, 1, 1), IOR=1.5,
                                Roughness=0.0))
    metal = _mat("metal", _normal_mapped("ShaderNodeBsdfPrincipled", Metallic=1.0,
                                         Roughness=0.2))
    cube = _cube_mesh()
    cube.loop_triangles[1].material_index = 1
    cube.loop_triangles[3].material_index = 5  # past the slots: the default material
    corner = _obj("corner", _corner_mesh(), glass)
    corner.material_slots.append(NS(material=metal))
    cube_obj = _obj("cube", cube, textured)
    cube_obj.material_slots.append(NS(material=None))
    insts = [NS(object=cube_obj, matrix_world=EYE),
             NS(object=corner, matrix_world=_transformed()),
             NS(object=NS(type="LIGHT", name="sun"), matrix_world=EYE),
             NS(object=_obj("again", _cube_mesh(), glass), matrix_world=_transformed().T)]
    bl = _bl_scene()
    bl.render.resolution_percentage = 50
    focus = np.eye(4, dtype=np.float32)
    focus[:3, 3] = [0.5, 2.0, -4.0]
    bl.camera.data.dof.focus_object = NS(matrix_world=focus)
    bl.camera.matrix_world = _transformed()
    return NS(object_instances=insts), bl


def _scene_world_color_no_dof():
    inst = NS(object=_obj("cube", _cube_mesh(), _mat("d", DIFF())), matrix_world=EYE)
    bl = _bl_scene()
    bl.world = NS(use_nodes=False, node_tree=None, color=(0.1, 0.2, 0.3))
    bl.camera.data.dof.use_dof = False
    return NS(object_instances=[inst]), bl


def _scene_dark_world_no_camera():
    inst = NS(object=_obj("cube", _cube_mesh(), _mat("d", DIFF())), matrix_world=EYE)
    bl = _bl_scene()
    bl.world.node_tree.nodes[0].inputs.get("Strength").default_value = 0.0
    bl.camera = None
    return NS(object_instances=[inst]), bl


def _scene_no_world():
    inst = NS(object=_obj("cube", _cube_mesh(), _mat("e", EMIT())), matrix_world=EYE)
    bl = _bl_scene()
    bl.world = None
    return NS(object_instances=[inst]), bl


SCENES = {
    "end_to_end": _scene_end_to_end,
    "corner_attributes": _scene_corners,
    "rich": _scene_rich,
    "world_colour_no_dof": _scene_world_color_no_dof,
    "dark_world_no_camera": _scene_dark_world_no_camera,
    "no_world": _scene_no_world,
}


@pytest.mark.parametrize("case", sorted(SCENES))
def test_export_scene_matches_jax(case):
    """Meshes (world-baked vertices, normals, faces, per-face material
    ids, smooth flags, corner normals and uvs), materials, textures,
    the environment and the camera (DoF with and without a focus
    object), field by field."""
    depsgraph, bl = SCENES[case]()
    _same_scene(jexp.export_scene(depsgraph, bl), texp.export_scene(depsgraph, bl))


def _jax_arrays(jd):
    return {f.name: np.asarray(getattr(jd, f.name)) for f in dataclasses.fields(JSceneData)
            if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"}


@pytest.mark.parametrize("case", ["end_to_end", "corner_attributes", "rich", "no_world"])
def test_built_scene_carried_across_equals_the_port_build(case):
    """The JAX export's Scene.build() leaves, through
    scene_data_from_numpy, equal to the port export's build: the same
    device scene for both renderers, array for array."""
    depsgraph, bl = SCENES[case]()
    jd = jexp.export_scene(depsgraph, bl).build()
    static = {k: getattr(jd, k) for k in JSceneData.STATIC_FIELDS}
    carried = scene_data_from_numpy(_jax_arrays(jd), static, device="cpu")
    own = texp.export_scene(depsgraph, bl).build(device="cpu")
    assert own.tensor_fields() == carried.tensor_fields()
    for k in own.tensor_fields():
        a, b = getattr(carried, k), getattr(own, k)
        assert a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    for k in JSceneData.STATIC_FIELDS:
        assert getattr(own, k) == getattr(carried, k), k


def test_exporter_returns_host_arrays_only():
    """The exporter is host-side: a Scene of numpy arrays, no tensor."""
    depsgraph, bl = _scene_rich()
    scene = texp.export_scene(depsgraph, bl)
    for mesh in scene.meshes:
        for v in vars(mesh).values():
            assert not isinstance(v, torch.Tensor)
    assert isinstance(scene.camera.to_world, np.ndarray)

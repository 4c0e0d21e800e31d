"""A stand-in for the parts of Blender's ``bpy`` that the add-on
(``phosphorus_mk2_tpu_torch/blender/``) touches, so that the add-on can be
driven where Blender is not: by the tests on the CPU and by
``chip_smoke.py`` on the card. It is no part of the add-on.

- ``install()`` puts a ``bpy`` module into ``sys.modules`` unless one is
  there already (the JAX add-on's tests install their own the same way)
  and returns the one that is there;
- ``depsgraph_from_scene(scene, settings)`` presents a port ``Scene`` as
  an evaluated depsgraph: its meshes as objects with loop triangles,
  loops and the active uv layer, each material as a Principled or
  Diffuse node material, the environment as the world's Background
  node, the camera as a camera object;
- ``EngineHarness`` is the part of ``bpy.types.RenderEngine`` that the
  render loop calls, recorded: the RenderResult with its views, a rect
  per (pass, view) that keeps what ``foreach_set`` wrote, the
  ``update_result`` calls (with the host clock at each) and the
  ``update_progress`` values, and a ``test_break`` that fires after n
  polls;
- ``default_settings(**overrides)``: the add-on's render settings at the
  defaults its ``properties.py`` declares.

    from phosphorus_mk2_tpu_torch.tools import blender_stub
    blender_stub.install()
    from phosphorus_mk2_tpu_torch.blender.engine import PhosphorusRenderEngine

    class Engine(blender_stub.EngineHarness, PhosphorusRenderEngine):
        device = "cpu"

    eng = Engine()
    eng.render(blender_stub.depsgraph_from_scene(scene, blender_stub.default_settings()))
    eng.rect("Combined")          # (H * W * 4,) bottom-up rows
"""
from __future__ import annotations

import ast
import math
import os
import sys
import time
import types
from types import SimpleNamespace as NS

import numpy as np

from phosphorus_mk2_tpu_torch.core.material import (
    DIFFUSE,
    MICROFACET,
    MICROFACET_REFRACT,
    OREN_NAYAR,
    REFLECTION,
    REFRACTION,
)


class RenderEngine:
    """bpy.types.RenderEngine: the add-on's engine derives from it."""


class PropertyGroup:
    pass


class Panel:
    pass


class Scene:
    """bpy.types.Scene: register() sets its pointer property here."""


def install():
    """The bpy module in sys.modules: this stub, unless one is there."""
    bpy = types.ModuleType("bpy")
    bpy.types = NS(RenderEngine=RenderEngine, PropertyGroup=PropertyGroup, Panel=Panel,
                   Scene=Scene)
    bpy.props = NS(**{k: (lambda **keywords: None) for k in (
        "IntProperty", "BoolProperty", "FloatProperty", "PointerProperty",
        "StringProperty", "EnumProperty")})
    bpy.utils = NS(register_class=lambda cls: None, unregister_class=lambda cls: None)
    return sys.modules.setdefault("bpy", bpy)


def settings_defaults(path=None) -> dict:
    """{name: default} of the render settings declared in a property
    group's source (the add-on's ``properties.py`` unless ``path``), read
    from the source, so without any bpy."""
    path = path or os.path.join(os.path.dirname(os.path.dirname(__file__)), "blender",
                                "properties.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {node.target.id: ast.literal_eval(kw.value)
            for node in ast.walk(tree) if isinstance(node, ast.AnnAssign)
            for kw in node.annotation.keywords if kw.arg == "default"}


def default_settings(**overrides):
    """The add-on's render settings at their defaults, with ``overrides``."""
    fields = settings_defaults()
    unknown = set(overrides) - set(fields)
    if unknown:
        raise ValueError(f"not render settings: {sorted(unknown)}")
    return NS(**{**fields, **overrides})


# --- the depsgraph -----------------------------------------------------------

class _Vertex:
    __slots__ = ("co", "normal")

    def __init__(self, co, normal):
        self.co = co
        self.normal = normal


class _LoopTriangle:
    __slots__ = ("vertices", "material_index", "use_smooth", "loops")

    def __init__(self, vertices, material_index, use_smooth, loops):
        self.vertices = vertices
        self.material_index = material_index
        self.use_smooth = use_smooth
        self.loops = loops


class _Loop:
    __slots__ = ("normal",)

    def __init__(self, normal):
        self.normal = normal


class _LoopUV:
    __slots__ = ("uv",)

    def __init__(self, uv):
        self.uv = uv


def _node(idname, **inputs):
    """A shader node whose inputs, unlinked, hold ``inputs``."""
    return NS(bl_idname=idname, is_active_output=False,
              inputs={k: NS(default_value=v, links=[]) for k, v in inputs.items()})


def _node_material(name, node):
    """A node material whose active output's Surface is ``node``."""
    surface = NS(name="Surface", default_value=None, links=[NS(from_node=node)])
    out = NS(bl_idname="ShaderNodeOutputMaterial", is_active_output=True,
             inputs=NS(get=lambda n: surface if n == "Surface" else None))
    return NS(name=name, use_nodes=True, node_tree=NS(nodes=[node, out]),
              diffuse_color=(0.8, 0.8, 0.8, 1.0))


def _rgba(c):
    return (float(c[0]), float(c[1]), float(c[2]), 1.0)


def _bl_material(mat, name):
    """A Principled or Diffuse node material standing for a port
    Material: emission through Principled's Blender 4 emission sockets,
    a diffuse first lobe through the Diffuse node, any other first lobe
    through Principled (metallic for a reflecting lobe, transmission
    where a lobe refracts). An approximation: the exporter's result, not
    the material, is what renders."""
    if mat.is_emitter:
        # Material.emitter divides by pi: strength pi gives the emission back
        return _node_material(name, _node(
            "ShaderNodeBsdfPrincipled", **{"Base Color": (0.0, 0.0, 0.0, 1.0),
                                           "Emission Color": _rgba(mat.emission),
                                           "Emission Strength": math.pi}))
    lobe = mat.lobes[0]
    if lobe.type in (DIFFUSE, OREN_NAYAR):
        rough = lobe.params[0] if lobe.type == OREN_NAYAR else 0.0
        return _node_material(name, _node("ShaderNodeBsdfDiffuse", Color=_rgba(lobe.weight),
                                         Roughness=float(rough)))
    types_ = {lo.type for lo in mat.lobes}
    refracts = bool(types_ & {REFRACTION, MICROFACET_REFRACT})
    ior = next((lo.padded_params()[5] for lo in mat.lobes if lo.padded_params()[5]), 1.45)
    return _node_material(name, _node(
        "ShaderNodeBsdfPrincipled", **{
            "Base Color": _rgba(lobe.weight),
            "Roughness": 0.0 if lobe.type in (REFLECTION, REFRACTION) else 0.3,
            "Metallic": 0.0 if refracts else float(lobe.type in (REFLECTION, MICROFACET)),
            "IOR": float(ior),
            "Specular IOR Level": 0.5,
            "Transmission Weight": float(refracts),
            "Emission Color": (0.0, 0.0, 0.0, 1.0),
            "Emission Strength": 0.0}))


def _bl_mesh(mesh, slot_index):
    """A bpy Mesh of a port Mesh: vertices (co, normal), loop triangles
    (face i's material slot ``slot_index[i]``), a loop per corner (its
    normal) and the active uv layer (when the mesh has uvs)."""
    normals = mesh.normals if mesh.normals is not None else mesh.compute_vertex_normals()
    smooth = np.broadcast_to(np.asarray(mesh.smooth, bool), (mesh.num_faces,))
    out = NS(
        vertices=[_Vertex(tuple(c), tuple(n))
                  for c, n in zip(mesh.vertices.tolist(), normals.tolist())],
        loop_triangles=[
            _LoopTriangle(tuple(f), i, s, (3 * k, 3 * k + 1, 3 * k + 2))
            for k, (f, i, s) in enumerate(zip(mesh.faces.tolist(), slot_index.tolist(),
                                              smooth.tolist()))],
        calc_loop_triangles=lambda: None, calc_normals_split=lambda: None)
    corner_n = mesh.corner_normals if mesh.corner_normals is not None else normals[mesh.faces]
    out.loops = [_Loop(tuple(n)) for n in corner_n.reshape(-1, 3).tolist()]
    corner_uv = (mesh.corner_uvs if mesh.corner_uvs is not None
                 else mesh.uvs[mesh.faces] if mesh.uvs is not None else None)
    if corner_uv is not None:
        out.uv_layers = NS(active=NS(data=[_LoopUV(tuple(uv))
                                           for uv in corner_uv.reshape(-1, 2).tolist()]))
    return out


def depsgraph_from_scene(scene, settings):
    """An evaluated depsgraph that presents the port Scene ``scene``: one
    object a mesh (world space, so an identity matrix_world), with a
    material slot for each material its faces use, in first-use order;
    one node material for each port material, named after it; the
    environment as the world's Background node (strength 1); the camera
    with its resolution. ``settings`` becomes the scene's
    ``phosphorus_tpu_torch``."""
    bl_mats = {}
    instances = []
    for mesh in scene.meshes:
        face_mat = scene._resolve_face_materials(mesh)
        slots = list(dict.fromkeys(face_mat.tolist()))  # first use first
        lookup = np.zeros(max(slots) + 1, np.int64)
        lookup[slots] = np.arange(len(slots))
        for mid in slots:
            if mid not in bl_mats:
                m = scene.materials[mid]
                bl_mats[mid] = _bl_material(m, m.name or f"material{mid}")
        bl = _bl_mesh(mesh, lookup[face_mat])
        obj = NS(type="MESH", name=mesh.name, to_mesh=lambda bl=bl: bl,
                 to_mesh_clear=lambda: None,
                 material_slots=[NS(material=bl_mats[mid]) for mid in slots])
        instances.append(NS(object=obj, matrix_world=np.eye(4, dtype=np.float32)))

    world = None
    if scene.environment is not None:
        bg = _node("ShaderNodeBackground",
                   Color=_rgba(scene.materials[scene.environment].emission), Strength=1.0)
        world = NS(use_nodes=True, node_tree=NS(nodes=[bg]), color=(0.0, 0.0, 0.0))
    cam = scene.camera
    dof = NS(use_dof=cam.aperture_radius > 0.0, focus_object=None,
             focus_distance=cam.focal_distance,
             aperture_fstop=(cam.focal_length / (2000.0 * cam.aperture_radius)
                             if cam.aperture_radius > 0.0 else 2.8))
    camera = NS(data=NS(lens=cam.focal_length, sensor_width=cam.sensor_width, dof=dof),
                matrix_world=np.asarray(cam.to_world, np.float32).T.copy())
    render = NS(resolution_x=cam.width, resolution_y=cam.height, resolution_percentage=100)
    bl_scene = NS(world=world, camera=camera, render=render, phosphorus_tpu_torch=settings)
    return NS(scene=bl_scene, object_instances=instances)


# --- the engine harness ------------------------------------------------------

class Rect:
    """A RenderPass's rect: keeps the last buffer foreach_set wrote."""

    def __init__(self):
        self.data = None
        self.writes = 0

    def foreach_set(self, flat):
        self.data = np.array(flat, np.float32)
        self.writes += 1


class Passes:
    """A render layer's passes, keyed by (name, view); a single-view
    result keys them by (name, None)."""

    def __init__(self, names, views):
        self._views = list(views) or [None]
        self._store = {(n, v): NS(name=n, rect=Rect()) for n in names for v in self._views}

    def find_by_name(self, name, view):
        return self._store.get((name, view))

    def __getitem__(self, name):  # the single-view mapping
        return self._store[(name, self._views[0])]


class EngineHarness:
    """What the render loop calls on bpy.types.RenderEngine, recorded.
    Put it first among a subclass's bases, before the engine class.

    views: the result's view names (empty: a single-view result);
    break_after: test_break answers True from poll break_after + 1 on
    (None: never); eye_offset: camera_model_matrix moves the "right"
    eye this far along the camera's x column."""

    def __init__(self, views=(), break_after=None, eye_offset=0.35):
        self.views = list(views)
        self.break_after = break_after
        self.eye_offset = eye_offset
        self.pass_names = ["Combined"]
        self.result = None
        self.polls = 0
        self.updates = 0
        self.update_times = []  # host clock at each update_result
        self.progress = []
        self.active_views = []
        self.ended = False

    def add_pass(self, name, channels, chan_id, layer=""):
        self.pass_names.append(name)

    def begin_result(self, x, y, w, h, layer="", view=""):
        self.result = NS(views=[NS(name=v) for v in self.views],
                         layers=[NS(passes=Passes(self.pass_names, self.views))])
        return self.result

    def update_result(self, result):
        self.updates += 1
        self.update_times.append(time.perf_counter())

    def end_result(self, result, cancel=False, highlight=False, do_merge_results=False):
        self.ended = True

    def update_progress(self, value):
        self.progress.append(value)

    def test_break(self):
        self.polls += 1
        return self.break_after is not None and self.polls > self.break_after

    def active_view_set(self, name):
        self.active_views.append(name)

    def camera_model_matrix(self, camera, use_spherical_stereo=False):
        m = np.array(camera.matrix_world, np.float32, copy=True)
        if self.active_views and self.active_views[-1] == "right":
            m[0, 3] += self.eye_offset
        return m

    def rect(self, name, view=None):
        """What the render wrote last into pass ``name`` of ``view``, or
        None (a pass the render never wrote, or never registered)."""
        p = self.result.layers[0].passes.find_by_name(name, view)
        return None if p is None else p.rect.data

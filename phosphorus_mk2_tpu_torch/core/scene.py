"""Scene container and device scene data.

Counterpart of ``phosphorus_mk2_tpu/core/scene.py`` (reference
src/scene.cpp:9-128): ``Scene`` owns meshes, materials and lights,
creates area lights from emissive face sets and flattens all meshes into
one triangle soup. ``Scene.build(device=...)`` produces a ``SceneData``
of tensors with the same fields and static metadata as the JAX package:
the texture atlas of ``core/texture.pack_textures`` and, when a material
has a normal map, tangents computed for the meshes that lack them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.core.camera import Camera
from phosphorus_mk2_tpu_torch.core.material import Material, pack_materials
from phosphorus_mk2_tpu_torch.core.mesh import Mesh
from phosphorus_mk2_tpu_torch.core.texture import Texture, pack_textures
from phosphorus_mk2_tpu_torch.device import resolve_device
from phosphorus_mk2_tpu_torch.utils.profiling import spanned

LIGHT_POINT = 0
LIGHT_AREA = 1
LIGHT_INFINITE = 2


@dataclasses.dataclass
class SceneData:
    """Device scene: triangle soup + materials + lights.

    Tensor fields mirror the JAX ``SceneData`` leaves (same names, shapes
    and dtypes); STATIC_FIELDS hold the same static metadata.
    """

    # geometry (global soup)
    vertices: torch.Tensor        # (V, 3) f32
    faces: torch.Tensor           # (F, 3) i32
    normals: torch.Tensor         # (V, 3) f32
    uvs: torch.Tensor             # (V, 2) f32
    smooth: torch.Tensor          # (F,) bool
    tri_mat: torch.Tensor         # (F,) i32
    tri_mesh: torch.Tensor        # (F,) i32
    # materials (lobe arrays, see core/material.py)
    lobe_type: torch.Tensor       # (M, L) i32
    lobe_weight: torch.Tensor     # (M, L, 3) f32
    lobe_param: torch.Tensor      # (M, L, P) f32
    lobe_flags: torch.Tensor      # (M, L) i32
    n_lobes: torch.Tensor         # (M,) i32
    emission: torch.Tensor        # (M, 3) f32
    # lights
    light_type: torch.Tensor      # (NL,) i32
    light_mat: torch.Tensor       # (NL,) i32
    light_offset: torch.Tensor    # (NL,) i32 into light_tris
    light_count: torch.Tensor     # (NL,) i32
    light_area: torch.Tensor      # (NL,) f32
    light_tris: torch.Tensor      # (LT,) i32 global triangle ids
    # textures (atlas, see core/texture.py)
    tex_atlas: torch.Tensor = None      # (AH, AW, 3) f32 or f16
    tex_info: torch.Tensor = None       # (K, L, 4) i32 (y0, x0, h, w) a level
    lobe_tex: torch.Tensor = None       # (M, L) i32, -1 = untextured
    emission_tex: torch.Tensor = None   # (M,) i32
    normal_tex: torch.Tensor = None     # (M,) i32
    tangents: torch.Tensor = None       # (V, 3) f32 (zeros if none)
    tex_proc: torch.Tensor = None       # (K,) i32 procedural type a texture
    tex_proc_params: torch.Tensor = None  # (K, 4) f32
    # NEE area pdf per triangle (used by the MIS path only)
    tri_light_pdf: torch.Tensor = None  # (F,) f32
    # acceleration structure: the tables of accel/bvh_builder.attach_bvh
    # (name -> tensor), or None for the brute-force tracer
    bvh: dict | None = None
    # static metadata
    num_lights: int = 0
    env_mat: int = -1
    has_normals: bool = False
    has_uvs: bool = False
    lobe_types_present: tuple = ()
    max_lobes_used: int = 0
    has_textures: bool = False
    has_fresnel: bool = False
    has_normal_maps: bool = False
    has_procedural: bool = False

    STATIC_FIELDS = (
        "num_lights",
        "env_mat",
        "has_normals",
        "has_uvs",
        "lobe_types_present",
        "max_lobes_used",
        "has_textures",
        "has_fresnel",
        "has_normal_maps",
        "has_procedural",
    )

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    def tensor_fields(self) -> list[str]:
        return [
            f.name for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        ]

    def to(self, device) -> "SceneData":
        dev = resolve_device(device)
        moved = {k: getattr(self, k).to(dev) for k in self.tensor_fields()}
        if self.bvh is not None:
            moved["bvh"] = {k: v.to(dev) for k, v in self.bvh.items()}
        return dataclasses.replace(self, **moved)


class Scene:
    """Host-side scene under construction."""

    def __init__(self):
        self.meshes: list[Mesh] = []
        self.materials: list[Material] = []
        self._material_ids: dict[str, int] = {}
        self.textures: list = []
        self.camera: Camera = Camera()
        self.environment: int | None = None  # material id
        self.texture_dtype: str = "f32"  # "f16" halves the atlas bytes
        # and the gather traffic (filtering upcasts; see pack_textures)

    def add_texture(self, texture) -> int:
        if not isinstance(texture, Texture):
            texture = Texture(texture)
        self.textures.append(texture)
        return len(self.textures) - 1

    def add_material(self, material: Material) -> int:
        mid = len(self.materials)
        self.materials.append(material)
        if material.name:
            self._material_ids[material.name] = mid
        return mid

    def material_id(self, name: str) -> int:
        return self._material_ids[name]

    def material(self, ref) -> Material:
        if isinstance(ref, str):
            return self.materials[self._material_ids[ref]]
        return self.materials[ref]

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def set_environment(self, material) -> None:
        """Attach an infinite light driven by a background material."""
        if isinstance(material, Material):
            material = self.add_material(material)
        elif isinstance(material, str):
            material = self._material_ids[material]
        self.environment = material

    def _resolve_face_materials(self, mesh: Mesh) -> np.ndarray:
        mat = mesh.material
        if mat is None:
            raise ValueError(f"mesh {mesh.name!r} has no material")
        if isinstance(mat, str):
            mat = self._material_ids[mat]
        if isinstance(mat, (int, np.integer)):
            return np.full((mesh.num_faces,), int(mat), np.int32)
        return np.ascontiguousarray(mat, np.int32)

    @spanned("setup.scene_build")
    def build(self, device="cuda") -> SceneData:
        """Flatten to the device representation on ``device``, creating
        area lights from emissive face sets (reference src/mesh.cpp:108-116)."""
        dev = resolve_device(device)
        if not self.meshes:
            raise ValueError("scene has no meshes")

        needs_tangents = any(m.normal_texture >= 0 for m in self.materials)
        verts, faces, normals, uvs, smooth, tangents = [], [], [], [], [], []
        tri_mat, tri_mesh = [], []
        v_off = 0
        for mi, mesh in enumerate(self.meshes):
            mesh = mesh.resolve_corners()
            if needs_tangents and mesh.tangents is None and mesh.uvs is not None:
                # automatic tangents for normal-mapped scenes (the reference
                # generates MikkTSpace tangents only when a material asks
                # for geom:tangent, plugins/blender/import.hpp:115-134)
                mesh.tangents = mesh.compute_tangents()
            verts.append(mesh.vertices)
            faces.append(mesh.faces + v_off)
            n = mesh.normals
            if n is None:
                n = mesh.compute_vertex_normals()
            normals.append(n)
            tangents.append(
                mesh.tangents
                if mesh.tangents is not None
                else np.zeros((mesh.vertices.shape[0], 3), np.float32)
            )
            uvs.append(
                mesh.uvs
                if mesh.uvs is not None
                else np.zeros((mesh.vertices.shape[0], 2), np.float32)
            )
            s = mesh.smooth
            if isinstance(s, (bool, np.bool_)):
                s = np.full((mesh.num_faces,), bool(s))
            smooth.append(np.asarray(s, bool))
            tri_mat.append(self._resolve_face_materials(mesh))
            tri_mesh.append(np.full((mesh.num_faces,), mi, np.int32))
            v_off += mesh.vertices.shape[0]

        vertices = np.concatenate(verts)
        faces_arr = np.concatenate(faces)
        tri_mat_arr = np.concatenate(tri_mat)
        tri_mesh_arr = np.concatenate(tri_mesh)

        # area lights from emissive face sets; tri_light_pdf is the NEE
        # area pdf (1 / (num_lights * light area)) on light triangles
        light_rows = []
        light_tris: list[np.ndarray] = []
        tri_areas = _tri_areas(vertices, faces_arr)
        tri_light_pdf = np.zeros((faces_arr.shape[0],), np.float32)
        for mid, mat in enumerate(self.materials):
            if not mat.is_emitter or (self.environment == mid):
                continue
            sel = np.nonzero(tri_mat_arr == mid)[0]
            if sel.size == 0:
                continue
            area = float(tri_areas[sel].sum())
            light_rows.append(
                (LIGHT_AREA, mid, sum(t.size for t in light_tris), sel.size, area)
            )
            light_tris.append(sel.astype(np.int32))
            if area > 0.0:
                tri_light_pdf[sel] = 1.0 / area
        if self.environment is not None:
            light_rows.append((LIGHT_INFINITE, self.environment, 0, 0, 0.0))

        num_lights = len(light_rows)
        if num_lights == 0:
            # keep the tables non-empty; the integrator guards on
            # num_lights (the reference renders black without lights)
            light_rows.append((LIGHT_POINT, 0, 0, 0, 0.0))
        if not light_tris:
            light_tris.append(np.zeros((1,), np.int32))
        if num_lights > 0:
            tri_light_pdf /= num_lights

        mats = pack_materials(self.materials)
        atlas = pack_textures(self.textures, dtype=self.texture_dtype)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return SceneData(
            vertices=t(vertices),
            faces=t(faces_arr),
            normals=t(np.concatenate(normals)),
            uvs=t(np.concatenate(uvs)),
            smooth=t(np.concatenate(smooth)),
            tri_mat=t(tri_mat_arr),
            tri_mesh=t(tri_mesh_arr),
            lobe_type=t(mats["lobe_type"]),
            lobe_weight=t(mats["lobe_weight"]),
            lobe_param=t(mats["lobe_param"]),
            lobe_flags=t(mats["lobe_flags"]),
            n_lobes=t(mats["n_lobes"]),
            emission=t(mats["emission"]),
            light_type=t(np.array([r[0] for r in light_rows], np.int32)),
            light_mat=t(np.array([r[1] for r in light_rows], np.int32)),
            light_offset=t(np.array([r[2] for r in light_rows], np.int32)),
            light_count=t(np.array([r[3] for r in light_rows], np.int32)),
            light_area=t(np.array([r[4] for r in light_rows], np.float32)),
            light_tris=t(np.concatenate(light_tris)),
            tri_light_pdf=t(tri_light_pdf),
            tex_atlas=t(atlas["atlas"]),
            tex_info=t(atlas["info"]),
            lobe_tex=t(mats["lobe_tex"]),
            emission_tex=t(mats["emission_tex"]),
            normal_tex=t(mats["normal_tex"]),
            tangents=t(np.concatenate(tangents)),
            tex_proc=t(atlas["proc"]),
            tex_proc_params=t(atlas["proc_params"]),
            bvh=None,
            num_lights=num_lights,
            env_mat=-1 if self.environment is None else int(self.environment),
            has_normals=any(m.normals is not None for m in self.meshes),
            has_uvs=any(m.uvs is not None for m in self.meshes),
            lobe_types_present=tuple(
                sorted({lobe.type for m in self.materials for lobe in m.lobes})
            ),
            max_lobes_used=max((len(m.lobes) for m in self.materials), default=0),
            has_textures=len(self.textures) > 0,
            has_normal_maps=any(m.normal_texture >= 0 for m in self.materials),
            has_procedural=any(t.procedural != 0 for t in self.textures),
            has_fresnel=any(
                len(lobe.params) > 4 and lobe.params[4] != 0.0
                for m in self.materials
                for lobe in m.lobes
            ),
        )


def _tri_areas(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = vertices[faces[:, 0]]
    b = vertices[faces[:, 1]]
    c = vertices[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)

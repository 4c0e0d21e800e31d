"""Alembic (.abc) scene import/export via the pure-Python Ogawa stack.

Counterpart of ``phosphorus_mk2_tpu/io/alembic.py``, building the
port's Scene and Mesh; the archives are byte-equal to the JAX package's.

The reference walks Ogawa archives through the Alembic SDK
(reference src/codecs/scene/alembic.hpp:297: accumulated IXform
matrices, ICamera -> camera params, IPolyMesh -> mesh builder with
per-vertex vs per-face-vertex attribute detection, per-face-set material
binding by name, alembic.hpp:156-257). No SDK or binding exists in this
environment, so io/ogawa.py + io/abc.py implement the container and
property layers natively and this module reproduces the importer
semantics on top:

  * IXform matrices accumulate down the tree; vertices are baked to
    world space, normals transformed by the inverse-transpose
    (alembic.hpp:22,156-257);
  * ICamera: focal length + horizontal aperture x10 -> sensor width mm,
    fov from arctan (alembic.hpp:47-71);
  * IPolyMesh: positions/faceIndices/faceCounts (fan-triangulated),
    N/uv GeomParams in per-vertex OR per-face-vertex (face-varying)
    scope — face-varying attrs land in Mesh.corner_normals/corner_uvs
    and are re-indexed at Scene.build (alembic.hpp:156-257 "per-vertex
    vs per-face-vertex detection");
  * IFaceSet children bind materials by name per face set
    (alembic.hpp:216 logs missing materials; we do the same and fall
    back to the object-name material, then to a default diffuse).

``write_alembic`` is the matching exporter (no reference counterpart —
the reference never writes archives) used for round-trip validation and
for generating BMW-class test assets in this binding-less environment.
"""
from __future__ import annotations

import numpy as np

from phosphorus_mk2_tpu_torch.core.mesh import Mesh
from phosphorus_mk2_tpu_torch.core.scene import Scene
from phosphorus_mk2_tpu_torch.io.abc import (
    ARRAY,
    COMPOUND,
    AbcReader,
    AbcWriter,
    POD_FLOAT32,
    POD_FLOAT64,
    POD_INT32,
    POD_UINT8,
    POD_UINT32,
)

XFORM_SCHEMA = "AbcGeom_Xform_v3"
POLYMESH_SCHEMA = "AbcGeom_PolyMesh_v1"
CAMERA_SCHEMA = "AbcGeom_Camera_v1"
FACESET_SCHEMA = "AbcGeom_FaceSet_v1"

OP_MATRIX = 0x30  # (kMatrixOperation << 4) | kMatrixHint


def _triangulate(counts: np.ndarray, indices: np.ndarray):
    """Vectorized fan triangulation.

    Returns (faces (T,3) vertex ids, corners (T,3) loop ids, poly (T,)
    polygon ids) — loop ids index the face-varying attribute arrays,
    polygon ids map face sets through the triangulation.
    """
    c = counts.astype(np.int64)
    off = np.concatenate([[0], np.cumsum(c)[:-1]])
    per_face = np.maximum(c - 2, 0)
    total = int(per_face.sum())
    poly = np.repeat(np.arange(len(c)), per_face)
    start = np.concatenate([[0], np.cumsum(per_face)[:-1]])
    k = np.arange(total, dtype=np.int64) - start[poly] + 1
    o = off[poly]
    corners = np.stack([o, o + k, o + k + 1], axis=-1)
    faces = indices.astype(np.int64)[corners]
    return faces, corners, poly


def _geom_param(reader: AbcReader, props: dict, name: str):
    """Resolve an AbcGeom GeomParam: plain array, or indexed compound
    {.vals, .indices}. Returns (values, per_loop_indices_or_None)."""
    if name not in props:
        return None, None
    h, w = props[name]
    if h.ptype == COMPOUND:
        sub = reader.compound(props[name])
        if ".vals" not in sub:
            return None, None
        vals = reader.sample(sub[".vals"])
        idx = (
            reader.sample(sub[".indices"]).astype(np.int64)
            if ".indices" in sub
            else None
        )
        return np.asarray(vals), idx
    return np.asarray(reader.sample(props[name])), None


def _dispose_attr(vals, idx, nverts: int, nloops: int, corners, extent: int):
    """Reference per-vertex vs per-face-vertex detection
    (alembic.hpp:156-257): returns (per_vertex or None, per_corner or
    None) with per_corner shaped (T, 3, extent)."""
    if vals is None:
        return None, None
    if idx is not None:
        if len(idx) == nloops:
            return None, vals[idx][corners]
        if len(idx) == nverts:
            return vals[idx], None
        return None, None
    if len(vals) == nverts:
        return vals, None
    if len(vals) == nloops:
        return None, vals[corners]
    return None, None


def import_alembic(path: str, scene: Scene, verbose: bool = False) -> None:
    reader = AbcReader(path)

    def material_for(name: str, fallback: str | None):
        for cand in (name, fallback):
            if cand and cand in scene._material_ids:
                return scene._material_ids[cand]
        if verbose:
            print(f"alembic: no material {name!r}; using default diffuse")
        if "__abc_default" not in scene._material_ids:
            from phosphorus_mk2_tpu_torch.core.material import Material

            scene.add_material(
                Material.diffuse(color=(0.8, 0.8, 0.8), name="__abc_default")
            )
        return scene._material_ids["__abc_default"]

    def read_xform(obj) -> np.ndarray:
        props = obj.properties()
        if ".xform" not in props:
            return np.eye(4)
        sub = reader.compound(props[".xform"])
        if ".ops" not in sub or ".vals" not in sub:
            return np.eye(4)
        ops = np.atleast_1d(np.asarray(reader.sample(sub[".ops"]))).astype(np.uint8)
        vals = np.atleast_1d(np.asarray(reader.sample(sub[".vals"]))).astype(
            np.float64
        ).ravel()
        m = np.eye(4)
        pos = 0
        for op in ops:
            kind = op >> 4
            if kind == 3:  # matrix
                m = vals[pos : pos + 16].reshape(4, 4) @ m
                pos += 16
            elif kind == 1:  # translate
                t = np.eye(4)
                t[3, :3] = vals[pos : pos + 3]
                m = t @ m
                pos += 3
            elif kind == 0:  # scale
                s = np.diag(list(vals[pos : pos + 3]) + [1.0])
                m = s @ m
                pos += 3
            else:  # rotate ops unsupported in the static subset: skip 4
                pos += 4
        return m

    def read_camera(obj, xform):
        props = obj.properties()
        if ".geom" not in props:
            return
        sub = reader.compound(props[".geom"])
        if ".core" not in sub:
            return
        core = np.asarray(reader.sample(sub[".core"]), np.float64).ravel()
        scene.camera.to_world = xform.astype(np.float32)
        scene.camera.focal_length = float(core[0])
        # Alembic stores apertures in cm; the reference multiplies by 10
        # (alembic.hpp:47-71)
        scene.camera.sensor_width = float(core[1]) * 10.0
        scene.camera.fov = 2.0 * float(
            np.arctan2(scene.camera.sensor_width * 0.5, scene.camera.focal_length)
        )

    def read_polymesh(obj, xform):
        props = obj.properties()
        if ".geom" not in props:
            return
        g = reader.compound(props[".geom"])
        if not all(k in g for k in ("P", ".faceIndices", ".faceCounts")):
            return
        pos = np.asarray(reader.sample(g["P"]), np.float32)
        indices = np.asarray(reader.sample(g[".faceIndices"])).astype(np.int64)
        counts = np.asarray(reader.sample(g[".faceCounts"])).astype(np.int64)
        faces, corners, poly = _triangulate(counts, indices)
        nverts, nloops = len(pos), len(indices)

        # bake to world; normals by inverse-transpose
        rot = xform[:3, :3].astype(np.float32)
        pos = pos @ rot + xform[3, :3].astype(np.float32)
        it = np.linalg.inv(xform[:3, :3]).T.astype(np.float32)

        n_vals, n_idx = _geom_param(reader, g, "N")
        nv, nc = _dispose_attr(n_vals, n_idx, nverts, nloops, corners, 3)

        def xf_n(n):
            n = np.asarray(n, np.float32) @ it.T
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            return (n / np.maximum(ln, 1e-20)).astype(np.float32)

        uv_vals, uv_idx = _geom_param(reader, g, "uv")
        uvv, uvc = _dispose_attr(uv_vals, uv_idx, nverts, nloops, corners, 2)

        # face sets -> per-face material ids through the triangulation
        # (reference alembic.hpp:216 binds by face-set name)
        default_mid = material_for(obj.name, None)
        poly_mat = np.full((len(counts),), default_mid, np.int32)
        for ch in obj.children():
            if FACESET_SCHEMA not in ch.schema:
                continue
            fp = ch.properties()
            if ".faceset" not in fp:
                continue
            fs = reader.compound(fp[".faceset"])
            if ".faces" not in fs:
                continue
            sel = np.asarray(reader.sample(fs[".faces"])).astype(np.int64)
            poly_mat[sel] = material_for(ch.name, obj.name)
        tri_mat = poly_mat[poly]

        scene.add_mesh(
            Mesh(
                vertices=pos,
                faces=faces.astype(np.int32),
                material=tri_mat,
                normals=xf_n(nv) if nv is not None else None,
                corner_normals=xf_n(nc) if nc is not None else None,
                uvs=np.asarray(uvv, np.float32) if uvv is not None else None,
                corner_uvs=np.asarray(uvc, np.float32) if uvc is not None else None,
                smooth=True,
                name=obj.name,
            )
        )
        if verbose:
            print(
                f"alembic: mesh {obj.name!r}: {len(pos)} verts, "
                f"{faces.shape[0]} tris"
            )

    def walk(obj, xform):
        schema = obj.schema
        if XFORM_SCHEMA.split("_v")[0] in schema:
            xform = read_xform(obj) @ xform
        elif CAMERA_SCHEMA.split("_v")[0] in schema:
            read_camera(obj, xform)
        elif POLYMESH_SCHEMA.split("_v")[0] in schema:
            read_polymesh(obj, xform)
        for child in obj.children():
            walk(child, xform)

    walk(reader.top, np.eye(4))


# ---------------------------------------------------------------------------
# exporter (round-trip validation + asset generation)


def write_alembic(path: str, meshes: list, camera=None, xforms=None) -> None:
    """Write a static archive of triangle meshes (+ optional camera).

    meshes: list of Mesh (or (Mesh, matrix) when xforms is None and a
    per-mesh transform is wanted). Face-set objects are emitted per
    distinct material id/name so the importer's binding path round-trips.
    """
    w = AbcWriter()

    def xform_obj(parent, name, matrix):
        node = w.object(
            parent, name, XFORM_SCHEMA, f"{XFORM_SCHEMA}:.xform"
        )
        ops = w.scalar(".ops", np.array([OP_MATRIX], np.uint8), pod=POD_UINT8)
        vals = w.array(
            ".vals",
            np.asarray(matrix, np.float64).reshape(16),
            extent=1,
            pod=POD_FLOAT64,
        )
        node["props"] = [w.compound(".xform"), ]
        node["props"][0]["children"] = [ops, vals]
        return node

    for i, item in enumerate(meshes):
        mesh, matrix = item if isinstance(item, tuple) else (item, np.eye(4))
        if xforms is not None:
            matrix = xforms[i]
        name = mesh.name or f"mesh{i}"
        xf = xform_obj(w.top, f"{name}_xf", matrix)
        mo = w.object(xf, name, POLYMESH_SCHEMA, f"{POLYMESH_SCHEMA}:.geom")

        geom = w.compound(".geom", meta={"schema": POLYMESH_SCHEMA})
        kids = [
            w.array("P", np.asarray(mesh.vertices, np.float32), extent=3,
                    meta={"interpretation": "point"}),
            w.array(
                ".faceIndices",
                np.asarray(mesh.faces, np.int32).reshape(-1),
                extent=1,
                pod=POD_INT32,
            ),
            w.array(
                ".faceCounts",
                np.full((mesh.num_faces,), 3, np.int32),
                extent=1,
                pod=POD_INT32,
            ),
        ]
        if mesh.corner_normals is not None:
            vals = np.asarray(mesh.corner_normals, np.float32).reshape(-1, 3)
            gp = w.compound("N", meta={"geoScope": "fvr", "isGeomParam": "true"})
            gp["children"] = [
                w.array(".vals", vals, extent=3),
                w.array(
                    ".indices",
                    np.arange(vals.shape[0], dtype=np.uint32),
                    extent=1,
                    pod=POD_UINT32,
                ),
            ]
            kids.append(gp)
        elif mesh.normals is not None:
            kids.append(
                w.array("N", np.asarray(mesh.normals, np.float32), extent=3,
                        meta={"geoScope": "vtx"})
            )
        if mesh.corner_uvs is not None:
            vals = np.asarray(mesh.corner_uvs, np.float32).reshape(-1, 2)
            gp = w.compound("uv", meta={"geoScope": "fvr", "isGeomParam": "true"})
            gp["children"] = [
                w.array(".vals", vals, extent=2),
                w.array(
                    ".indices",
                    np.arange(vals.shape[0], dtype=np.uint32),
                    extent=1,
                    pod=POD_UINT32,
                ),
            ]
            kids.append(gp)
        elif mesh.uvs is not None:
            kids.append(
                w.array("uv", np.asarray(mesh.uvs, np.float32), extent=2,
                        meta={"geoScope": "vtx"})
            )
        geom["children"] = kids
        mo["props"] = [geom]

        # face sets per material name/id
        mat = mesh.material
        if isinstance(mat, np.ndarray):
            for mid in np.unique(mat):
                sel = np.nonzero(mat == mid)[0].astype(np.int32)
                fs = w.object(
                    mo, f"mat{int(mid)}", FACESET_SCHEMA,
                    f"{FACESET_SCHEMA}:.faceset",
                )
                fsc = w.compound(".faceset")
                fsc["children"] = [
                    w.array(".faces", sel, extent=1, pod=POD_INT32)
                ]
                fs["props"] = [fsc]
        elif isinstance(mat, str):
            fs = w.object(
                mo, mat, FACESET_SCHEMA, f"{FACESET_SCHEMA}:.faceset"
            )
            fsc = w.compound(".faceset")
            fsc["children"] = [
                w.array(
                    ".faces",
                    np.arange(mesh.num_faces, dtype=np.int32),
                    extent=1,
                    pod=POD_INT32,
                )
            ]
            fs["props"] = [fsc]

    if camera is not None:
        xf = xform_obj(
            w.top, "camera_xf", getattr(camera, "to_world", np.eye(4))
        )
        co = w.object(xf, "camera", CAMERA_SCHEMA, f"{CAMERA_SCHEMA}:.geom")
        core = np.zeros(16, np.float64)
        core[0] = camera.focal_length
        core[1] = camera.sensor_width / 10.0  # mm -> cm
        core[2:6] = (0.0, core[1], 0.0, 1.0)  # offsets/vAperture/squeeze
        core[6:10] = 1.0  # overscan
        core[10] = 5.6  # fStop
        core[11] = getattr(camera, "focal_distance", 1.0) or 1.0
        core[14], core[15] = 0.01, 100000.0
        geom = w.compound(".geom", meta={"schema": CAMERA_SCHEMA})
        geom["children"] = [w.scalar(".core", core, pod=POD_FLOAT64)]
        co["props"] = [geom]

    w.save(path)

"""Wavefront OBJ mesh loader.

Counterpart of ``phosphorus_mk2_tpu/io/obj.py``, building the port's
Mesh.

The reference imports geometry through Alembic (reference
src/codecs/scene/alembic.hpp:297); this environment has no Alembic
bindings, so OBJ is the standalone-file geometry path (io/alembic.py
holds the gated Alembic entry point with the same mesh-builder contract).
"""
from __future__ import annotations

import numpy as np

from phosphorus_mk2_tpu_torch.core.mesh import Mesh


def load_obj(path: str, material=None, scale: float = 1.0) -> list[Mesh]:
    """Load an OBJ file into one Mesh per object (o/g groups merged when
    they share vertex data). Supports v/vn/vt, triangle and polygon
    faces (fan-triangulated), usemtl as the material name."""
    positions: list = []
    normals: list = []
    uvs: list = []

    meshes: list[Mesh] = []
    cur_name = ""
    cur_material = material
    # face corners: (pos_idx, uv_idx, norm_idx)
    faces: list = []

    def flush():
        nonlocal faces
        if not faces:
            return
        # re-index: unique (p, t, n) corners -> vertices
        corner_map: dict = {}
        verts, vns, vts, tri = [], [], [], []
        for corner_list in faces:
            idxs = []
            for c in corner_list:
                if c not in corner_map:
                    corner_map[c] = len(verts)
                    pi, ti, ni = c
                    verts.append(positions[pi])
                    vns.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
                    vts.append(uvs[ti] if ti is not None else (0.0, 0.0))
                idxs.append(corner_map[c])
            for k in range(1, len(idxs) - 1):  # fan triangulation
                tri.append([idxs[0], idxs[k], idxs[k + 1]])
        has_n = any(c[2] is not None for f in faces for c in f)
        has_t = any(c[1] is not None for f in faces for c in f)
        meshes.append(
            Mesh(
                vertices=np.asarray(verts, np.float32) * scale,
                faces=np.asarray(tri, np.int32),
                normals=np.asarray(vns, np.float32) if has_n else None,
                uvs=np.asarray(vts, np.float32) if has_t else None,
                material=cur_material,
                smooth=has_n,
                name=cur_name,
            )
        )
        faces = []

    def parse_corner(tok: str):
        parts = tok.split("/")
        pi = int(parts[0])
        pi = pi - 1 if pi > 0 else len(positions) + pi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        if len(parts) > 2 and parts[2]:
            nn = int(parts[2])
            ni = nn - 1 if nn > 0 else len(normals) + nn
        return (pi, ti, ni)

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v":
                positions.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vn":
                normals.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "vt":
                uvs.append(tuple(float(x) for x in tok[1:3]))
            elif tok[0] == "f":
                faces.append([parse_corner(t) for t in tok[1:]])
            elif tok[0] in ("o", "g"):
                flush()
                cur_name = tok[1] if len(tok) > 1 else ""
            elif tok[0] == "usemtl":
                flush()
                cur_material = tok[1]
    flush()
    return meshes

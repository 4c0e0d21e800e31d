"""Stanford PLY mesh loader (ascii + binary little/big endian).

Counterpart of ``phosphorus_mk2_tpu/io/ply.py``, building the port's
Mesh.

Rounds out the standalone-file geometry loaders alongside OBJ and the
native Ogawa/Alembic reader (SURVEY.md §7 build-plan row "mesh loaders
(obj/ply/abc via Python libs)"; the reference itself only reads Alembic,
reference src/codecs/scene/alembic.hpp:297 — PLY is a superset
convenience with the same Mesh-builder contract as io/obj.load_obj).

Supported: vertex properties x/y/z (+ nx/ny/nz, s/t | u/v, red/green/
blue), face property lists (any int index type, fan-triangulated),
ascii / binary_little_endian / binary_big_endian formats.
"""
from __future__ import annotations

import numpy as np

from phosphorus_mk2_tpu_torch.core.mesh import Mesh

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str, material=None, scale: float = 1.0) -> list[Mesh]:
    """Load a PLY file into a single Mesh (PLY has one mesh per file)."""
    with open(path, "rb") as f:
        data = f.read()

    # ---- header ------------------------------------------------------
    end = data.find(b"end_header")
    if not data.startswith(b"ply") or end < 0:
        raise ValueError(f"{path}: not a PLY file")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]

    fmt = None
    elements: list[dict] = []  # {name, count, props: [(name, dtype, list_dtype|None)]}
    for line in header[1:]:
        tok = line.split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append({"name": tok[1], "count": int(tok[2]), "props": []})
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1]["props"].append((tok[4], _TYPES[tok[3]], _TYPES[tok[2]]))
            else:
                elements[-1]["props"].append((tok[2], _TYPES[tok[1]], None))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt!r}")
    bo = "<" if fmt != "binary_big_endian" else ">"

    # ---- body --------------------------------------------------------
    parsed: dict[str, dict[str, np.ndarray | list]] = {}
    if fmt == "ascii":
        rows = body.decode("ascii", "replace").split()
        pos = 0
        for el in elements:
            cols: dict[str, list] = {p[0]: [] for p in el["props"]}
            for _ in range(el["count"]):
                for pname, pdt, plist in el["props"]:
                    if plist is None:
                        cols[pname].append(float(rows[pos]))
                        pos += 1
                    else:
                        cnt = int(rows[pos])
                        pos += 1
                        cols[pname].append(
                            [float(rows[pos + k]) for k in range(cnt)]
                        )
                        pos += cnt
            parsed[el["name"]] = cols
    else:
        off = 0
        for el in elements:
            has_list = any(p[2] is not None for p in el["props"])
            if not has_list:
                dt = np.dtype([(p[0], bo + p[1]) for p in el["props"]])
                arr = np.frombuffer(body, dt, count=el["count"], offset=off)
                off += dt.itemsize * el["count"]
                parsed[el["name"]] = {p[0]: arr[p[0]] for p in el["props"]}
            else:
                cols = {p[0]: [] for p in el["props"]}
                for _ in range(el["count"]):
                    for pname, pdt, plist in el["props"]:
                        if plist is None:
                            v = np.frombuffer(body, bo + pdt, 1, offset=off)[0]
                            off += np.dtype(pdt).itemsize
                            cols[pname].append(float(v))
                        else:
                            cnt = int(np.frombuffer(body, bo + plist, 1, offset=off)[0])
                            off += np.dtype(plist).itemsize
                            vals = np.frombuffer(body, bo + pdt, cnt, offset=off)
                            off += np.dtype(pdt).itemsize * cnt
                            cols[pname].append(vals.astype(np.int64))
                parsed[el["name"]] = cols

    # ---- mesh assembly ----------------------------------------------
    if "vertex" not in parsed or "face" not in parsed:
        raise ValueError(f"{path}: PLY without vertex/face elements")
    v = parsed["vertex"]
    verts = np.stack(
        [np.asarray(v["x"]), np.asarray(v["y"]), np.asarray(v["z"])], axis=1
    ).astype(np.float32)

    normals = None
    if "nx" in v:
        normals = np.stack(
            [np.asarray(v["nx"]), np.asarray(v["ny"]), np.asarray(v["nz"])],
            axis=1,
        ).astype(np.float32)
    uvs = None
    for a, b in (("s", "t"), ("u", "v"), ("texture_u", "texture_v")):
        if a in v and b in v:
            uvs = np.stack(
                [np.asarray(v[a]), np.asarray(v[b])], axis=1
            ).astype(np.float32)
            break

    face_cols = parsed["face"]
    idx_col = None
    for name in ("vertex_indices", "vertex_index"):
        if name in face_cols:
            idx_col = face_cols[name]
            break
    if idx_col is None:  # first list property wins
        idx_col = next(iter(face_cols.values()))
    tris = []
    for poly in idx_col:
        poly = [int(i) for i in poly]
        for k in range(1, len(poly) - 1):  # fan triangulation
            tris.append((poly[0], poly[k], poly[k + 1]))
    faces = np.asarray(tris, np.int32).reshape(-1, 3)

    return [
        Mesh(
            vertices=verts * scale,
            faces=faces,
            normals=normals,
            uvs=uvs,
            material=material,
            smooth=normals is not None,
            name="ply",
        )
    ]

"""The reference's scene tables with the sheen lobe: a copy of
``reference/scene.py`` that differs from it in three places only.

* ``lobes_of`` knows the material kind ``sheen`` (roughness r): one lobe of
  type SHEEN (7, the program's code) with the flags reflect | glossy, its
  parameter the roughness as given (the reference renderer's sheen node
  takes it unmapped, unlike GGX's alpha).
* ``FLAGS`` holds SHEEN's flags.
* ``Tables`` is the original's, reading this module's ``lobes_of`` and
  ``FLAGS``.

The unchanged parts (every other kind's lobes, vertex normals; the camera
stays in the original) are imported from the original.
"""
from __future__ import annotations

import numpy as np
import torch

from reference.scene import F_GLOSSY, F_REFLECT, N_PARAMS, vertex_normals
from reference.scene import FLAGS as _FLAGS
from reference.scene import lobes_of as _lobes_of

SHEEN = 7
FLAGS = {**_FLAGS, SHEEN: F_REFLECT | F_GLOSSY}


def lobes_of(m: dict) -> tuple:
    """(lobes [(type, rgb, params)], emission rgb) of one material's nodes;
    ``sheen`` here, every other kind as the original's."""
    if m["kind"] != "sheen":
        return _lobes_of(m)
    color = tuple(float(c) for c in m.get("color", (1.0, 1.0, 1.0)))
    return [(SHEEN, color, (float(m["roughness"]),))], (0.0, 0.0, 0.0)


class Tables:
    """Tensors of a scene on one device: tri (F, 19) rows a | b | c | n0 |
    n1 | n2 | smooth, tri_mat (F,), per material lobe type / weight / param /
    flags (M, L[, 3 or 6]) and n_lobes, emission (M, 3), and the lights.

    A mesh without normals takes area-weighted vertex normals. bf16=True
    rounds every stored float table to bfloat16 (the precision control)."""

    def __init__(self, meshes, materials, background, device, bf16=False):
        names = [m["name"] for m in materials] + (["__background"] if background else [])
        mats = list(materials) + ([background] if background else [])
        mid = {n: i for i, n in enumerate(names)}
        verts, faces, norms, smooth, tmat = [], [], [], [], []
        off = 0
        for m in meshes:
            v = np.asarray(m["vertices"], np.float32)
            f = np.asarray(m["faces"], np.int64)
            n = m.get("normals")
            if n is None:
                n = vertex_normals(v, f)
            verts.append(v)
            faces.append(f + off)
            norms.append(np.asarray(n, np.float32))
            smooth.append(np.full(f.shape[0], bool(m["smooth"])))
            tmat.append(np.full(f.shape[0], mid[m["material"]], np.int64))
            off += v.shape[0]
        v, f = np.concatenate(verts), np.concatenate(faces)
        n, tri_mat = np.concatenate(norms), np.concatenate(tmat)
        self.num_tris = f.shape[0]

        lobes = [lobes_of(m) for m in mats]
        self.L = max(1, max(len(lb) for lb, _ in lobes))
        M = len(mats)
        ltype = np.zeros((M, self.L), np.int64)
        lw = np.zeros((M, self.L, 3), np.float32)
        lp = np.zeros((M, self.L, N_PARAMS), np.float32)
        lf = np.zeros((M, self.L), np.int64)
        nl = np.zeros((M,), np.int64)
        em = np.zeros((M, 3), np.float32)
        for i, (lb, e) in enumerate(lobes):
            nl[i] = len(lb)
            em[i] = e
            for j, (t, w, p) in enumerate(lb):
                ltype[i, j], lw[i, j], lf[i, j] = t, w, FLAGS[t]
                lp[i, j, :len(p)] = p
        self.types = sorted({t for lb, _ in lobes for t, _, _ in lb})
        self.fresnel = bool((lp[..., 4] != 0.0).any())

        # area lights: one per emitting material (the background excepted)
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        light_tris, light_rows = [], []
        tri_pdf = np.zeros((self.num_tris,), np.float32)
        for i, (lb, e) in enumerate(lobes):
            if not any(x != 0.0 for x in e) or names[i] == "__background":
                continue
            sel = np.nonzero(tri_mat == i)[0]
            if sel.size == 0:
                continue
            area = float(areas[sel].sum())
            light_rows.append((1, i, sum(t.size for t in light_tris), sel.size, area))
            light_tris.append(sel)
            if area > 0.0:
                tri_pdf[sel] = 1.0 / area
        if background:
            light_rows.append((2, mid["__background"], 0, 0, 0.0))
        self.num_lights = len(light_rows)
        if self.num_lights:
            tri_pdf /= self.num_lights
        if not light_tris:
            light_tris.append(np.zeros((1,), np.int64))
        self.env = mid["__background"] if background else -1

        def t(x, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            if out.is_floating_point() and bf16:
                out = out.to(torch.bfloat16).to(torch.float32)
            return out if dtype is None else out.to(dtype)

        fv = lambda k: v[f[:, k]]  # noqa: E731
        fn = lambda k: n[f[:, k]]  # noqa: E731
        self.tri = t(np.concatenate([fv(0), fv(1), fv(2), fn(0), fn(1), fn(2),
                                     np.concatenate(smooth)[:, None].astype(np.float32)], 1))
        self.tri_mat = t(tri_mat)
        self.lobe_type, self.lobe_weight, self.lobe_param = t(ltype), t(lw), t(lp)
        self.lobe_flags, self.n_lobes, self.emission = t(lf), t(nl), t(em)
        self.tri_light_pdf = t(tri_pdf)
        rows = np.array(light_rows if light_rows else [(0, 0, 0, 0, 0.0)], np.float64)
        self.light_type = t(rows[:, 0].astype(np.int64))
        self.light_mat = t(rows[:, 1].astype(np.int64))
        self.light_offset = t(rows[:, 2].astype(np.int64))
        self.light_count = t(rows[:, 3].astype(np.int64))
        self.light_area = t(rows[:, 4].astype(np.float32))
        self.light_tris = t(np.concatenate(light_tris).astype(np.int64))

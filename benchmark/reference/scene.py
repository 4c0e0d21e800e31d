"""The reference's own scene tables, worked out from the benchmark's arrays.

A scene is the data of ``benchmark/scenes``: meshes as NumPy arrays, the
materials of the configuration file as node parameters, an optional
background and a camera. From them this module derives, without the
program, what a render reads: the per-triangle rows (corners, corner
normals, the smooth flag), each triangle's material, the lobe table of every
material (the node conventions of the reference renderer's OSL library:
glossy alpha from the roughness polynomial, Oren-Nayar A and B, emitter
power / pi, two-lobe glass weighted by the dielectric Fresnel term), and the
lights: one area light per emitting material over its triangles, with the
background as an infinite light that next-event estimation never picks
validly.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DIFFUSE, OREN_NAYAR, REFLECTION, REFRACTION, MICROFACET = 1, 2, 3, 4, 5
F_DIFFUSE, F_GLOSSY, F_SPECULAR, F_REFLECT, F_TRANSMIT = 1, 2, 4, 8, 16
FLAGS = {
    DIFFUSE: F_REFLECT | F_DIFFUSE,
    OREN_NAYAR: F_REFLECT | F_DIFFUSE,
    REFLECTION: F_REFLECT | F_SPECULAR,
    REFRACTION: F_TRANSMIT | F_SPECULAR,
    MICROFACET: F_GLOSSY | F_REFLECT,
}
N_PARAMS = 6   # [0:3] the lobe's own, [4] Fresnel mode (1: F, 2: 1 - F), [5] its ior


def roughness_to_alpha(r: float) -> float:
    x = np.log(max(float(r), 1e-5))
    alpha = 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3 + 0.000640711 * x ** 4
    return float(min(1.0, max(1e-4, alpha)))


def lobes_of(m: dict) -> tuple:
    """(lobes [(type, rgb, params)], emission rgb) of one material's nodes."""
    kind, color = m["kind"], tuple(float(c) for c in m.get("color", (1.0, 1.0, 1.0)))
    rough = float(m.get("roughness", 0.0))
    if kind == "diffuse":
        if rough == 0.0:
            return [(DIFFUSE, color, ())], (0.0, 0.0, 0.0)
        s = math.radians(rough)
        s2 = s * s
        a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        b = 0.45 * s2 / (s2 + 0.09)
        return [(OREN_NAYAR, color, (rough, a, b))], (0.0, 0.0, 0.0)
    if kind == "glossy":
        return [_glossy(color, rough)], (0.0, 0.0, 0.0)
    if kind == "glass":
        ior = float(m["ior"])
        if rough != 0.0:
            raise ValueError("rough glass is not among the reference's lobes")
        g = _glossy(color, rough)
        return [(g[0], color, g[2] + (0.0,) * (4 - len(g[2])) + (1.0, ior)),
                (REFRACTION, color, (ior, 0.0, 0.0, 0.0, 2.0, ior))], (0.0, 0.0, 0.0)
    if kind == "emitter":
        power = float(m["power"])
        return [], tuple(c * power / np.pi for c in color)
    if kind == "background":
        power = float(m["power"])
        return [], tuple(c * power for c in color)
    raise ValueError(f"material kind {kind!r} is not among the reference's")


def _glossy(color, rough):
    if rough == 0.0:
        return (REFLECTION, color, (0.0,))
    alpha = roughness_to_alpha(rough * rough)
    return (MICROFACET, color, (alpha, alpha, 0.0))


def vertex_normals(v, f):
    """Area-weighted unit vertex normals of a mesh that has none."""
    n = np.zeros_like(v)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)).astype(np.float32)


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


class Camera:
    """The pinhole camera's parameters as tensors (no lens: aperture 0)."""

    def __init__(self, cam: dict, device):
        self.to_world = torch.tensor(np.asarray(cam["to_world"], np.float32), device=device)
        fov = 2.0 * float(np.arctan2(float(cam["sensor_width"]) * 0.5,
                                     float(cam["focal_length"])))
        self.fov = torch.tensor(fov, dtype=torch.float32, device=device)
        self.width, self.height = float(cam["width"]), float(cam["height"])
        self.aperture = float(cam.get("aperture_radius", 0.0))
        if self.aperture != 0.0:
            raise ValueError("the reference's camera is a pinhole")

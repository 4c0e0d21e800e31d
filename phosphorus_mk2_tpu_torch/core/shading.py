"""Hit -> interaction shading parameters.

Counterpart of ``phosphorus_mk2_tpu/core/shading.py`` (reference
src/kernels/cpu/deferred_shading_kernel.hpp:8-73, src/mesh.cpp:169-258).
Barycentric convention: w = 1-u-v weights vertex a, u weights b, v
weights c.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.core.texture import sample_texture
from phosphorus_mk2_tpu_torch.math.vec import cross, maximum, normalize, safe_sqrt


def triangle_attribute_table(scene) -> torch.Tensor:
    """(F, 25[+9]) per-triangle attribute rows: a b c | n0 n1 n2 | uv0
    uv1 uv2 | smooth [| t0 t1 t2 when the scene has normal maps] — one
    row gather per hit instead of ~11."""
    f = scene.faces.long()
    cols = [
        scene.vertices[f[:, 0]],
        scene.vertices[f[:, 1]],
        scene.vertices[f[:, 2]],
        scene.normals[f[:, 0]],
        scene.normals[f[:, 1]],
        scene.normals[f[:, 2]],
        scene.uvs[f[:, 0]],
        scene.uvs[f[:, 1]],
        scene.uvs[f[:, 2]],
        scene.smooth[:, None].to(torch.float32),
    ]
    if scene.has_normal_maps:
        cols += [
            scene.tangents[f[:, 0]],
            scene.tangents[f[:, 1]],
            scene.tangents[f[:, 2]],
        ]
    return torch.cat(cols, dim=1)


def shading_parameters(scene, tri, u, v, attr=None, row=None) -> dict:
    """Interpolated shading normal, position and uv for hits.

    tri: (N,) triangle ids (clamped to valid; callers mask by the hit
    flag). attr: optional triangle_attribute_table(scene); row: optional
    pre-gathered attribute rows (N, >= 25; >= 34 with normal maps).
    Returns dict with p, n, ng (N,3), st (N,2), uv_scale (N,), edges and,
    when the scene has normal maps, the interpolated tangent (N,3).
    """
    if row is None:
        if attr is None:
            attr = triangle_attribute_table(scene)
        row = attr[torch.clamp(tri, min=0)]
    a, b, c = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    n0, n1, n2 = row[..., 9:12], row[..., 12:15], row[..., 15:18]
    uv0, uv1, uv2 = row[..., 18:20], row[..., 20:22], row[..., 22:24]
    smooth = row[..., 24] != 0.0
    w = 1.0 - u - v

    p = w[..., None] * a + u[..., None] * b + v[..., None] * c

    n_geom = normalize(cross(b - a, c - a))
    n_smooth = normalize(w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2)
    n = torch.where(smooth[..., None], n_smooth, n_geom)

    st = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2

    # uv-per-world-unit scale of the hit triangle (texture footprints)
    e0w = b - a
    e1w = c - a
    area_w = torch.linalg.vector_norm(cross(e0w, e1w), dim=-1)
    e0t = uv1 - uv0
    e1t = uv2 - uv0
    area_t = (e0t[..., 0] * e1t[..., 1] - e0t[..., 1] * e1t[..., 0]).abs()
    uv_scale = safe_sqrt(area_t / maximum(area_w, 1e-20))

    out = {"p": p, "n": n, "ng": n_geom, "st": st, "uv_scale": uv_scale,
           "edges": (e0w, e1w, e0t, e1t)}
    if scene.has_normal_maps:
        t0, t1, t2 = row[..., 25:28], row[..., 28:31], row[..., 31:34]
        out["tangent"] = normalize(
            w[..., None] * t0 + u[..., None] * t1 + v[..., None] * t2
        )
    return out


def apply_normal_map(scene, sp: dict, mat=None, tid=None, footprint=None) -> dict:
    """Perturb the shading normal by a tangent-space normal map
    (reference normal_map_node.osl and the geom:tangent attribute path,
    src/material.cpp:67-84). The identity without normal maps.
    mat: (N,) material ids, or tid: (N,) pre-gathered normal-texture ids
    (the consolidated hit row); footprint: optional uv footprint for
    mip filtering (core/texture.sample_texture)."""
    if not scene.has_normal_maps:
        return sp
    if tid is None:
        tid = scene.normal_tex[mat.long()]
    rgb = sample_texture(scene.tex_atlas, scene.tex_info, tid, sp["st"],
                         footprint=footprint)
    tsn = rgb * 2.0 - 1.0
    n = sp["n"]
    t = sp.get("tangent")
    if t is None:
        return sp
    b = normalize(cross(n, t))
    n_new = normalize(tsn[..., 0:1] * t + tsn[..., 1:2] * b + tsn[..., 2:3] * n)
    out = dict(sp)
    out["n"] = torch.where((tid >= 0)[..., None], n_new, n)
    return out

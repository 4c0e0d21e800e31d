"""Light sampling for next-event estimation.

Counterpart of ``phosphorus_mk2_tpu/core/lights.py`` (reference
src/light.cpp, src/sampling.cpp:160-180): a light is picked uniformly
and the pdf divided by the light count; area lights pick a triangle
uniformly, warp to barycentrics by the sqrt warp and report
pdf = 1/total_area; infinite-light samples get weight 0 in NEE (the
environment still arrives on path misses).
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.core.scene import LIGHT_AREA
from phosphorus_mk2_tpu_torch.core.shading import shading_parameters
from phosphorus_mk2_tpu_torch.math.grad_gather import block_of, gather_rows
from phosphorus_mk2_tpu_torch.math.vec import maximum
from phosphorus_mk2_tpu_torch.math.sampling import (
    remap_index_sample,
    triangle_sample,
    uniform_hemisphere,
)


def light_meta_table(scene) -> torch.Tensor:
    """(NL, 5) int32 light rows: type, mat, offset, count, area bits."""
    return torch.stack(
        [
            scene.light_type,
            scene.light_mat,
            scene.light_offset,
            scene.light_count,
            scene.light_area.view(torch.int32),
        ],
        dim=-1,
    )


def light_tri_table(scene, attr) -> torch.Tensor:
    """(LT, attr_w + 3 [+1]) rows: the attribute row of each light
    triangle plus its material's emission (and, in a textured scene, its
    emission-texture id as an exact float)."""
    lt = scene.light_tris.long()
    lmat = scene.tri_mat[lt].long()
    cols = [gather_rows(attr, lt, "index"), gather_rows(scene.emission, lmat, "float64")]
    if scene.has_textures:
        cols.append(scene.emission_tex[lmat][:, None].to(torch.float32))
    return torch.cat(cols, dim=1)


def sample_lights(scene, u_pick, u_tri, u_uv, attr=None, meta=None, lt_table=None,
                  attr_w: int | None = None) -> dict:
    """Sample one light point per wavefront entry.

    u_pick, u_tri, u_uv: (N,) uniforms (u_tri is remapped for the
    triangle pick and reused for the barycentric x, as the reference
    does). attr: optional triangle_attribute_table; meta: optional
    light_meta_table (None: one gather a light field; else one gather of
    its int32 rows at every light count: the JAX package's broadcast
    select for at most 4 lights gives the same values and saves a TPU
    launch, but is several launches in eager PyTorch);
    lt_table: optional light_tri_table, read at light_offset + pick
    without the light_tris indirection (None: through light_tris, from
    attr or, without it, from faces and vertices); attr_w: the attribute
    width inside lt_table's rows (default: the row's width less the
    emission and, in a textured scene, its texture column; the JAX
    package subtracts 3 whatever the scene, which in a textured scene
    reads the emission one column late).

    Returns dict: p (N,3), n (N,3), pdf (N,) area pdf over the light
    count, mat (N,), valid (N,), st (N,2); with lt_table also e (N,3)
    the emission and etex (N,) its emission-texture id (-1 off area
    lights), or None in an untextured scene (callers modulate e by the
    texture at st). Without lt_table there is no e: callers read the
    emission of mat (bsdf.emission_at).
    """
    nl = scene.num_lights
    light_idx, _ = remap_index_sample(u_pick, nl)
    if meta is None:
        ltype = scene.light_type[light_idx]
        lmat = scene.light_mat[light_idx]
        loffset = scene.light_offset[light_idx]
        lcount_raw = scene.light_count[light_idx]
        larea = scene.light_area[light_idx]
    else:
        row = meta[light_idx]
        ltype, lmat, loffset = row[..., 0], row[..., 1], row[..., 2]
        lcount_raw = row[..., 3]
        larea = row[..., 4].contiguous().view(torch.float32)
    lcount = torch.clamp(lcount_raw, min=1)

    # area light: uniform triangle pick with sample reuse
    tri_sel, u_rem = remap_index_sample(u_tri, lcount)
    bary = triangle_sample(torch.stack([u_rem, u_uv], dim=-1))
    bu, bv = bary[..., 0], bary[..., 1]

    # the light-side shading normal uses the *hit* convention on the
    # same (u, v) — the reference's convention mismatch (spt.hpp:245)
    e_area = etex_area = None
    if lt_table is not None:
        # the light-triangle row: attributes and emission in one gather;
        # its backward sums every lane into the few light triangles
        lrow = gather_rows(lt_table, loffset.long() + tri_sel, "index")
        # each block requires grad where its source does (block_of)
        arow = lrow if attr is None else block_of(lrow, attr)
        a, b, c = arow[..., 0:3], arow[..., 3:6], arow[..., 6:9]
        # the row is attr | emission 3 [| emission texture 1]
        aw = attr_w if attr_w is not None else lrow.shape[-1] - 3 - scene.has_textures
        e_area = block_of(lrow, scene.emission)[..., aw : aw + 3]
        etex_area = lrow[..., aw + 3].to(torch.int64) if scene.has_textures else None
        sp = shading_parameters(scene, loffset, bu, bv, row=arow)
    else:
        gtri = scene.light_tris[loffset.long() + tri_sel].long()
        if attr is None:
            f = scene.faces[gtri].long()
            a, b, c = (scene.vertices[f[..., k]] for k in range(3))
        else:
            arow = attr[gtri]
            a, b, c = arow[..., 0:3], arow[..., 3:6], arow[..., 6:9]
        sp = shading_parameters(scene, gtri, bu, bv, attr=attr)
    # reference convention: barycentric_to_point = u*a + v*b + (1-u-v)*c
    p_area = bu[..., None] * a + bv[..., None] * b + (1.0 - bu - bv)[..., None] * c
    n_area = sp["n"]
    # guard 1e-12, as in the JAX package (representable when squared)
    pdf_area = 1.0 / maximum(larea, 1e-12)

    hemi, pdf_inf = uniform_hemisphere(torch.stack([u_tri, u_uv], dim=-1))
    p_inf = hemi * 1000.0

    # infinite-light samples (LIGHT_INFINITE) stay invalid: zero NEE weight
    is_area = ltype == LIGHT_AREA

    out = {
        "p": torch.where(is_area[..., None], p_area, p_inf),
        "n": torch.where(is_area[..., None], n_area, 0.0),
        "pdf": torch.where(is_area, pdf_area, pdf_inf) / nl,
        "mat": lmat,
        "valid": is_area & (lcount_raw > 0),
        "st": torch.where(is_area[..., None], sp["st"], 0.0),
    }
    if e_area is not None:
        out["e"] = torch.where(is_area[..., None], e_area, 0.0)
        out["etex"] = None if etex_area is None else torch.where(is_area, etex_area, -1)
    return out

"""BSDF lobe container: eval and one-sample-mixture sampling.

Counterpart of ``phosphorus_mk2_tpu/bsdf/bsdf.py`` (reference
src/bsdf.cpp:113-248): ``bsdf_f`` sums hemisphere-matching lobes times
the incident cosine; ``bsdf_sample`` picks one lobe uniformly (with
sample reuse), then folds in the values and pdfs of flag-compatible
other lobes and averages the pdf.

The container is a struct of tensors over the wavefront: per-hit lobe
arrays gathered from the material tables by material id. Each call takes
one of three routes, picked from what it is handed (``_kernel_route``):
  * kernel: CUDA tensors that autograd need not record (no grad mode, or
    no input that requires grad) are one launch of a kernel
    (bsdf/kernel.py, csrc/bsdf.cu);
  * kernel_grad: CUDA tensors whose only input that requires grad is the
    lobe weight (trainable albedos): the container is linear in the
    weights, so ``bsdf_f`` and ``bsdf_sample`` are an autograd Function
    whose forward is one launch that keeps each slot's lobe value and
    whose backward is one launch of the weight's gradient (``bsdf_pdf``
    reads no weight and takes the kernel route);
  * eager: every other call (the CPU's; directions, uniforms or lobe
    parameters that require grad) runs the eager lobe code, the lobes
    dispatched densely (see bsdf/lobes.py).
The routes give the same values and the same weight gradients, bit for
bit. ``LAUNCHES`` counts the calls of each route; a call is the span
``bsdf.kernel``, ``bsdf.kernel_grad`` or ``bsdf.eager`` while a
torch.profiler session is active. Textures modulate lobe weights
(``apply_textures``) and emission (``emission_at``, ``emission_from_row``,
``env_emission_at``); all of it is the identity for untextured scenes.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.bsdf import kernel
from phosphorus_mk2_tpu_torch.bsdf.lobes import eval_lobe, sample_lobe
from phosphorus_mk2_tpu_torch.core.material import (
    FLAG_REFLECT,
    FLAG_SPECULAR,
    FLAG_TRANSMIT,
    MAX_LOBES,
)
from phosphorus_mk2_tpu_torch.core.texture import (
    direction_to_latlong_uv,
    sample_texture,
    sample_texture_any,
)
from phosphorus_mk2_tpu_torch.math.fresnel import dielectric
from phosphorus_mk2_tpu_torch.math.grad_gather import block_of, gather_rows
from phosphorus_mk2_tpu_torch.math.sampling import remap_index_sample
from phosphorus_mk2_tpu_torch.math.vec import dot
from phosphorus_mk2_tpu_torch.utils.profiling import counted, span

# the container calls (bsdf_f, bsdf_pdf, bsdf_sample) by route
LAUNCHES = counted("bsdf.LAUNCHES", {"bsdf_kernel": 0, "bsdf_kernel_grad": 0, "bsdf_eager": 0})


def material_tables(scene):
    """Packed per-material rows: one float row (weights | params) and one
    int row (types | flags | n_lobes) per material."""
    m, L = scene.lobe_type.shape
    fl = torch.cat(
        [scene.lobe_weight.reshape(m, L * 3), scene.lobe_param.reshape(m, -1)],
        dim=1,
    )
    il = torch.cat(
        [scene.lobe_type, scene.lobe_flags, scene.n_lobes[:, None]], dim=1
    )
    return fl, il


def hit_row_tables(scene, attr):
    """Per-triangle consolidated hit rows: the whole hit side (attributes,
    emission, lobes, NEE pdf and the material's integer columns, texture
    ids included, as exact small-int floats) reads with one row gather.

    Returns (hit_f, hit_i, layout) with
      hit_f: (F, attr_w | emission 3 | weights Lu*3 | params Lu*P |
                 nee_pdf 1 | mat 1 | types Lu | flags Lu | n_lobes 1
                 [| emission_tex 1 | lobe_tex Lu] [| normal_tex 1])
    and hit_i the trailing integer block (Lu = max lobes actually used;
    the texture columns when the scene has textures, the normal-map
    column when it has normal maps).
    """
    m, L = scene.lobe_type.shape
    lu = scene.max_lobes_used or L
    p = scene.lobe_param.shape[2]
    tm = scene.tri_mat.long()
    mat_f = torch.cat(
        [
            scene.emission,
            scene.lobe_weight[:, :lu].reshape(m, lu * 3),
            scene.lobe_param[:, :lu].reshape(m, lu * p),
        ],
        dim=1,
    )
    nee = scene.tri_light_pdf
    if nee is None:
        nee = torch.zeros((tm.shape[0],), dtype=torch.float32, device=tm.device)
    icols = [
        scene.tri_mat[:, None],
        scene.lobe_type[:, :lu][tm],
        scene.lobe_flags[:, :lu][tm],
        scene.n_lobes[tm][:, None],
    ]
    if scene.has_textures:
        icols += [scene.emission_tex[tm][:, None], scene.lobe_tex[:, :lu][tm]]
    if scene.has_normal_maps:
        icols += [scene.normal_tex[tm][:, None]]
    hit_i = torch.cat(icols, dim=1).to(torch.float32)
    # every triangle sums into one of a few material rows in the backward
    hit_f = torch.cat([attr, gather_rows(mat_f, tm, "float64"), nee[:, None], hit_i], dim=1)
    layout = {
        "attr_w": attr.shape[1],
        "lu": lu,
        "p": p,
        "has_tex": scene.has_textures,
        "has_nm": scene.has_normal_maps,
        "int_off": attr.shape[1] + 3 + lu * (3 + p) + 1,
    }
    return hit_f, hit_i, layout


def gather_hit_rows(hit_f, idx, layout=None, trainable=None):
    """``hit_f[idx]``, one row gather for the whole hit side, with the
    gradient restricted to the trainable fields' columns (trainable=None:
    every column differentiable).

    The backward of a gather scatters its whole (N, W) cotangent into
    (F, W) even when only a few columns carry gradient, and every
    column drags its table-building chain into the graph. So the gather
    is split into column blocks: the blocks of non-trainable fields read
    a detached table, and backward scatters only the trainable blocks.
      vertices / normals -> the attribute block [0, attr_w)
      emission           -> [aw, aw + 3)
      lobe_weight        -> [aw + 3, aw + 3 + 3 lu)
      lobe_param         -> [aw + 3 + 3 lu, aw + 3 + lu (3 + p))
    The NEE pdf column and the integer tail are always cut (they feed
    only detached MIS weights and discrete ids). Each differentiable
    block is gathered with gather_rows' "index" backward, scoped or not,
    so both sum the same contributions alike.
    """
    if trainable is None:
        return gather_rows(hit_f, idx, "index")
    aw, lu, p = layout["attr_w"], layout["lu"], layout["p"]
    t = frozenset(trainable)
    segs = [
        (0, aw, bool(t & {"vertices", "normals"})),
        (aw, aw + 3, "emission" in t),
        (aw + 3, aw + 3 + 3 * lu, "lobe_weight" in t),
        (aw + 3 + 3 * lu, aw + 3 + lu * (3 + p), "lobe_param" in t),
        (aw + 3 + lu * (3 + p), hit_f.shape[1], False),
    ]
    merged = []  # adjacent blocks of the same kind in one gather
    for c0, c1, d in segs:
        if c1 <= c0:
            continue
        if merged and merged[-1][2] == d:
            merged[-1] = (merged[-1][0], c1, d)
        else:
            merged.append((c0, c1, d))
    if all(not d for _, _, d in merged):
        return hit_f.detach()[idx]
    if all(d for _, _, d in merged):
        return gather_rows(hit_f, idx, "index")
    return torch.cat(
        [gather_rows(hit_f[:, c0:c1], idx, "index") if d else hit_f.detach()[:, c0:c1][idx]
         for c0, c1, d in merged],
        dim=1,
    )


def unpack_hit_rows(scene, hrow, irow, layout):
    """Parse gathered consolidated rows into (mat_id (N,), emission (N,3),
    lobes dict, nee_pdf (N,), tex dict). irow: the gathered integer
    block (hit_i rows), or None to read it from hrow's exact small-int
    float columns (the one-gather form). The tex dict holds, when the
    scene has them, emission_tex (N,) and lobe_tex (N, Lu), and
    normal_tex (N,). The emission, the weights and the parameters require
    grad only where the scene's own field does (``block_of``)."""
    aw, lu, p = layout["attr_w"], layout["lu"], layout["p"]
    n = hrow.shape[0]
    emission = block_of(hrow, scene.emission)[:, aw : aw + 3]
    weight = block_of(hrow, scene.lobe_weight)[:, aw + 3 : aw + 3 + lu * 3].reshape(n, lu, 3)
    param = block_of(hrow, scene.lobe_param)[:, aw + 3 + lu * 3 : aw + 3 + lu * (3 + p)]
    param = param.reshape(n, lu, p)
    nee_pdf = hrow[:, aw + 3 + lu * (3 + p)]
    irow = (hrow[:, layout["int_off"] :] if irow is None else irow).to(torch.int64)
    lobes = {
        "type": irow[:, 1 : 1 + lu],
        "weight": weight,
        "param": param,
        "flags": irow[:, 1 + lu : 1 + 2 * lu],
        "n": irow[:, 1 + 2 * lu],
        "present": scene.lobe_types_present or None,
        "max_lobes": lu,
    }
    tex = {}
    col = 2 + 2 * lu
    if layout["has_tex"]:
        tex["emission_tex"] = irow[:, col]
        tex["lobe_tex"] = irow[:, col + 1 : col + 1 + lu]
        col += 1 + lu
    if layout["has_nm"]:
        tex["normal_tex"] = irow[:, col]
    return irow[:, 0], emission, lobes, nee_pdf, tex


def gather_lobes(scene, mat_id, tables=None) -> dict:
    """Per-hit lobe arrays for a wavefront of material ids (N,).
    tables: optional material_tables(scene) (two gathers instead of five).
    The float rows are gathered with gather_rows' "float64" backward:
    every lane sums into one of a few material rows."""
    mat_id = mat_id.long()
    if tables is None:
        gathered = {
            "type": scene.lobe_type[mat_id].long(),
            "weight": gather_rows(scene.lobe_weight, mat_id, "float64"),
            "param": gather_rows(scene.lobe_param, mat_id, "float64"),
            "flags": scene.lobe_flags[mat_id].long(),
            "n": scene.n_lobes[mat_id].long(),
        }
    else:
        fl, il = tables
        n = mat_id.shape[0]
        _, L = scene.lobe_type.shape
        frow = gather_rows(fl, mat_id, "float64")
        irow = il[mat_id].long()
        gathered = {
            "type": irow[:, :L],
            "weight": block_of(frow, scene.lobe_weight)[:, : L * 3].reshape(n, L, 3),
            "param": block_of(frow, scene.lobe_param)[:, L * 3 :].reshape(n, L, -1),
            "flags": irow[:, L : 2 * L],
            "n": irow[:, 2 * L],
        }
    gathered["present"] = scene.lobe_types_present or None
    gathered["max_lobes"] = scene.max_lobes_used or MAX_LOBES
    return gathered


def apply_fresnel(scene, lobes: dict, n, wi) -> dict:
    """Per-hit fresnel lobe weighting (the reference Glass expansion's
    fresnel + mix subgraph; eta inverted when backfacing).

    lobe param[4]: 0 = none, 1 = weight by F, 2 = weight by 1-F;
    param[5]: ior. The identity for scenes without fresnel lobes.
    """
    if not scene.has_fresnel:
        return lobes
    L = lobes.get("max_lobes", MAX_LOBES)
    mode = lobes["param"][:, :L, 4]
    ior = lobes["param"][:, :L, 5]
    cosi = dot(n, wi)[:, None]
    F = dielectric(cosi, torch.where(ior == 0.0, 1.5, ior))
    factor = torch.where(mode == 1.0, F, torch.where(mode == 2.0, 1.0 - F, 1.0))
    w = lobes["weight"][:, :L] * factor[..., None]
    out = dict(lobes)
    out["weight"] = torch.cat([w, lobes["weight"][:, L:]], dim=1) if L < MAX_LOBES else w
    return out


def apply_textures(scene, lobes: dict, mat_id, st, tex=None, footprint=None) -> dict:
    """Fold texture lookups into the per-hit lobe weights (the form of the
    reference's OSL texture() closure inputs). The identity for
    untextured scenes. tex: optional pre-gathered (N, L) lobe-texture ids
    (the consolidated hit row); footprint: optional uv footprint, (N,) or
    the anisotropic dict of integrator/path._footprint."""
    if not scene.has_textures:
        return lobes
    L = lobes.get("max_lobes", MAX_LOBES)
    if tex is None:
        tex = scene.lobe_tex[mat_id.long()][:, :L]
    else:
        tex = tex[:, :L]
    n = mat_id.shape[0]
    flat_tex = tex.reshape(-1)
    flat_st = st[:, None, :].expand(n, L, 2).reshape(-1, 2)
    flat_fp = None
    if isinstance(footprint, dict):
        # each per-ray field broadcast over the lobe-slot axis
        flat_fp = {
            "minor": footprint["minor"][:, None].expand(n, L).reshape(-1),
            "major_uv": footprint["major_uv"][:, None, :].expand(n, L, 2).reshape(-1, 2),
            "taps": footprint["taps"],
        }
    elif footprint is not None:
        flat_fp = footprint[:, None].expand(n, L).reshape(-1)
    factor = _sample_any(scene, flat_tex, flat_st, footprint=flat_fp).reshape(n, L, 3)
    weight = torch.where(
        (tex >= 0)[..., None], lobes["weight"][:, :L] * factor, lobes["weight"][:, :L]
    )
    out = dict(lobes)
    out["weight"] = (
        torch.cat([weight, lobes["weight"][:, L:]], dim=1) if L < MAX_LOBES else weight
    )
    return out


def _sample_any(scene, tex_id, uv, footprint=None):
    """Texture sample honouring procedural textures when the scene has any."""
    if scene.has_procedural:
        return sample_texture_any(
            {
                "atlas": scene.tex_atlas,
                "info": scene.tex_info,
                "proc": scene.tex_proc,
                "proc_params": scene.tex_proc_params,
            },
            tex_id, uv, footprint=footprint,
        )
    return sample_texture(scene.tex_atlas, scene.tex_info, tex_id, uv,
                          footprint=footprint)


def emission_at(scene, mat_id, st=None, tables=None, footprint=None):
    """Per-hit emission of material ids (N,), texture-modulated when the
    material has an emission texture. tables (material_tables) is
    accepted and unused, as in the JAX package: the emission gather
    stays apart from the wide material rows. The gather has gather_rows'
    "float64" backward: every lane sums into one of a few rows."""
    mat_id = mat_id.long()
    e = gather_rows(scene.emission, mat_id, "float64")
    if not scene.has_textures:
        return e
    t = scene.emission_tex[mat_id]
    f = _sample_any(scene, t, st, footprint=footprint)
    return torch.where((t >= 0)[..., None], e * f, e)


def emission_from_row(scene, e, etex=None, st=None, footprint=None):
    """Texture-modulated emission from pre-gathered values (the
    consolidated hit row): e (N,3), etex (N,) texture ids or None when
    untextured."""
    if not scene.has_textures or etex is None:
        return e
    f = _sample_any(scene, etex, st, footprint=footprint)
    return torch.where((etex >= 0)[..., None], e * f, e)


def env_emission_at(scene, d):
    """Environment radiance for miss directions: the emission of the
    environment material (times its lat-long emission texture, looked up
    bilinearly at level 0), or black without one."""
    if scene.env_mat < 0:
        return torch.zeros((d.shape[0], 3), dtype=torch.float32, device=d.device)
    e = scene.emission[scene.env_mat].expand(d.shape[0], 3)
    if not scene.has_textures:
        return e
    t = scene.emission_tex[scene.env_mat]
    f = _sample_any(scene, t.expand(d.shape[0]), direction_to_latlong_uv(d))
    return torch.where(t >= 0, e * f, e)


def _hemisphere_match(flags_i, n, wi, wo):
    """reflect/transmit matching (reference src/bsdf.cpp:120-127)."""
    reflect = dot(n, wi) * dot(n, wo) > 0.0
    is_refl = (flags_i & FLAG_REFLECT) == FLAG_REFLECT
    is_trans = (flags_i & FLAG_TRANSMIT) == FLAG_TRANSMIT
    reflect = reflect.reshape(reflect.shape + (1,) * (flags_i.ndim - reflect.ndim))
    return torch.where(reflect, is_refl, is_trans)


def _eval_all_slots(lobes: dict, n, wi, wo):
    """One flattened eval_lobe over the (hit x lobe slot) axis. Returns
    (e, pdf) of shape (N, L)."""
    num = wi.shape[0]
    L = lobes.get("max_lobes", MAX_LOBES)
    flat_type = lobes["type"][:, :L].reshape(-1)
    flat_param = lobes["param"][:, :L].reshape(num * L, -1)

    def tile(x):
        return x[:, None, :].expand(num, L, 3).reshape(num * L, 3)

    e, pdf = eval_lobe(flat_type, flat_param, tile(n), tile(wi), tile(wo),
                       present=lobes.get("present"))
    return e.reshape(num, L), pdf.reshape(num, L)


def _slots(L: int, device):
    return torch.arange(L, device=device)[None, :]


def _kernel_route(lobes: dict, *xs) -> str:
    """A container call's route: "kernel" on CUDA inputs that autograd has
    nothing to record for (grad mode off, or neither the directions, the
    uniforms nor the lobe weights and parameters require grad);
    "kernel_grad" on CUDA inputs of which only the lobe weights require
    grad; "eager" otherwise."""
    if not xs[0].is_cuda:
        return "eager"
    if not torch.is_grad_enabled():
        return "kernel"
    if any(t.requires_grad for t in (*xs, lobes["param"])):
        return "eager"
    return "kernel_grad" if lobes["weight"].requires_grad else "kernel"


def _call(kernel_fn, grad_fn, eager_fn, lobes: dict, *xs):
    """Run one container call on its route, spanned, and count it once it
    has returned. grad_fn None: the call reads no weight, and the kernel
    route serves the kernel_grad one."""
    route = _kernel_route(lobes, *xs)
    if route == "kernel_grad" and grad_fn is None:
        route = "kernel"
    fn = {"kernel": kernel_fn, "kernel_grad": grad_fn, "eager": eager_fn}[route]
    with span(f"bsdf.{route}"):
        out = fn(lobes, *xs)
    LAUNCHES[f"bsdf_{route}"] += 1
    return out


class _WeightGrad(torch.autograd.Function):
    """A container call whose only input that requires grad is the lobe
    weight: the forward is kernel.bsdf_f_saving / bsdf_sample_saving (the
    call's values and what the weight's gradient reads), the backward
    kernel.bsdf_weight_grad, at the weight's own shape. wo, the pdf and
    the flags do not depend on the weights."""

    @staticmethod
    def forward(ctx, weight, sample: bool, lobes: dict, n, wi, x):
        saving = kernel.bsdf_sample_saving if sample else kernel.bsdf_f_saving
        out, saved = saving(dict(lobes, weight=weight), n, wi, x)
        ctx.save_for_backward(*saved)
        ctx.sample, ctx.slots = sample, weight.shape[1]
        if sample:
            ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g, *_):
        gw = kernel.bsdf_weight_grad(g, *ctx.saved_tensors, ctx.slots, ctx.sample)
        return gw, None, None, None, None, None


def _bsdf_f_kernel_grad(lobes: dict, n, wi, wo):
    return _WeightGrad.apply(lobes["weight"], False, lobes, n, wi, wo)


def _bsdf_sample_kernel_grad(lobes: dict, n, wi, u2):
    return _WeightGrad.apply(lobes["weight"], True, lobes, n, wi, u2)


def bsdf_f(lobes: dict, n, wi, wo):
    """Evaluate the container (reference bsdf_t::f, src/bsdf.cpp:113-131).

    wi = direction toward the light; wo = toward the viewer. Includes the
    incident-cosine factor. Returns (N, 3) rgb.
    """
    return _call(kernel.bsdf_f, _bsdf_f_kernel_grad, _bsdf_f_eager, lobes, n, wi, wo)


def _bsdf_f_eager(lobes: dict, n, wi, wo):
    return _bsdf_f_sum(lobes, *_bsdf_f_parts(lobes, n, wi, wo))


def _bsdf_f_parts(lobes: dict, n, wi, wo):
    """bsdf_f's weight-free part: every slot's lobe value e (N, L), the
    incident cosine atl (N,) and the active hemisphere-matching slots
    (N, L) bool."""
    L = lobes.get("max_lobes", MAX_LOBES)
    atl = dot(n, wi)
    match = _hemisphere_match(lobes["flags"][:, :L], n, wi, wo)
    active = _slots(L, n.device) < lobes["n"][:, None]
    e, _ = _eval_all_slots(lobes, n, wi, wo)
    return e, atl, active & match


def _bsdf_f_sum(lobes: dict, e, atl, on):
    """bsdf_f's value from its parts and the weights."""
    contrib = e[..., None] * lobes["weight"][:, : e.shape[1]] * atl[..., None, None]
    return torch.where(on[..., None], contrib, 0.0).sum(dim=1)


def bsdf_pdf(lobes: dict, n, wi, wo):
    """Solid-angle pdf of the uniform one-sample lobe mixture sampling
    ``wi`` given the viewer direction ``wo``: (1/n_lobes) times the sum
    of the active hemisphere-matching lobes' pdfs. Returns (N,)."""
    return _call(kernel.bsdf_pdf, None, _bsdf_pdf_eager, lobes, n, wi, wo)


def _bsdf_pdf_eager(lobes: dict, n, wi, wo):
    L = lobes.get("max_lobes", MAX_LOBES)
    match = _hemisphere_match(lobes["flags"][:, :L], n, wi, wo)
    active = _slots(L, n.device) < lobes["n"][:, None]
    _, pdf = _eval_all_slots(lobes, n, wi, wo)
    total = torch.where(active & match, pdf, 0.0).sum(dim=1)
    return total / torch.clamp(lobes["n"], min=1).to(total.dtype)


def bsdf_sample(lobes: dict, n, wi, u2):
    """Sample the container (reference bsdf_t::sample, src/bsdf.cpp:133-248).

    wi = direction toward the previous path vertex; u2 = (N, 2) uniforms.
    Returns (f (N,3), wo (N,3), pdf (N,), flags (N,) int64).
    """
    return _call(kernel.bsdf_sample, _bsdf_sample_kernel_grad, _bsdf_sample_eager, lobes,
                 n, wi, u2)


def _bsdf_sample_eager(lobes: dict, n, wi, u2):
    parts = _bsdf_sample_parts(lobes, n, wi, u2)
    _, _, wo, pdf, flags_sel, valid, _, _ = parts
    return _bsdf_sample_sum(lobes, parts), wo, torch.where(valid, pdf, 0.0), flags_sel


def _sel_slot(onehot, arr):
    """The selected slot of (N, L, ...) ``arr`` by broadcast-select over
    the (few) lobe slots."""
    m = onehot.reshape(onehot.shape + (1,) * (arr.ndim - 2))
    return torch.where(m, arr, 0).sum(dim=1)


def _bsdf_sample_parts(lobes: dict, n, wi, u2):
    """bsdf_sample's weight-free part: (onehot (N, slots) the selected
    slot, f_s (N,) its lobe value, wo, the mixture pdf before the validity
    zeroing, flags (N,), valid (N,) the selected lobe's pdf is not 0,
    use (N, L) the folded-in slots and e (N, L) every slot's lobe value at
    wo; use and e are None for one lobe slot)."""
    n_lobes = torch.clamp(lobes["n"], min=1)
    idx, u_remap = remap_index_sample(u2[..., 0], n_lobes)
    Lsel = lobes["type"].shape[1]
    onehot = idx[:, None] == torch.arange(Lsel, device=idx.device)[None, :]
    type_sel = _sel_slot(onehot, lobes["type"])
    param_sel = _sel_slot(onehot, lobes["param"])
    flags_sel = _sel_slot(onehot, lobes["flags"])

    remapped = torch.stack([u_remap, u2[..., 1]], dim=-1)
    f_s, wo, pdf = sample_lobe(type_sel, param_sel, n, wi, remapped,
                               present=lobes.get("present"))
    valid = pdf != 0.0

    # fold in the other flag-compatible lobes (one-sample mixture,
    # reference src/bsdf.cpp:226-247); nothing to fold for one lobe
    L = lobes.get("max_lobes", MAX_LOBES)
    use = e_all = None
    if L > 1:
        slot = _slots(L, n.device)
        flags_all = lobes["flags"][:, :L]
        subset = (flags_sel[:, None] & flags_all) == flags_all
        cond = (slot != idx[:, None]) & (slot < lobes["n"][:, None]) & subset
        use = cond & _hemisphere_match(flags_all, n, wi, wo)
        e_all, pdf_all = _eval_all_slots(lobes, n, wi, wo)
        pdf = pdf + torch.where(use, pdf_all, 0.0).sum(dim=1)
        pdf = pdf / (1 + use.sum(dim=1)).to(pdf.dtype)
    return onehot, f_s, wo, pdf, flags_sel, valid, use, e_all


def _bsdf_sample_sum(lobes: dict, parts):
    """bsdf_sample's value from its parts and the weights."""
    onehot, f_s, _, _, _, valid, use, e_all = parts
    result = f_s[..., None] * _sel_slot(onehot, lobes["weight"])
    if use is not None:
        result = result + torch.where(
            use[..., None], e_all[..., None] * lobes["weight"][:, : use.shape[1]], 0.0
        ).sum(dim=1)
    return torch.where(valid[..., None], result, 0.0)


def is_specular_flags(flags):
    return (flags & FLAG_SPECULAR) == FLAG_SPECULAR

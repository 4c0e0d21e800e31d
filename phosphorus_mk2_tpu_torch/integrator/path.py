"""Wavefront unidirectional path integrator with NEE and Russian roulette.

Counterpart of ``phosphorus_mk2_tpu/integrator/path.py`` (reference
src/kernels/cpu/spt.hpp: trace -> shade -> shadow trace -> integrate).
The bounce loop is a Python loop over ``max_depth`` on
dense (N, ...) path state with per-ray alive masks, exactly the JAX
package's scan; every random number is counter-based (math/rng.py), so
the same seed gives the JAX package's samples.

Reference semantics kept (mis=False, the reference's own integrator;
mis=True is the JAX package's balance-heuristic deviation):
  * emission is added at the first vertex and after specular bounces
    only (spt.hpp:177-179); environment emission on a miss (spt.hpp:201);
  * NEE: shadow rays are masked when the light lies in the lower
    hemisphere; the direct-light factor is
    (e * 4) * f / (light_pdf * d^2 / |cos theta_l|) (spt.hpp:252-254);
  * Russian roulette after 3 vertices with q = max(0.05, 1 - lum(beta))
    and survivor reweighting (spt.hpp:307-328);
  * throughput update beta *= f * |n.wo| / pdf (spt.hpp:291-299).

Differentiability, as in the JAX package: radiance is differentiable
with respect to the scene's vertices, normals, lobe weights and
parameters and emission. The trace is primal: every tracer call runs
under ``torch.no_grad()`` on detached rays, so no hand kernel sees a
tensor that requires grad, and gradients flow through the
re-intersection (accel/intersect.reintersect) and the gathered hit,
attribute and light rows. Discrete events (hit ids, visibility, lobe
choice, Russian roulette) carry no gradient: these are interior
gradients, without visibility-edge terms. ``trainable`` scopes the
backward to a set of fields (``scope_scene``, ``gather_hit_rows``).
Forward renders (``render_aovs``, ``Renderer``) run under
``torch.no_grad()`` and build no graph.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from phosphorus_mk2_tpu_torch.accel import mt
from phosphorus_mk2_tpu_torch.accel.block_traverse import intersect_blocks, occluded_blocks
from phosphorus_mk2_tpu_torch.accel.cluster_traverse import (
    intersect_clusters,
    occluded_clusters,
)
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, reintersect
from phosphorus_mk2_tpu_torch.accel.sort import sorted_trace
from phosphorus_mk2_tpu_torch.accel.traverse import intersect_bvh, occluded_bvh
from phosphorus_mk2_tpu_torch.bsdf.bsdf import (
    apply_fresnel,
    apply_textures,
    bsdf_f,
    bsdf_pdf,
    bsdf_sample,
    emission_at,
    emission_from_row,
    env_emission_at,
    gather_hit_rows,
    gather_lobes,
    hit_row_tables,
    is_specular_flags,
    material_tables,
    unpack_hit_rows,
)
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params, generate_rays
from phosphorus_mk2_tpu_torch.core.lights import (
    light_meta_table,
    light_tri_table,
    sample_lights,
)
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.core.shading import (
    apply_normal_map,
    shading_parameters,
    triangle_attribute_table,
)
from phosphorus_mk2_tpu_torch.math import rng
from phosphorus_mk2_tpu_torch.math.grad_gather import block_of
from phosphorus_mk2_tpu_torch.math.vec import (
    RAY_EPSILON,
    dot,
    is_black,
    luminance,
    maximum,
    normalize,
    offset,
)
from phosphorus_mk2_tpu_torch.utils import profiling

# above this many triangles a scene with a BVH takes the cluster tracer
BRUTE_MAX_TRIS = 1024


def make_tracer(scene, use_bvh: bool = True, use_pallas: bool = False,
                kind: str = "auto", tracer_tune: dict | None = None,
                plain: bool = False):
    """Pick the traversal backend: a pair (closest, occluded) with

      closest(p, d, tmax=None) -> {"t", "tri", "u", "v", "hit"}
      occluded(p, d, tmax) -> (N,) bool

    kind: "auto" (the cluster tracer when a BVH is attached and the scene
    has more than 1024 triangles, else brute force), "cluster" (the
    gather-wave cluster tracer of accel/cluster_traverse.py; needs an
    attached BVH), "block" (shared-stack blocks of accel/block_traverse.py
    over the wavefront sorted by accel/sort.py; needs a BVH), "per_ray"
    (the per-ray stacks of accel/traverse.py, an oracle; needs a BVH),
    "brute" (dense all pairs: oracle and small scenes). On a CUDA scene
    the brute tracer runs the hand kernels of accel/mt.py whatever
    ``use_pallas`` says; on a CPU scene, their plain versions. "block"
    and "per_ray" run eager PyTorch on the scene's device, and
    ``tracer_tune`` and ``plain`` do not apply to them.

    tracer_tune: cluster-tracer tunables (see cluster_traverse._trace),
    among them slab_bf16, front_levels and
    wave_dedup / dedup_d keep every winner; rows_bf16 traces bf16 rows
    and changes images (the any-hit trace then widens its margins);
    ignored by the brute tracer. A "shadow" sub-dict overrides keys for
    the any-hit trace only: shadow rays end on the first hit within a
    short tmax and need no front-to-back completeness, so for example a
    shallower front_k, or rows_bf16 for shadows alone, can serve them
    (the exact fallback covers overflow either way).

    plain=True takes the kernels' plain versions on any device (for the
    cluster tracer, the same as tracer_tune={"plain": True}), so that a
    whole render can be held against the kernels on the card.
    """
    has_bvh = use_bvh and scene.bvh is not None
    if kind == "auto":
        kind = "cluster" if has_bvh and scene.num_tris > BRUTE_MAX_TRIS else "brute"
    if kind in ("block", "per_ray", "cluster") and not has_bvh:
        raise ValueError(f"tracer kind {kind!r} requires an attached BVH")
    if kind == "block":
        def closest(p, d, tmax=None):
            return sorted_trace(intersect_blocks, scene, p, d, tmax)

        def occluded(p, d, tmax):
            return sorted_trace(occluded_blocks, scene, p, d, tmax)

        return closest, occluded
    if kind == "per_ray":
        return functools.partial(intersect_bvh, scene), functools.partial(occluded_bvh, scene)
    if kind == "cluster":
        tune = dict(tracer_tune or {})
        if plain:
            tune["plain"] = True
        shadow = {**tune, **(tune.pop("shadow", None) or {})}
        shadow.pop("shadow", None)
        return (
            functools.partial(intersect_clusters, scene, **tune),
            functools.partial(occluded_clusters, scene, **shadow),
        )
    if kind != "brute":
        raise ValueError(f"unknown tracer kind {kind!r}")
    return BruteTracer(scene, plain)


class BruteTracer(tuple):
    """The brute tracer pair (accel/mt.brute_tracer) over the triangle
    table of a scene's detached vertices. ``render_pass_pixels``, and a
    direct ``trace_sample`` call, remake it from the scene they render
    (``tracer_for``), so that a render traces the geometry it is given,
    as the JAX package's tracers, which take the scene at every call, do.
    plain=True takes the kernels' plain versions on any device."""

    def __new__(cls, scene, plain: bool = False):
        with torch.no_grad():
            table = mt.tri_table(scene)
        self = super().__new__(cls, mt.brute_tracer(table, plain=plain))
        self.plain = plain
        return self


def tracer_for(tracer, scene):
    """The tracer pair that traces ``scene``: a BruteTracer remade from
    it (one table build), any other pair as given (the cluster tracer
    keeps the BVH it was made with, which goes stale when vertices move,
    as the JAX package's does)."""
    return BruteTracer(scene, tracer.plain) if isinstance(tracer, BruteTracer) else tracer


# the per-triangle hit rows cost ~(attr_w + 4 + 9 * Lu) floats a triangle;
# they are built only up to this size, where that is still small beside
# the geometry itself (the JAX package's threshold)
HIT_ROW_MAX_TRIS = 1 << 18

# SceneData fields a caller may declare trainable (the gradient-scoping
# contract shared with optim.InverseRenderer)
SCOPABLE_FIELDS = ("vertices", "normals", "emission", "lobe_weight", "lobe_param")


def scope_scene(scene, trainable):
    """Detach every scopable field not in ``trainable``.

    The gradients of the trainable fields are the same with or without
    this (a detach elsewhere changes no partial derivative with respect
    to them); the backward graph only shrinks to the chains that start
    at the trainable set. trainable=None returns the scene unchanged.
    An unknown field name raises ValueError: it would otherwise detach
    every real field and give exactly-zero gradients.
    """
    if trainable is None:
        return scene
    t = frozenset(trainable)
    unknown = t - frozenset(SCOPABLE_FIELDS)
    if unknown:
        raise ValueError(
            f"unknown trainable field(s) {sorted(unknown)}; scopable: {SCOPABLE_FIELDS}"
        )
    cut = {
        f: getattr(scene, f).detach()
        for f in SCOPABLE_FIELDS
        if f not in t and getattr(scene, f, None) is not None
    }
    return dataclasses.replace(scene, **cut) if cut else scene


def make_scene_tables(scene) -> dict:
    """The consolidated gather tables trace_sample reads: per-triangle
    attribute rows, material rows, light rows and per-light-triangle rows
    (the NEE side's attributes and emission in one gather; light
    triangles are few, so always built), and, up to HIT_ROW_MAX_TRIS
    triangles, the per-triangle hit rows hit_f / hit_i / hit_layout (the
    whole hit side in one gather).

    Above HIT_ROW_MAX_TRIS there are no hit rows, as in the JAX package:
    trace_sample then shades from the attribute table, scene.tri_mat and
    the material tables. Both branches read the same values, so their
    films are equal (tests/test_torch_shading_path.py)."""
    attr = triangle_attribute_table(scene)
    hit = hit_row_tables(scene, attr) if scene.num_tris <= HIT_ROW_MAX_TRIS else None
    tables = {
        "attr": attr,
        "mat": material_tables(scene),
        "light": light_meta_table(scene),
        "light_tri": light_tri_table(scene, attr),
    }
    if hit is not None:
        tables.update(zip(("hit_f", "hit_i", "hit_layout"), hit))
    return tables


def pixel_hash(pixel_x, pixel_y):
    """uint32 pixel key (y << 16) | x, held in int64."""
    return ((pixel_y.long() << 16) | pixel_x.long()) & 0xFFFFFFFF


MAX_ANISO = 8.0  # major/minor clamp, like OIIO's default aniso limit


def _footprint(plen, t_hit, sp, d, spread, aniso_taps: int = 0):
    """uv-space sample footprint at this hit (primal only: mip selection
    carries no gradient). plen: (N,) camera-to-vertex path length before
    this segment; spread: the ray cone's angular spread.

    aniso_taps=0: a scalar diameter, the ray-cone width (spread x
    distance) x the triangle's uv-per-world scale, stretched by
    1/sqrt(|cos|) at grazing incidence (the geometric mean of the
    anisotropic footprint's two axes).

    aniso_taps>0: the cone's elliptical intersection with the surface as
    {"minor", "major_uv", "taps"} for core/texture._sample_aniso: minor =
    cone width x uv_scale (the lod axis); major = the in-plane projected
    view direction, of length cone / max(cos, 1/MAX_ANISO), mapped from
    world to uv through the triangle's edges (a least-squares solve over
    the edges shading_parameters already read).
    """
    dist = plen + t_hit.detach()
    cos_i = (sp["ng"] * d).sum(dim=-1).abs()
    w_c = dist * spread  # world-space cone diameter at the hit
    uv_scale = sp["uv_scale"].detach()
    if not aniso_taps:
        graze = 1.0 / torch.sqrt(maximum(cos_i, 1e-2))
        return (w_c * graze) * uv_scale

    ng = sp["ng"].detach()
    e0w, e1w, e0t, e1t = (e.detach() for e in sp["edges"])
    # in-plane major-axis direction: the projected view direction
    t_w = d - ng * (ng * d).sum(dim=-1, keepdim=True)
    t_len = torch.sqrt(maximum((t_w * t_w).sum(-1), 1e-20))
    # near normal incidence the projection vanishes and the ellipse is a
    # circle: any in-plane direction works; fall back to edge 0
    degenerate = t_len < 1e-6
    t_hat = torch.where(
        degenerate[:, None],
        e0w / torch.sqrt(maximum((e0w * e0w).sum(-1, keepdim=True), 1e-20)),
        t_w / t_len[:, None],
    )
    # world -> uv by least squares over the triangle edges: solve
    # [e0w e1w] (a, b) ~= t_hat, then uv_dir = a * e0t + b * e1t
    g00 = (e0w * e0w).sum(-1)
    g01 = (e0w * e1w).sum(-1)
    g11 = (e1w * e1w).sum(-1)
    det = maximum(g00 * g11 - g01 * g01, 1e-12)
    r0 = (e0w * t_hat).sum(-1)
    r1 = (e1w * t_hat).sum(-1)
    a = (g11 * r0 - g01 * r1) / det
    b = (g00 * r1 - g01 * r0) / det
    uv_dir = a[:, None] * e0t + b[:, None] * e1t  # uv image of t_hat
    major_world = w_c / maximum(cos_i, 1.0 / MAX_ANISO)
    return {
        "minor": w_c * uv_scale,
        "major_uv": uv_dir * major_world[:, None],
        "taps": int(aniso_taps),
    }


def cone_spread(scene, cam_params):
    """The ray cone's angular spread, one pixel's angle at the image
    centre (zoom / height radians), when the scene's textures have mip
    levels to choose from; else None (no footprint is computed)."""
    info = scene.tex_info
    if not (scene.has_textures and info is not None and info.ndim == 3
            and info.shape[1] > 1):
        return None
    return 1.12 * torch.tan(cam_params["fov"] * 0.5) / cam_params["height"]


def trace_sample(
    scene,
    cam_params,
    pixel_x,
    pixel_y,
    sample_idx,
    seed: int,
    *,
    max_depth: int,
    tracer,
    film_strata: int = 1,
    mis: bool = False,
    tables: dict | None = None,
    remat: bool = False,
    pipeline_shadow: bool = False,
    aniso_taps: int = 0,
    trainable: tuple | None = None,
):
    """Trace one sample per pixel for a wavefront. Returns (radiance (N,3),
    first-hit normal (N,3), first-hit alpha (N,)).

    seed: the render seed (its low 32 bits key the RNG, as
    ``jax.random.key(seed)`` does in the JAX package). sample_idx: an int,
    or an (N,) integer tensor of per-ray sample indices (spp_batch).
    film_strata: stratify the film jitter on a d x d grid cycled by
    sample index. aniso_taps: texture probes along the footprint's major
    axis (0 = isotropic trilinear).

    mis: multiple importance sampling between NEE and BSDF sampling
    (balance heuristic), the JAX package's flag-gated deviation from the
    reference: emission is kept at every vertex with balance weights and
    the (e*4) NEE factor is dropped, so both strategies estimate the same
    integral. mis=False is the reference's own integrator.

    trainable: the SCOPABLE_FIELDS the caller will differentiate with
    respect to; gradient flow from every other field is cut (scope_scene
    and the column-scoped hit-row gather), and the gradients of the listed
    fields are those of trainable=None.

    pipeline_shadow: bounce b's NEE shadow rays ride in bounce b+1's
    closest-hit trace (one 2N-ray trace a bounce instead of a closest-hit
    and an any-hit trace); their contribution lands one bounce later, and
    one any-hit trace after the loop resolves the last bounce's. The
    same values up to float summation order. In effect only when the
    scene has lights. The shadow half goes through ``closest``, so a
    cluster tracer's ``"shadow"`` tunables and any-hit margins reach only
    the trailing resolve, as in the JAX package.

    remat: under autograd (grad enabled and some scene tensor or camera
    ray requiring grad), each bounce runs through
    ``torch.utils.checkpoint``: only the bounce's carry is kept for the
    backward, which runs the bounce again, trace included
    (``jax.checkpoint``'s default policy). Otherwise the bounce runs as it
    does without it.
    """
    n = pixel_x.shape[0]
    dev = pixel_x.device
    if tables is None:  # a direct call: render_pass_pixels does this once a pass
        scene = scope_scene(scene, trainable)
        tables = make_scene_tables(scene)
        tracer = tracer_for(tracer, scene)
    closest, occluded = tracer
    attr = tables["attr"]
    mat_tables = tables["mat"]
    hit_f = tables.get("hit_f")
    hit_layout = tables.get("hit_layout")

    seed32 = rng.seed_word(seed)
    pix = pixel_hash(pixel_x, pixel_y)
    u_cam = rng.pixel_uniforms4(seed32, pix, sample_idx, 0, 0)
    film_u, lens_u = u_cam[:, 0:2], u_cam[:, 2:4]
    if film_strata > 1:
        ds = film_strata
        if torch.is_tensor(sample_idx):  # per-ray sample indices: a cell each
            cell = sample_idx.to(device=dev, dtype=torch.int64) % (ds * ds)
            off = torch.stack([cell % ds, cell // ds], dim=-1).to(torch.float32)
        else:
            cell = int(sample_idx) % (ds * ds)
            off = torch.tensor(
                [[float(cell % ds), float(cell // ds)]], dtype=torch.float32, device=dev
            )
        film_u = (off + film_u) / ds

    p, d = generate_rays(cam_params, pixel_x, pixel_y, film_u, lens_u)
    # the ray cone drives mip selection like the reference's OSL
    # texture() derivatives (src/material.cpp:127-129)
    spread = cone_spread(scene, cam_params)

    nee_enabled = scene.num_lights > 0
    pipe = pipeline_shadow and nee_enabled

    def bounce(b: int, s: dict) -> dict:
        """Bounce b on the carry s; returns the next carry."""
        with profiling.stages() as stage:
            return bounce_stages(b, s, stage)

    def bounce_stages(b: int, s: dict, stage) -> dict:
        """bounce's body; ``stage(name)`` closes the last stage's span and
        opens the next (a no-op when tracing is off)."""
        stage("integrator.trace")
        p, d, beta, radiance, alive = s["p"], s["d"], s["beta"], s["radiance"], s["alive"]
        spec, pdf_prev, plen, pend = s["spec"], s["pdf_prev"], s["plen"], s["pend"]
        # the primal trace; dead lanes trace with tmax ~ 0
        tmax = torch.where(alive, T_MAX, 1e-6)
        with torch.no_grad():
            if pend is None:
                hits = closest(p.detach(), d.detach(), tmax)
            else:
                # this bounce's rays and the previous bounce's shadow rays
                # in one trace; a shadow ray's "hit" is its occlusion
                both = closest(torch.cat([p, pend["p"]]).detach(),
                               torch.cat([d, pend["d"]]).detach(),
                               torch.cat([tmax, pend["tmax"].detach()]))
                hits = {k: v[:n] for k, v in both.items()}
                occ_prev = both["hit"][n:]
        if pend is not None:
            radiance = radiance + torch.where(
                (pend["valid"] & ~occ_prev)[..., None], pend["contrib"], 0.0
            )
        stage("integrator.hit_rows")
        tri = hits["tri"]
        hit = hits["hit"] & alive
        safe_tri = torch.clamp(tri, min=0).long()

        if hit_f is not None:
            # consolidated hit side: ONE row gather feeds the
            # re-intersection, shading attributes, material lobes,
            # emission, texture ids and the NEE pdf
            hrow = gather_hit_rows(hit_f, safe_tri, hit_layout, trainable)
            mat_raw, e_row, lobes, nee_pdf_row, texids = unpack_hit_rows(
                scene, hrow, None, hit_layout)
            arow = block_of(hrow, attr)  # the attribute block's grad, as its table's
            t_hit, u, v = reintersect(scene, tri, p, d, row=arow)
            u = torch.where(hit, u, 0.0)
            v = torch.where(hit, v, 0.0)
            sp = shading_parameters(scene, tri, u, v, row=arow)
            # material ids feed only the texture and normal-map lookups
            textured = scene.has_textures or scene.has_normal_maps
            mat = torch.where(hit, mat_raw, 0) if textured else None
            wo_view = -d  # toward the previous vertex
            n_interp = sp["n"]  # before the normal map: the NEE side's cosine
            fp = None if spread is None else _footprint(plen, t_hit, sp, d, spread, aniso_taps)
            sp = apply_normal_map(scene, sp, mat, tid=texids.get("normal_tex"), footprint=fp)
            hp, hn = sp["p"], sp["n"]
            e_hit = emission_from_row(scene, e_row, texids.get("emission_tex"), sp["st"],
                                      footprint=fp)
            lobes = apply_textures(scene, lobes, mat, sp["st"], tex=texids.get("lobe_tex"),
                                   footprint=fp)
        else:
            # no hit rows (above HIT_ROW_MAX_TRIS): the re-intersection
            # and shading from the attribute table, the material through
            # scene.tri_mat, lobes and emission from the material tables;
            # the texture and normal-map ids through the material
            t_hit, u, v = reintersect(scene, tri, p, d, attr=attr)
            u = torch.where(hit, u, 0.0)
            v = torch.where(hit, v, 0.0)
            sp = shading_parameters(scene, tri, u, v, attr=attr)
            wo_view = -d
            mat = torch.where(hit, scene.tri_mat[safe_tri], 0)
            n_interp = sp["n"]
            fp = None if spread is None else _footprint(plen, t_hit, sp, d, spread, aniso_taps)
            sp = apply_normal_map(scene, sp, mat, footprint=fp)
            hp, hn = sp["p"], sp["n"]
            e_hit = emission_at(scene, mat, sp["st"], tables=mat_tables, footprint=fp)
            lobes = apply_textures(scene, gather_lobes(scene, mat, tables=mat_tables), mat,
                                   sp["st"], footprint=fp)

        # 1. emission at first/specular vertices; env on miss
        stage("integrator.emission")
        emit_mask = hit if b == 0 else hit & spec
        radiance = radiance + torch.where(emit_mask[..., None], beta * e_hit, 0.0)
        if mis:
            # the BSDF-sampling side of the MIS pair at the other vertices:
            # pdf_prev against NEE's solid-angle pdf of the same point,
            # tri_light_pdf * d^2 / |cos| (zero off lights), with the
            # interpolated normal's cosine as sample_lights has it
            dist = t_hit.detach()
            cos_h = dot(n_interp, d).abs()
            nee_pdf = nee_pdf_row if hit_f is not None else scene.tri_light_pdf[safe_tri]
            pdf_nee_sa = nee_pdf * dist * dist / maximum(cos_h, 1e-12)
            w_b = (pdf_prev / maximum(pdf_prev + pdf_nee_sa, 1e-20)).detach()
            mis_mask = hit & ~emit_mask
            radiance = radiance + torch.where(
                mis_mask[..., None], beta * e_hit * w_b[..., None], 0.0
            )
        miss_mask = alive & ~hit
        env_e = env_emission_at(scene, d)
        radiance = radiance + torch.where(miss_mask[..., None], beta * env_e, 0.0)

        # first-hit AOVs (only bounce 0 has alive == first)
        first = s["first"]
        fh = first & alive & hit
        aov_normal = torch.where(fh[..., None], hn, s["aov_normal"])
        aov_alpha = torch.where(fh, 1.0, s["aov_alpha"])
        first = first & ~alive
        if spread is not None:
            plen = plen + torch.where(hit, t_hit.detach(), 0.0)

        lobes = apply_fresnel(scene, lobes, hn, wo_view)

        # per-bounce randomness: light pick / light tri / light uv / RR
        # and bsdf lobe / bsdf uv
        u_light = rng.pixel_uniforms4(seed32, pix, sample_idx, b, 1)
        u_bsdf = rng.pixel_uniforms4(seed32, pix, sample_idx, b, 2)

        # 2. next-event estimation
        if nee_enabled:
            stage("integrator.nee")
            ls = sample_lights(
                scene, u_light[:, 0], u_light[:, 1], u_light[:, 2], attr=attr,
                meta=tables["light"], lt_table=tables.get("light_tri"),
                attr_w=attr.shape[1],
            )
            p_off = offset(hp, hn)
            wi_vec = ls["p"] - p_off
            dist = torch.sqrt(maximum(dot(wi_vec, wi_vec), 1e-20))
            wi = wi_vec / dist[..., None]
            dist = dist - RAY_EPSILON

            # a NaN distance gives a NaN wi, so such a lane is never valid
            # and its tmax is 0: a miss for closest and occluded alike
            valid = hit & (dot(hn, wi) > 0.0) & ls["valid"]
            f = bsdf_f(lobes, hn, wi, wo_view)
            if "e" in ls:  # the emission came in the light-triangle row
                light_e = emission_from_row(scene, ls["e"], ls["etex"], ls["st"])
            else:
                light_e = emission_at(scene, ls["mat"], ls["st"], tables=mat_tables)
            cos_l = dot(ls["n"], -wi).abs()
            # division guards at 1e-12, as in the JAX package
            pdf_l = ls["pdf"] * dist * dist / maximum(cos_l, 1e-12)
            if mis:
                # balance weight against BSDF sampling of the same direction
                pdf_b = bsdf_pdf(lobes, hn, wi, wo_view)
                w_nee = (pdf_l / maximum(pdf_l + pdf_b, 1e-20)).detach()
                li = light_e * f * (w_nee / maximum(pdf_l, 1e-12))[..., None]
            else:
                li = (light_e * 4.0) * f / maximum(pdf_l, 1e-12)[..., None]
            if pipe:
                # deferred: the next bounce's trace (or the trailing
                # resolve after the loop) tells whether it is occluded
                pend = {
                    "p": p_off,
                    "d": wi,
                    "tmax": torch.where(valid, dist, 0.0),
                    "contrib": torch.where(valid[..., None], beta * li, 0.0),
                    "valid": valid,
                }
            else:
                # the any-hit trace after the NEE terms, which do not read it
                stage("integrator.shadow")
                with torch.no_grad():
                    occ = occluded(p_off.detach(), wi.detach(),
                                   torch.where(valid, dist, 0.0).detach())
                use = valid & ~occ
                radiance = radiance + torch.where(use[..., None], beta * li, 0.0)

        # 3. Russian roulette + termination (reference terminate_path)
        stage("integrator.bsdf_sample")
        depth_after = b + 1
        alive_next = hit & (depth_after < max_depth)
        q = maximum(1.0 - luminance(beta.detach()), 0.05)
        if depth_after >= 3:
            survive = u_light[:, 3] >= q
            rr_on = alive_next
            alive_next = alive_next & survive
            beta = beta * torch.where(rr_on & survive, 1.0 / (1.0 - q), 1.0)[..., None]

        # 4. BSDF sampling for the next bounce
        f_s, wo, pdf_s, flags = bsdf_sample(lobes, hn, wo_view, u_bsdf[:, 0:2])
        alive_next = alive_next & ~(is_black(f_s) | (pdf_s == 0.0))

        cos_o = dot(hn, wo)
        safe_pdf = torch.where(pdf_s == 0.0, 1.0, pdf_s)
        beta_next = beta * f_s * (cos_o.abs() / safe_pdf)[..., None]
        beta = torch.where(alive_next[..., None], beta_next, beta)

        d_next = normalize(wo)
        p = torch.where(alive_next[..., None], offset(hp, hn, invert=cos_o < 0.0), p)
        d = torch.where(alive_next[..., None], d_next, d)
        spec = alive_next & is_specular_flags(flags)
        if mis:
            # the mixture pdf of the direction just sampled, which the
            # BSDF-hit weight at the next vertex competes with
            pdf_prev = torch.where(alive_next, bsdf_pdf(lobes, hn, d_next, wo_view), 0.0)
        return {"p": p, "d": d, "beta": beta, "radiance": radiance, "alive": alive_next,
                "spec": spec, "first": first, "aov_normal": aov_normal,
                "aov_alpha": aov_alpha, "pdf_prev": pdf_prev, "plen": plen, "pend": pend}

    f32 = dict(dtype=torch.float32, device=dev)
    flag = dict(dtype=torch.bool, device=dev)
    state = {
        "p": p,
        "d": d,
        "beta": torch.ones((n, 3), **f32),
        "radiance": torch.zeros((n, 3), **f32),
        "alive": torch.ones((n,), **flag),
        "spec": torch.zeros((n,), **flag),
        "first": torch.ones((n,), **flag),
        "aov_normal": torch.zeros((n, 3), **f32),
        "aov_alpha": torch.zeros((n,), **f32),
        # the pdf of the direction that led to this vertex (MIS) and the
        # camera-to-vertex path length (ray cone), made only where used
        "pdf_prev": torch.zeros((n,), **f32) if mis else None,
        "plen": None if spread is None else torch.zeros((n,), **f32),
        # the shadow rays a pipelined bounce leaves to the next trace
        "pend": ({"p": torch.zeros((n, 3), **f32), "d": torch.zeros((n, 3), **f32),
                  "tmax": torch.zeros((n,), **f32), "contrib": torch.zeros((n, 3), **f32),
                  "valid": torch.zeros((n,), **flag)} if pipe else None),
    }
    remat = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in (p, d, *(getattr(scene, f) for f in scene.tensor_fields())))
    for b in range(max_depth):
        if remat:
            # the integrator draws nothing from torch's generators (math/rng
            # is counter-based): there is no RNG state to restore
            state = checkpoint(bounce, b, state, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            state = bounce(b, state)

    radiance, pend = state["radiance"], state["pend"]
    if pend is not None:
        # the trailing resolve: the last bounce's shadow rays
        with profiling.span("integrator.shadow"):
            with torch.no_grad():
                occ = occluded(pend["p"].detach(), pend["d"].detach(),
                               pend["tmax"].detach())
            radiance = radiance + torch.where(
                (pend["valid"] & ~occ)[..., None], pend["contrib"], 0.0
            )
    return radiance, state["aov_normal"], state["aov_alpha"]


def render_pass_pixels(scene, cam_params, seed: int, sample_offset: int,
                       n_samples: int, px, py, *, max_depth: int, tracer,
                       film_strata: int = 1, mis: bool = False, spp_batch: int = 1,
                       depth_unroll: int = 1, sample_unroll: int = 1, remat: bool = False,
                       pipeline_shadow: bool = False, aniso_taps: int = 0,
                       trainable: tuple | None = None):
    """Accumulate ``n_samples`` samples for a pixel wavefront px, py (N,).
    Returns dict of per-pixel sums (not yet divided by spp),
    differentiable with respect to the scene's fields (see trace_sample
    for pipeline_shadow, remat and trainable).

    spp_batch: samples traced in one wavefront. sb > 1 tiles the pixels
    sb times, so that every trace runs sb * N rays, each lane with its
    own sample index (sample_offset + s * sb + lane's tile); the same
    sample values as spp_batch=1, the sums differ only by float
    reassociation. Falls back to 1 when it does not divide n_samples.
    depth_unroll, sample_unroll: the JAX scans' unrolls; the loops here
    are eager Python, so they are ignored."""
    del depth_unroll, sample_unroll  # scan unrolls: the eager loops have none
    n = px.shape[0]
    dev = px.device
    sb = max(1, min(spp_batch, n_samples))
    if n_samples % sb != 0:
        sb = 1
    if sb > 1:
        pxb, pyb = px.repeat(sb), py.repeat(sb)
        sub = torch.arange(sb, dtype=torch.int64, device=dev).repeat_interleave(n)
    else:
        pxb, pyb = px, py
    scene = scope_scene(scene, trainable)  # cut non-trainable gradients
    with profiling.span("integrator.tables"):
        tables = make_scene_tables(scene)  # once per pass, shared by samples
    tracer = tracer_for(tracer, scene)
    c = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    a = torch.zeros((n,), dtype=torch.float32, device=dev)
    for s in range(n_samples // sb):
        sidx = sample_offset + s * sb + sub if sb > 1 else sample_offset + s
        with profiling.span("integrator.sample"):
            r, sn, sa = trace_sample(
                scene, cam_params, pxb, pyb, sidx, seed,
                max_depth=max_depth, tracer=tracer, film_strata=film_strata,
                mis=mis, tables=tables, remat=remat, pipeline_shadow=pipeline_shadow,
                aniso_taps=aniso_taps, trainable=trainable,
            )
            if sb > 1:
                r = r.reshape(sb, n, 3).sum(0)
                sn = sn.reshape(sb, n, 3).sum(0)
                sa = sa.reshape(sb, n).sum(0)
            c = c + r
            nrm = nrm + sn
            a = a + sa
    return {"color": c, "normal": nrm, "alpha": a}


def frame_pixels(width: int, height: int, device):
    """Flat (px, py) of a width x height frame, row-major."""
    ids = torch.arange(width * height, dtype=torch.int64, device=device)
    return ids % width, ids // width


def render_pass(scene, cam_params, seed: int, sample_offset: int, n_samples: int,
                *, width: int, height: int, max_depth: int, tracer,
                film_strata: int = 1, mis: bool = False, spp_batch: int = 1,
                depth_unroll: int = 1, sample_unroll: int = 1, remat: bool = False,
                pipeline_shadow: bool = False, aniso_taps: int = 0,
                trainable: tuple | None = None):
    """Accumulate ``n_samples`` samples for the full frame (the keywords:
    render_pass_pixels')."""
    px, py = frame_pixels(width, height, scene.device)
    return render_pass_pixels(
        scene, cam_params, seed, sample_offset, n_samples, px, py,
        max_depth=max_depth, tracer=tracer, film_strata=film_strata, mis=mis,
        spp_batch=spp_batch, remat=remat, pipeline_shadow=pipeline_shadow,
        aniso_taps=aniso_taps, trainable=trainable,
    )


@torch.no_grad()
def render_aovs(scene, camera, *, spp: int | None = None,
                max_depth: int | None = None, options=None, seed=None):
    """Full render returning color + AOVs as (H, W, C) tensors on the
    scene's device. Loops over passes of options.samples_per_pass. A
    forward render: no graph is built."""
    options = options or Options()
    spp = spp if spp is not None else options.samples_per_pixel
    max_depth = max_depth if max_depth is not None else options.path_depth
    seed = options.seed if seed is None else seed

    cam_params = camera_to_params(camera, scene.device)
    w, h = camera.width, camera.height
    tracer = make_tracer(scene, options.use_bvh, options.use_pallas,
                         tracer_tune=options.tracer_tune)
    per_pass = max(1, min(options.samples_per_pass, spp))
    strata = max(1, round(math.sqrt(spp)))

    sums = None
    done = 0
    while done < spp:
        todo = min(per_pass, spp - done)
        out = render_pass(
            scene, cam_params, seed, done, todo, width=w, height=h,
            max_depth=max_depth, tracer=tracer, film_strata=strata,
            mis=options.mis, aniso_taps=options.aniso_taps,
        )
        sums = out if sums is None else {k: sums[k] + out[k] for k in sums}
        done += todo

    inv = 1.0 / spp
    return {
        "color": (sums["color"] * inv).reshape(h, w, 3),
        "normal": (sums["normal"] * inv).reshape(h, w, 3),
        "alpha": (sums["alpha"] * inv).reshape(h, w),
    }


def render(scene, camera, **kwargs):
    """Forward render: (H, W, 3) radiance."""
    return render_aovs(scene, camera, **kwargs)["color"]

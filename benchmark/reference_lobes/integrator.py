"""The reference path integrator over the lobes with sheen: a copy of
``reference/integrator.py``'s ``trace_sample`` and ``film`` that differs
from the original only in where its lobes come from, this package's
``shade`` (the lobe dispatch and container with the sheen lobe) in place of
the original's. The camera, the random numbers, the ray casting and the
strata are the original's, imported unchanged.
"""
from __future__ import annotations

import torch

from reference import rng
from reference.integrator import RAY_EPSILON, T_MAX, _field, _gather, camera_rays  # noqa: F401
from reference.integrator import strata_of  # noqa: F401  (the renderer's strata, for callers)

from .shade import (apply_fresnel, bsdf_f, bsdf_pdf, bsdf_sample, dot, luminance, mt,
                    normalize, sample_lights, surface, vmax)


def trace_sample(tb, cam, tracer, px, py, sample: int, seed: int, *, max_depth: int,
                 mis: bool, strata: int, params=None):
    """One sample of every pixel: (radiance (N, 3), first-hit normal (N, 3),
    first-hit alpha (N,))."""
    n = px.shape[0]
    dev = px.device
    pix = ((py.long() << 16) | px.long()) & rng.MASK
    film_u = rng.uniforms4(seed, pix, sample, 0, 0)[:, 0:2]
    if strata > 1:
        cell = int(sample) % (strata * strata)
        off = torch.tensor([[float(cell % strata), float(cell // strata)]],
                           dtype=torch.float32, device=dev)
        film_u = (off + film_u) / strata
    p, d = camera_rays(cam, px, py, film_u)

    em_tab, em_cast = _field(tb, params, "emission")
    w_tab, w_cast = _field(tb, params, "lobe_weight")
    lt = tb.light_tris
    light_rows = tb.tri[lt]
    light_e = _gather(em_tab, tb.tri_mat[lt], em_cast)

    f32 = dict(dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), **f32)
    rad = torch.zeros((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    spec = torch.zeros((n,), dtype=torch.bool, device=dev)
    first = torch.ones((n,), dtype=torch.bool, device=dev)
    aov_n = torch.zeros((n, 3), **f32)
    aov_a = torch.zeros((n,), **f32)
    pdf_prev = torch.zeros((n,), **f32)
    for b in range(max_depth):
        tmax = torch.where(alive, T_MAX, 1e-6)
        with torch.no_grad():
            tri = tracer.closest(p.detach(), d.detach(), tmax)
        hit = (tri >= 0) & alive
        safe = torch.clamp(tri, min=0)
        row = tb.tri[safe]
        t_hit, u, v = mt(p, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        u = torch.where(hit, u, 0.0)
        v = torch.where(hit, v, 0.0)
        hp, hn = surface(row, u, v)
        mat = torch.where(hit, tb.tri_mat[safe], 0)
        wo_view = -d
        e_hit = _gather(em_tab, mat, em_cast)
        lobes = {"type": tb.lobe_type[mat], "weight": _gather(w_tab, mat, w_cast),
                 "param": tb.lobe_param[mat], "flags": tb.lobe_flags[mat],
                 "n": tb.n_lobes[mat], "types": tb.types}

        emit = hit if b == 0 else hit & spec
        rad = rad + torch.where(emit[..., None], beta * e_hit, 0.0)
        if mis:
            dist = t_hit.detach()
            cos_h = dot(hn, d).abs()
            pdf_sa = tb.tri_light_pdf[safe] * dist * dist / vmax(cos_h, 1e-12)
            w_b = (pdf_prev / vmax(pdf_prev + pdf_sa, 1e-20)).detach()
            rad = rad + torch.where((hit & ~emit)[..., None], beta * e_hit * w_b[..., None], 0.0)
        if tb.env >= 0:
            env_e = _gather(em_tab, torch.tensor(tb.env, device=dev), em_cast).expand(n, 3)
            rad = rad + torch.where((alive & ~hit)[..., None], beta * env_e, 0.0)

        fh = first & alive & hit
        aov_n = torch.where(fh[..., None], hn, aov_n)
        aov_a = torch.where(fh, 1.0, aov_a)
        first = first & ~alive

        if tb.fresnel:
            lobes = apply_fresnel(lobes, hn, wo_view)
        u_light = rng.uniforms4(seed, pix, sample, b, 1)
        u_bsdf = rng.uniforms4(seed, pix, sample, b, 2)

        if tb.num_lights > 0:
            ls = sample_lights(tb, light_rows, light_e, u_light[:, 0], u_light[:, 1],
                               u_light[:, 2])
            p_off = hp + hn * RAY_EPSILON
            wi_vec = ls["p"] - p_off
            dist = torch.sqrt(vmax(dot(wi_vec, wi_vec), 1e-20))
            wi = wi_vec / dist[..., None]
            dist = dist - RAY_EPSILON
            valid = hit & (dot(hn, wi) > 0.0) & ls["valid"]
            with torch.no_grad():
                occ = tracer.occluded(p_off.detach(), wi.detach(),
                                      torch.where(valid, dist, 0.0).detach())
            f = bsdf_f(lobes, hn, wi, wo_view)
            cos_l = dot(ls["n"], -wi).abs()
            pdf_l = ls["pdf"] * dist * dist / vmax(cos_l, 1e-12)
            if mis:
                pdf_b = bsdf_pdf(lobes, hn, wi, wo_view)
                w_nee = (pdf_l / vmax(pdf_l + pdf_b, 1e-20)).detach()
                li = ls["e"] * f * (w_nee / vmax(pdf_l, 1e-12))[..., None]
            else:
                li = (ls["e"] * 4.0) * f / vmax(pdf_l, 1e-12)[..., None]
            rad = rad + torch.where((valid & ~occ)[..., None], beta * li, 0.0)

        alive_next = hit & (b + 1 < max_depth)
        q = vmax(1.0 - luminance(beta.detach()), 0.05)
        if b + 1 >= 3:
            survive = u_light[:, 3] >= q
            rr_on = alive_next
            alive_next = alive_next & survive
            beta = beta * torch.where(rr_on & survive, 1.0 / (1.0 - q), 1.0)[..., None]

        f_s, wo, pdf_s, flags = bsdf_sample(lobes, hn, wo_view, u_bsdf[:, 0:2])
        alive_next = alive_next & ~((f_s <= 0.0).all(dim=-1) | (pdf_s == 0.0))
        cos_o = dot(hn, wo)
        safe_pdf = torch.where(pdf_s == 0.0, 1.0, pdf_s)
        beta = torch.where(alive_next[..., None], beta * f_s * (cos_o.abs() / safe_pdf)[..., None],
                           beta)
        d_next = normalize(wo)
        sign = torch.where(cos_o < 0.0, -RAY_EPSILON, RAY_EPSILON)
        p = torch.where(alive_next[..., None], hp + hn * sign[..., None], p)
        d = torch.where(alive_next[..., None], d_next, d)
        spec = alive_next & ((flags & 4) == 4)
        if mis:
            pdf_prev = torch.where(alive_next, bsdf_pdf(lobes, hn, d_next, wo_view), 0.0)
        alive = alive_next
    return rad, aov_n, aov_a


def film(tb, cam, tracer, px, py, seed: int, spp: int, per_pass: int, *, max_depth: int,
         mis: bool, strata: int):
    """The film of ``spp`` samples at pixels (px, py), accumulated as the
    renderer's passes are, each pass's sums added to the running sums and
    the total times 1 / spp: color (N, 3), normal (N, 3), alpha (N,)."""
    total = None
    done = 0
    while done < spp:
        todo = min(per_pass, spp - done)
        sums = [0.0, 0.0, 0.0]
        for s in range(done, done + todo):
            out = trace_sample(tb, cam, tracer, px, py, s, seed, max_depth=max_depth, mis=mis,
                               strata=strata)
            sums = [a + o for a, o in zip(sums, out)]
        total = sums if total is None else [a + o for a, o in zip(total, sums)]
        done += todo
    scale = 1.0 / spp
    return [x * scale for x in total]

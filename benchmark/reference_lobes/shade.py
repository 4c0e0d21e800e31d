"""The reference's lobes with the sheen lobe: a copy of the lobe dispatch and
the lobe container of ``reference/shade.py``, which differs from the
original only in the sheen lobe (type 7) that ``eval_lobe`` and
``sample_lobe`` now know. Everything a sheen lobe does not touch (frames,
GGX, Fresnel, Oren-Nayar, light sampling, the re-intersection, the
surface) is imported from the original unchanged.

The sheen lobe is the microfacet sheen of Estevez and Kulla ("Production
Friendly Microfacet Sheen BRDF", SIGGRAPH 2017 talk), as the reference
renderer writes it (its ``microfacet::sheen`` in the Cook-Torrance frame):

* D = (2 + 1/r) sin^(1/r)(theta_h) / (2 pi), the paper's distribution;
* Lambda(mu) = exp(L(mu)) for mu < 0.5, else exp(2 L(0.5) - L(1 - mu)),
  with L(x) = a / (1 + b x^c) + d x + e and (a, b, c, d, e) the paper's
  five-coefficient fit, interpolated between its r = 0 and r = 1 rows by
  t = (1 - r)^2;
* G = 1 / (1 + Lambda(wi) + Lambda(wo)), the paper's height-correlated
  form;
* f = D G F / (4 |cos theta_i| |cos theta_o|), sampled cosine-weighted.

Departures from the paper, each the reference renderer's:

* a Fresnel factor F, the Cook-Torrance frame's dielectric term at
  eta 0.5, where the paper's sheen has none;
* no terminator softening of Lambda (the paper's optional
  Lambda^(1 + 2 (1 - mu)^8));
* the evaluated pdf is n.wi / pi, the cosine of the wi argument, as for
  the other cosine lobes here;
* r is clamped to [5e-3, 1] and L to at most 60 before the exponential,
  so that the fit stays finite where a lane's roughness leaves the
  paper's domain.
"""
from __future__ import annotations

import math

import torch

from reference.scene import DIFFUSE, MICROFACET, OREN_NAYAR, REFLECTION, REFRACTION
from reference.shade import (INV_PI, apply_fresnel, ct_f, ct_pdf, dot, fresnel,  # noqa: F401
                             frame, ggx_sample_wh, hemi_match, luminance, mt, normalize,
                             oren_nayar, remap, safe_div, safe_sqrt, same_hemi_local,
                             sample_lights, sin_theta, surface, to_local, to_world, vmax,
                             vmin)

from .scene import SHEEN

# L's coefficients (a, b, c, d, e) at r = 0 and at r = 1 (Estevez and Kulla, table 1)
SHEEN_R0 = (25.3245, 3.32435, 0.16801, -1.27393, -4.85967)
SHEEN_R1 = (21.5473, 3.82987, 0.19823, -1.97760, -4.32054)


def safe_pow(x, e):
    """x ** e where x > 0, else 0."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), e), 0.0)


def sheen_L(x, r):
    t = (1.0 - r) * (1.0 - r)
    a, b, c, d, e = (t * p0 + (1.0 - t) * p1 for p0, p1 in zip(SHEEN_R0, SHEEN_R1))
    return a / (1.0 + b * safe_pow(x, c)) + d * x + e


def sheen_D(r, v):
    oor = safe_div(1.0, r)
    return (2.0 + oor) * safe_pow(sin_theta(v), oor) / (2.0 * math.pi)


def sheen_lambda(r, v):
    half = sheen_L(torch.full_like(r, 0.5), r)
    ct = v[..., 1]
    lg = torch.where(ct < 0.5, sheen_L(ct, r), 2.0 * half - sheen_L(1.0 - ct, r))
    return torch.exp(vmin(lg, 60.0))


def sheen_f(r, fr, wi, wo):
    r = vmin(vmax(r, 5e-3), 1.0)
    li, lo = to_local(fr, wi), to_local(fr, wo)
    whs = li + lo
    wh = normalize(whs)
    cti, cto = li[..., 1].abs(), lo[..., 1].abs()
    whf = torch.where(wh[..., 1:2] < 0.0, -wh, wh)
    F = fresnel(dot(lo, whf), 0.5)
    G = 1.0 / (1.0 + sheen_lambda(r, li) + sheen_lambda(r, lo))
    c = sheen_D(r, wh) * G * F * safe_div(1.0, 4.0 * cti * cto)
    c = torch.where(same_hemi_local(li, lo) & (cti != 0.0) & (cto != 0.0), c, 0.0)
    degen = (whs[..., 0] == 0.0) | (whs[..., 1] == 0.0) | (whs[..., 2] == 0.0)
    return torch.where(degen, 0.0, c)


# --- one lobe slot over a wavefront (the original's, with SHEEN) -------------

def eval_lobe(types, ltype, prm, n, wi, wo):
    """(f, pdf) of lobe slots of type ``ltype`` (N,) at (wi, wo); specular 0."""
    fr = frame(n)
    n_wi = dot(n, wi)
    zero = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    f, pdf = zero, zero
    cos_pdf = n_wi * INV_PI
    for t in types:
        sel = ltype == t
        if t == DIFFUSE:
            r = (torch.full_like(n_wi, INV_PI), cos_pdf)
        elif t == OREN_NAYAR:
            r = (oren_nayar(prm[..., 1], prm[..., 2], fr, wi, wo), cos_pdf)
        elif t == MICROFACET:
            r = (ct_f(prm[..., 0], prm[..., 1], fr, wi, wo),
                 ct_pdf(prm[..., 0], prm[..., 1], fr, wi, wo))
        elif t == SHEEN:
            r = (sheen_f(prm[..., 0], fr, wi, wo), cos_pdf)
        else:
            continue
        f, pdf = torch.where(sel, r[0], f), torch.where(sel, r[1], pdf)
    return f, pdf


def sample_lobe(types, ltype, prm, n, wi, u2):
    """(f, wo, pdf) of one selected lobe per lane."""
    fr = frame(n)
    n_wi = dot(n, wi)
    ones = torch.ones_like(n_wi)
    f = torch.zeros_like(n_wi)
    wo = torch.zeros_like(wi)
    pdf = torch.zeros_like(n_wi)
    for t in types:
        sel = ltype == t
        if t in (DIFFUSE, OREN_NAYAR, SHEEN):
            u1, uu2 = u2[..., 0], u2[..., 1]
            r = torch.sqrt(u1)
            th = 2.0 * math.pi * uu2
            cd = torch.stack([r * torch.cos(th), torch.sqrt(vmax(1.0 - u1, 0.0)),
                              r * torch.sin(th)], dim=-1)
            w_t = to_world(fr, cd)
            p_t = cd[..., 1] * (1.0 / math.pi)
            if t == DIFFUSE:
                f_t = torch.full_like(p_t, INV_PI)
            elif t == OREN_NAYAR:
                f_t = oren_nayar(prm[..., 1], prm[..., 2], fr, wi, w_t)
            else:
                f_t = sheen_f(prm[..., 0], fr, wi, w_t)
        elif t == REFLECTION:
            f_t, w_t, p_t = ones, -wi + (2.0 * n_wi)[..., None] * n, ones
        elif t == REFRACTION:
            eta0 = prm[..., 0]
            sin_t = vmax(1.0 - n_wi * n_wi, 0.0)
            ent = n_wi > 0.0
            nn = torch.where(ent[..., None], n, -n)
            eta_r = torch.where(ent, safe_div(1.0, eta0, eps=0.0), eta0)
            arg = 1.0 - eta_r * eta_r * sin_t
            nk = eta_r * n_wi.abs() - safe_sqrt(arg)
            w_t = -wi * eta_r[..., None] + nn * nk[..., None]
            f_t, p_t = torch.where(arg >= 0.0, 1.0, 0.0), ones
        elif t == MICROFACET:
            ax, ay = prm[..., 0], prm[..., 1]
            li = to_local(fr, wi)
            wh, dpdf = ggx_sample_wh(ax, ay, li, u2)
            lw = dot(li, wh)
            lo = -li + (2.0 * lw)[..., None] * wh
            w_t = to_world(fr, lo)
            ok = (li[..., 1] != 0.0) & (lw >= 0.0) & same_hemi_local(li, lo)
            f_t = torch.where(ok, ct_f(ax, ay, fr, wi, w_t), 0.0)
            p_t = torch.where(ok, dpdf * safe_div(1.0, 4.0 * lw), 0.0)
        else:
            raise ValueError(f"lobe type {t} is not among the reference's")
        f = torch.where(sel, f_t, f)
        wo = torch.where(sel[..., None], w_t, wo)
        pdf = torch.where(sel, p_t, pdf)
    return f, wo, pdf


# --- the lobe container (the original's, over this module's lobes) -----------

def eval_slots(lb, n, wi, wo):
    num, L = wi.shape[0], lb["type"].shape[1]

    def tile(x):
        return x[:, None, :].expand(num, L, 3).reshape(num * L, 3)

    f, pdf = eval_lobe(lb["types"], lb["type"].reshape(-1), lb["param"].reshape(num * L, -1),
                       tile(n), tile(wi), tile(wo))
    return f.reshape(num, L), pdf.reshape(num, L)


def slots(lb, n):
    L = lb["type"].shape[1]
    return torch.arange(L, device=n.device)[None, :] < lb["n"][:, None]


def bsdf_f(lb, n, wi, wo):
    match = hemi_match(lb["flags"], n, wi, wo)
    e, _ = eval_slots(lb, n, wi, wo)
    c = e[..., None] * lb["weight"] * dot(n, wi)[..., None, None]
    return torch.where((slots(lb, n) & match)[..., None], c, 0.0).sum(dim=1)


def bsdf_pdf(lb, n, wi, wo):
    match = hemi_match(lb["flags"], n, wi, wo)
    _, pdf = eval_slots(lb, n, wi, wo)
    total = torch.where(slots(lb, n) & match, pdf, 0.0).sum(dim=1)
    return total / torch.clamp(lb["n"], min=1).to(total.dtype)


def bsdf_sample(lb, n, wi, u2):
    """(f (N, 3), wo, pdf, flags) of the one-sample lobe mixture."""
    idx, u_rem = remap(u2[..., 0], torch.clamp(lb["n"], min=1))
    L = lb["type"].shape[1]
    onehot = idx[:, None] == torch.arange(L, device=idx.device)[None, :]

    def pick(arr):
        m = onehot.reshape(onehot.shape + (1,) * (arr.ndim - 2))
        return torch.where(m, arr, 0).sum(dim=1)

    t_sel, w_sel, p_sel, fl_sel = (pick(lb[k]) for k in ("type", "weight", "param", "flags"))
    f_s, wo, pdf = sample_lobe(lb["types"], t_sel, p_sel, n, wi,
                               torch.stack([u_rem, u2[..., 1]], dim=-1))
    ok = pdf != 0.0
    res = f_s[..., None] * w_sel
    if L > 1:
        s = torch.arange(L, device=n.device)[None, :]
        fa = lb["flags"]
        use = ((s != idx[:, None]) & (s < lb["n"][:, None]) & ((fl_sel[:, None] & fa) == fa)
               & hemi_match(fa, n, wi, wo))
        e_all, pdf_all = eval_slots(lb, n, wi, wo)
        res = res + torch.where(use[..., None], e_all[..., None] * lb["weight"], 0.0).sum(dim=1)
        pdf = pdf + torch.where(use, pdf_all, 0.0).sum(dim=1)
        pdf = pdf / (1 + use.sum(dim=1)).to(pdf.dtype)
    return torch.where(ok[..., None], res, 0.0), wo, torch.where(ok, pdf, 0.0), fl_sel

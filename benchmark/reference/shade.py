"""BSDF lobes, their one-sample mixture, and light sampling for the reference.

The lobe arithmetic of the reference renderer's BSDFs (y-up tangent space;
Lambert, Oren-Nayar, mirror, smooth refraction, GGX reflection with
visible-normal sampling), with the conventions the program keeps: pdfs of
the cosine lobes of n.wi / pi, the Cook-Torrance Fresnel term at eta 0.5,
GGX Lambda at alpha = sqrt(ax * ay), a lobe picked uniformly and the other
flag-compatible lobes folded into its value and pdf. Every function is over
(N, ...) tensors of one wavefront; each lobe type is evaluated on every lane
and the lane's own type selected.
"""
from __future__ import annotations

import math

import torch

from .scene import (DIFFUSE, F_REFLECT, F_TRANSMIT, MICROFACET, OREN_NAYAR, REFLECTION,
                   REFRACTION)

INV_PI = 1.0 / math.pi
ONE_MINUS_EPS = 1.0 - 2.0 ** -23


def const(x, c):
    return torch.tensor(float(c), dtype=torch.float32, device=x.device)


def vmax(x, c):
    return torch.maximum(x, const(x, c))


def vmin(x, c):
    return torch.minimum(x, const(x, c))


def dot(a, b):
    return (a * b).sum(dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(vmax((a * a).sum(dim=-1, keepdim=True), eps))


def safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_div(a, b, eps=0.0):
    zero = b == 0.0
    return torch.where(zero, eps, a / torch.where(zero, 1.0, b))


def luminance(c):
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def remap(u, count):
    """(index, remapped uniform) of one uniform over ``count`` choices."""
    if isinstance(count, torch.Tensor):
        cf = count.to(u.dtype)
    else:
        cf = torch.tensor(float(count), dtype=u.dtype, device=u.device)
    idx = torch.minimum(torch.floor(u * cf), cf - 1.0)
    return idx.to(torch.int64), vmin(u * cf - idx, ONE_MINUS_EPS)


# --- frames ----------------------------------------------------------------

def frame(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    deg = (nx == ny) & (nx == nz)
    ax = nz - ny
    ay = torch.where(deg, nx + nz, nx - nz)
    az = torch.where(deg, -ny - nx, ny - nx)
    a = normalize(torch.stack([ax, ay, az], dim=-1))
    return a, n, normalize(cross(a, n))


def to_world(fr, v):
    a, b, c = fr
    return v[..., 0:1] * a + v[..., 1:2] * b + v[..., 2:3] * c


def to_local(fr, v):
    a, b, c = fr
    return torch.stack([dot(v, a), dot(v, b), dot(v, c)], dim=-1)


def sin_theta(v):
    return safe_sqrt(1.0 - v[..., 1] * v[..., 1])


def cos_phi(v):
    s = sin_theta(v)
    z = s == 0.0
    return torch.where(z, 1.0, vmin(vmax(v[..., 0] / torch.where(z, 1.0, s), -1.0), 1.0))


def sin_phi(v):
    s = sin_theta(v)
    z = s == 0.0
    return torch.where(z, 0.0, vmin(vmax(v[..., 2] / torch.where(z, 1.0, s), -1.0), 1.0))


def same_hemi_local(a, b):
    return (a[..., 1] * b[..., 1]) > 0.0


def fresnel(cosi, eta):
    eta = torch.as_tensor(eta, dtype=cosi.dtype, device=cosi.device)
    eta_eff = torch.where(cosi < 0.0, 1.0 / torch.where(eta == 0.0, 1.0, eta), eta)
    c = cosi.abs()
    g2 = eta_eff * eta_eff - 1.0 + c * c
    g = safe_sqrt(g2)
    A = (g - c) / torch.where(g + c == 0.0, 1.0, g + c)
    db = c * (g - c) + 1.0
    B = (c * (g + c) - 1.0) / torch.where(db == 0.0, 1.0, db)
    f = torch.where(g2 > 0.0, 0.5 * A * A * (1.0 + B * B), 1.0)
    return torch.where(eta == 0.0, 1.0, f)


# --- GGX -------------------------------------------------------------------

def ggx_D(ax, ay, v):
    cos2 = v[..., 1] * v[..., 1]
    tan2 = safe_div(vmax(1.0 - cos2, 0.0), cos2)
    cp, sp = cos_phi(v), sin_phi(v)
    e = (safe_div(cp * cp, ax * ax) + safe_div(sp * sp, ay * ay)) * tan2
    d = safe_div(1.0, math.pi * ax * ay * (cos2 * cos2) * (1.0 + e) * (1.0 + e))
    return torch.where(cos2 == 0.0, 0.0, d)


def ggx_lambda(ax, ay, v):
    cos2 = v[..., 1] * v[..., 1]
    abs_tan = safe_sqrt(safe_div(vmax(1.0 - cos2, 0.0), cos2))
    a2t2 = (safe_sqrt(ax * ay) * abs_tan) ** 2
    return torch.where(cos2 == 0.0, 0.0, (-1.0 + torch.sqrt(1.0 + a2t2)) * 0.5)


def ggx_G1(ax, ay, v):
    return 1.0 / (1.0 + ggx_lambda(ax, ay, v))


def ggx_slope(cos_t, u, v):
    r_ni = torch.sqrt(safe_div(u, 1.0 - u))
    phi_ni = 6.28318530718 * v
    sx_ni, sy_ni = r_ni * torch.cos(phi_ni), r_ni * torch.sin(phi_ni)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    tan_t = sin_t / torch.where(cos_t == 0.0, 1.0, cos_t)
    safe_tan = torch.where(tan_t == 0.0, 1.0, tan_t)
    a = 1.0 / safe_tan
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a * a)))
    A = 2.0 * u / g1 - 1.0
    tmp = vmin(safe_div(1.0, A * A - 1.0), 1e10)
    B = tan_t
    D = safe_sqrt(B * B * tmp * tmp - (A * A - B * B) * tmp)
    x1, x2 = B * tmp - D, B * tmp + D
    sx = torch.where((A < 0.0) | (x2 > 1.0 / safe_tan), x1, x2)
    S = torch.where(v > 0.5, 1.0, -1.0)
    v2 = torch.where(v > 0.5, 2.0 * (v - 0.5), 2.0 * (0.5 - v))
    z = (v2 * (v2 * (v2 * 0.27385 - 0.73369) + 0.46341)) / (
        v2 * (v2 * (v2 * 0.093073 + 0.309420) - 1.0) + 0.597999)
    sy = S * z * torch.sqrt(1.0 + sx * sx)
    ni = cos_t > 0.9999
    return torch.where(ni, sx_ni, sx), torch.where(ni, sy_ni, sy)


def ggx_sample_wh(ax, ay, li, u2):
    st = normalize(torch.stack([ax * li[..., 0], li[..., 1], ay * li[..., 2]], dim=-1))
    sx, sy = ggx_slope(st[..., 1], u2[..., 0], u2[..., 1])
    cp, sp = cos_phi(st), sin_phi(st)
    rx = (cp * sx - sp * sy) * ax
    ry = (sp * sx + cp * sy) * ay
    wh = normalize(torch.stack([-rx, torch.ones_like(rx), -ry], dim=-1))
    pdf = ggx_D(ax, ay, wh) * ggx_G1(ax, ay, li) * dot(li, wh).abs() / vmax(li[..., 1].abs(),
                                                                               1e-12)
    return wh, pdf


def ct_f(ax, ay, fr, wi, wo):
    li, lo = to_local(fr, wi), to_local(fr, wo)
    whs = li + lo
    wh = normalize(whs)
    cti, cto = li[..., 1].abs(), lo[..., 1].abs()
    whf = torch.where(wh[..., 1:2] < 0.0, -wh, wh)
    F = fresnel(dot(lo, whf), 0.5)
    G = 1.0 / (1.0 + ggx_lambda(ax, ay, li) + ggx_lambda(ax, ay, lo))
    c = ggx_D(ax, ay, wh) * G * F * safe_div(1.0, 4.0 * cti * cto)
    c = torch.where(same_hemi_local(li, lo) & (cti != 0.0) & (cto != 0.0), c, 0.0)
    degen = (whs[..., 0] == 0.0) | (whs[..., 1] == 0.0) | (whs[..., 2] == 0.0)
    return torch.where(degen, 0.0, c)


def ct_pdf(ax, ay, fr, wi, wo):
    li, lo = to_local(fr, wi), to_local(fr, wo)
    wh = normalize(li + lo)
    lw = dot(li, wh)
    pdf = (ggx_D(ax, ay, wh) * ggx_G1(ax, ay, li) * lw.abs()
           * safe_div(1.0, li[..., 1].abs()) * safe_div(1.0, 4.0 * lw))
    return torch.where(same_hemi_local(li, lo), pdf, 0.0)


def oren_nayar(a, b, fr, wi, wo):
    li, lo = to_local(fr, wi), to_local(fr, wo)
    cti, cto = li[..., 1].abs(), lo[..., 1].abs()
    sti, sto = sin_theta(li), sin_theta(lo)
    dcos = cos_phi(li) * cos_phi(lo) + sin_phi(li) * sin_phi(lo)
    max_cos = torch.where((sti > 1e-4) & (sto > 1e-4), vmax(dcos, 0.0), 0.0)
    gt = cti > cto
    sin_a = torch.where(gt, sto, sti)
    tan_b = torch.where(gt, safe_div(sti, cti), safe_div(sto, cto))
    return (a + b * max_cos * sin_a * tan_b) * INV_PI


# --- one lobe slot over a wavefront ----------------------------------------

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
        if t in (DIFFUSE, OREN_NAYAR):
            u1, uu2 = u2[..., 0], u2[..., 1]
            r = torch.sqrt(u1)
            th = 2.0 * math.pi * uu2
            cd = torch.stack([r * torch.cos(th), torch.sqrt(vmax(1.0 - u1, 0.0)),
                              r * torch.sin(th)], dim=-1)
            w_t = to_world(fr, cd)
            p_t = cd[..., 1] * (1.0 / math.pi)
            f_t = (torch.full_like(p_t, INV_PI) if t == DIFFUSE
                   else oren_nayar(prm[..., 1], prm[..., 2], fr, wi, w_t))
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


# --- the lobe container ------------------------------------------------------

def hemi_match(flags, n, wi, wo):
    refl = (dot(n, wi) * dot(n, wo) > 0.0)[:, None]
    return torch.where(refl, (flags & F_REFLECT) == F_REFLECT, (flags & F_TRANSMIT) == F_TRANSMIT)


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


def apply_fresnel(lb, n, wi):
    mode, ior = lb["param"][..., 4], lb["param"][..., 5]
    F = fresnel(dot(n, wi)[:, None], torch.where(ior == 0.0, 1.5, ior))
    factor = torch.where(mode == 1.0, F, torch.where(mode == 2.0, 1.0 - F, 1.0))
    return dict(lb, weight=lb["weight"] * factor[..., None])


# --- shading at a hit and light sampling -------------------------------------

def mt(p, d, a, b, c):
    """t, u, v of rays against known triangles (the re-intersection)."""
    e0, e1 = b - a, c - a
    pvec = cross(d, e1)
    det = dot(e0, pvec)
    nz = det.abs() < 1e-8
    ood = 1.0 / torch.where(nz, 1.0, det)
    tvec = p - a
    u = dot(tvec, pvec) * ood
    qvec = cross(tvec, e0)
    return dot(e1, qvec) * ood, u, dot(d, qvec) * ood


def surface(row, u, v):
    """Position and shading normal at barycentrics (u, v) of tri rows."""
    a, b, c = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    n0, n1, n2 = row[..., 9:12], row[..., 12:15], row[..., 15:18]
    w = 1.0 - u - v
    p = w[..., None] * a + u[..., None] * b + v[..., None] * c
    ng = normalize(cross(b - a, c - a))
    ns = normalize(w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2)
    return p, torch.where((row[..., 18] != 0.0)[..., None], ns, ng)


def sample_lights(tb, tri_rows, emission_rows, u_pick, u_tri, u_uv):
    """One light point per lane: p, n, area pdf over the light count, valid,
    and its emission. tri_rows / emission_rows: the light triangles' rows."""
    nl = tb.num_lights
    li, _ = remap(u_pick, nl)
    ltype, loff = tb.light_type[li], tb.light_offset[li]
    lcount_raw, larea = tb.light_count[li], tb.light_area[li]
    tri_sel, u_rem = remap(u_tri, torch.clamp(lcount_raw, min=1))
    x = torch.sqrt(u_rem)
    bu, bv = 1.0 - x, u_uv * x
    k = loff + tri_sel
    row, e = tri_rows[k], emission_rows[k]
    a, b, c = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    _, n_area = surface(row, bu, bv)
    p_area = bu[..., None] * a + bv[..., None] * b + (1.0 - bu - bv)[..., None] * c
    pdf_area = 1.0 / vmax(larea, 1e-12)
    r = torch.sqrt(vmax(1.0 - u_tri * u_tri, 0.0))
    phi = 2.0 * math.pi * u_uv
    hemi = torch.stack([torch.cos(phi) * r, u_tri, torch.sin(phi) * r], dim=-1)
    area = ltype == 1
    return {
        "p": torch.where(area[..., None], p_area, hemi * 1000.0),
        "n": torch.where(area[..., None], n_area, 0.0),
        "pdf": torch.where(area, pdf_area, torch.full_like(u_tri, 1.0 / math.pi)) / nl,
        "valid": area & (lcount_raw > 0),
        "e": torch.where(area[..., None], e, 0.0),
    }

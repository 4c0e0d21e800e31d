"""Per-lobe-type BSDF evaluation and sampling over a wavefront.

Counterpart of ``phosphorus_mk2_tpu/bsdf/lobes.py`` (reference
src/bsdf/{lambert,oren_nayar,reflection,refraction,microfacet,sheen}.hpp)
with the same y-up tangent-space math. Each lobe type's evaluation and
sampling is written once (``EVALS``, ``SAMPLERS``), and one dispatch
runs them (``eval_lobe``, ``sample_lobe``): every present type over the
whole wavefront, the result selected by type code. The JAX package also
has a type-sorted dispatch (the reference's material-bucketed deferred
shading); the port does not keep it: on the card the no-grad forward
takes the ``csrc/bsdf.cu`` kernel (``bsdf/kernel.py``) and the eager
sorted form was never faster there than the dense one.

Direction conventions follow the reference call sites:
  * eval(wi, wo): wi toward the light, wo toward the viewer in NEE; the
    arguments arrive swapped in the sampling path, as in the reference.
  * sample(wi, u): wi toward the previous path vertex; returns wo.

Deviations and quirks are those of the JAX package (see its module
docstring): local-frame G1 in the cook-torrance pdf, the corrected
refract dwh_dwi, n.wi/pi pdfs for the cosine lobes, eta = 0.5 in the
cook-torrance fresnel and GGX Lambda's alpha = sqrt(ax*ay).
"""
from __future__ import annotations

import functools
import math

import torch

from phosphorus_mk2_tpu_torch.core.material import (
    DIFFUSE,
    MICROFACET,
    MICROFACET_REFRACT,
    OREN_NAYAR,
    REFLECTION,
    REFRACTION,
    SHEEN,
    TRANSPARENT,
)
from phosphorus_mk2_tpu_torch.math import frame as tsf
from phosphorus_mk2_tpu_torch.math.fresnel import dielectric
from phosphorus_mk2_tpu_torch.math.sampling import cosine_hemisphere
from phosphorus_mk2_tpu_torch.math.vec import (
    clip,
    dot,
    in_same_hemisphere,
    maximum,
    minimum,
    normalize,
    safe_pow,
    safe_sqrt,
)

INV_PI = 1.0 / math.pi

ALL_TYPES = (
    DIFFUSE,
    OREN_NAYAR,
    REFLECTION,
    REFRACTION,
    MICROFACET,
    MICROFACET_REFRACT,
    SHEEN,
    TRANSPARENT,
)


def _safe_div(a, b, eps=0.0):
    zero = b == 0.0
    return torch.where(zero, eps, a / torch.where(zero, 1.0, b))


# ---------------------------------------------------------------------------
# GGX distribution (reference microfacet::ggx_t, src/bsdf/microfacet.hpp:306+)
# ---------------------------------------------------------------------------

def ggx_D(ax, ay, v):
    """v in the local (y-up) frame."""
    cos2 = tsf.cos2_theta(v)
    sin2 = maximum(1.0 - cos2, 0.0)
    tan2 = _safe_div(sin2, cos2)
    cos4 = cos2 * cos2
    e = (_safe_div(tsf.cos2_phi(v), ax * ax) + _safe_div(tsf.sin2_phi(v), ay * ay)) * tan2
    d = _safe_div(1.0, math.pi * ax * ay * cos4 * (1.0 + e) * (1.0 + e))
    return torch.where(cos2 == 0.0, 0.0, d)  # isinf(tan2) -> 0 (grazing)


def ggx_Lambda(ax, ay, v):
    cos2 = tsf.cos2_theta(v)
    sin2 = maximum(1.0 - cos2, 0.0)
    abs_tan = safe_sqrt(_safe_div(sin2, cos2))
    # reference quirk: alpha = sqrt(cos2_phi*ax*ay + sin2_phi*ax*ay) = sqrt(ax*ay)
    alpha = safe_sqrt(ax * ay)
    a2t2 = (alpha * abs_tan) ** 2
    lam = (-1.0 + torch.sqrt(1.0 + a2t2)) * 0.5
    return torch.where(cos2 == 0.0, 0.0, lam)


def ggx_G(ax, ay, wi, wo):
    return 1.0 / (1.0 + ggx_Lambda(ax, ay, wi) + ggx_Lambda(ax, ay, wo))


def ggx_G1(ax, ay, v):
    return 1.0 / (1.0 + ggx_Lambda(ax, ay, v))


def ggx_sample_slope(cos_theta, u, v):
    """Visible-normal slope sampling (reference src/bsdf/microfacet.hpp:352+)."""
    r_ni = torch.sqrt(_safe_div(u, 1.0 - u))
    phi_ni = 6.28318530718 * v
    slope_x_ni = r_ni * torch.cos(phi_ni)
    slope_y_ni = r_ni * torch.sin(phi_ni)

    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    safe_cos = torch.where(cos_theta == 0.0, 1.0, cos_theta)
    tan_theta = sin_theta / safe_cos
    safe_tan = torch.where(tan_theta == 0.0, 1.0, tan_theta)
    a = 1.0 / safe_tan
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a * a)))

    A = 2.0 * u / g1 - 1.0
    denom = A * A - 1.0
    tmp = _safe_div(1.0, denom)
    tmp = minimum(tmp, 1e10)
    B = tan_theta
    Dterm = safe_sqrt(B * B * tmp * tmp - (A * A - B * B) * tmp)
    slope_x1 = B * tmp - Dterm
    slope_x2 = B * tmp + Dterm
    slope_x = torch.where((A < 0.0) | (slope_x2 > 1.0 / safe_tan), slope_x1, slope_x2)

    S = torch.where(v > 0.5, 1.0, -1.0)
    v2 = torch.where(v > 0.5, 2.0 * (v - 0.5), 2.0 * (0.5 - v))
    z = (v2 * (v2 * (v2 * 0.27385 - 0.73369) + 0.46341)) / (
        v2 * (v2 * (v2 * 0.093073 + 0.309420) - 1.0) + 0.597999
    )
    slope_y = S * z * torch.sqrt(1.0 + slope_x * slope_x)

    ni = cos_theta > 0.9999
    return (
        torch.where(ni, slope_x_ni, slope_x),
        torch.where(ni, slope_y_ni, slope_y),
    )


def ggx_sample_wh(ax, ay, li, u2):
    """Half vector from the visible-normal distribution.
    li: (..., 3) local incident direction; u2: (..., 2).
    Returns (wh local, pdf)."""
    stretched = normalize(
        torch.stack([ax * li[..., 0], li[..., 1], ay * li[..., 2]], dim=-1)
    )
    sx, sy = ggx_sample_slope(tsf.cos_theta(stretched), u2[..., 0], u2[..., 1])
    cp = tsf.cos_phi(stretched)
    sp = tsf.sin_phi(stretched)
    rx = (cp * sx - sp * sy) * ax
    ry = (sp * sx + cp * sy) * ay
    wh = normalize(torch.stack([-rx, torch.ones_like(rx), -ry], dim=-1))
    pdf = (
        ggx_D(ax, ay, wh)
        * ggx_G1(ax, ay, li)
        * dot(li, wh).abs()
        / maximum(tsf.cos_theta(li).abs(), 1e-12)
    )
    return wh, pdf


# ---------------------------------------------------------------------------
# Sheen distribution (reference microfacet::sheen, src/bsdf/sheen.hpp)
# ---------------------------------------------------------------------------

def _sheen_L(x, r):
    p0 = (25.3245, 3.32435, 0.16801, -1.27393, -4.85967)
    p1 = (21.5473, 3.82987, 0.19823, -1.97760, -4.32054)
    t = (1.0 - r) * (1.0 - r)

    def interp(a, b):
        return t * a + (1.0 - t) * b

    a = interp(p0[0], p1[0])
    b = interp(p0[1], p1[1])
    c = interp(p0[2], p1[2])
    d = interp(p0[3], p1[3])
    e = interp(p0[4], p1[4])
    xc = safe_pow(x, c)
    return a / (1.0 + b * xc) + d * x + e


def sheen_D(r, v):
    sin_t = tsf.sin_theta(v)
    oor = _safe_div(1.0, r)
    return (2.0 + oor) * safe_pow(sin_t, oor) / (2.0 * math.pi)


def sheen_Lambda(r, v):
    L5 = _sheen_L(torch.full_like(r, 0.5), r)
    ct = tsf.cos_theta(v)
    l = torch.where(ct < 0.5, _sheen_L(ct, r), 2.0 * L5 - _sheen_L(1.0 - ct, r))
    # clamp the log-space fit before exp: dense dispatch evaluates sheen
    # on every lane, and off-type roughness extrapolates it to inf
    return torch.exp(minimum(l, 60.0))


def sheen_G(r, wi, wo):
    return 1.0 / (1.0 + sheen_Lambda(r, wi) + sheen_Lambda(r, wo))


# ---------------------------------------------------------------------------
# Cook-Torrance shared core (reference cook_torrance::f / refract::f)
# ---------------------------------------------------------------------------

def _ct_f_local(D, G, li, lo, wh):
    """D*G*F / (4 cos_ti cos_to), fresnel eta = 0.5 (reference quirk)."""
    cos_ti = tsf.cos_theta(li).abs()
    cos_to = tsf.cos_theta(lo).abs()
    wh_flipped = torch.where(wh[..., 1:2] < 0.0, -wh, wh)
    F = dielectric(dot(lo, wh_flipped), 0.5)
    c = D * G * F * _safe_div(1.0, 4.0 * cos_ti * cos_to)
    valid = tsf.ts_in_same_hemisphere(li, lo) & (cos_ti != 0.0) & (cos_to != 0.0)
    return torch.where(valid, c, 0.0)


def _half_degenerate(whs):
    return (whs[..., 0] == 0.0) | (whs[..., 1] == 0.0) | (whs[..., 2] == 0.0)


def ct_f(ax, ay, n_frame, wi, wo):
    """GGX cook-torrance reflection eval; wi/wo in world space."""
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    whs = li + lo
    wh = normalize(whs)
    c = _ct_f_local(ggx_D(ax, ay, wh), ggx_G(ax, ay, li, lo), li, lo, wh)
    return torch.where(_half_degenerate(whs), 0.0, c)


def ct_pdf(ax, ay, n_frame, wi, wo):
    """GGX cook-torrance eval-path pdf (G1 in the local frame)."""
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    wh = normalize(li + lo)
    li_wh = dot(li, wh)
    pdf = (
        ggx_D(ax, ay, wh)
        * ggx_G1(ax, ay, li)
        * li_wh.abs()
        * _safe_div(1.0, tsf.cos_theta(li).abs())
        * _safe_div(1.0, 4.0 * li_wh)
    )
    return torch.where(tsf.ts_in_same_hemisphere(li, lo), pdf, 0.0)


def sheen_f(r, n_frame, wi, wo):
    # clamp to sheen's domain (0, 1]: dense dispatch runs sheen on every
    # lane, and off-type "roughness" would drive the fit into inf
    r = clip(r, 5e-3, 1.0)
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    whs = li + lo
    wh = normalize(whs)
    c = _ct_f_local(sheen_D(r, wh), sheen_G(r, li, lo), li, lo, wh)
    return torch.where(_half_degenerate(whs), 0.0, c)


def ct_refract_f(ax, ay, eta_param, n_frame, wi, wo):
    """Refractive GGX eval (reference refract::f, microfacet.hpp:38-93)."""
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    eta = torch.where(li[..., 1] > 0.0, eta_param, _safe_div(1.0, eta_param))

    cos_ti = tsf.cos_theta(li)
    cos_to = tsf.cos_theta(lo)

    wh = normalize(li + lo * eta[..., None])
    wh = torch.where(wh[..., 1:2] < 0.0, -wh, wh)

    lo_wh = dot(lo, wh)
    li_wh = dot(li, wh)

    F = dielectric(lo_wh, eta)
    sqrt_denom = li_wh + eta * lo_wh
    factor = _safe_div(1.0, eta)
    d = ggx_D(ax, ay, wh)
    g = ggx_G(ax, ay, li, lo)

    c = (1.0 - F) * (
        d
        * g
        * eta
        * eta
        * lo_wh.abs()
        * li_wh.abs()
        * factor
        * factor
        * _safe_div(1.0, cos_ti * cos_to * sqrt_denom * sqrt_denom)
    ).abs()
    invalid = (
        tsf.ts_in_same_hemisphere(li, lo)
        | (cos_ti == 0.0)
        | (cos_to == 0.0)
        | (lo_wh * li_wh > 0.0)
    )
    return torch.where(invalid, 0.0, c)


def ct_refract_pdf(ax, ay, eta_param, n_frame, wi, wo):
    """Refractive GGX eval-path pdf (corrected dwh_dwi)."""
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    eta = torch.where(li[..., 1] > 0.0, eta_param, _safe_div(1.0, eta_param))
    wh = normalize(li + lo * eta[..., None])
    sqrt_denom = dot(li, wh) + eta * dot(lo, wh)
    dwh_dwi = (eta * eta * dot(lo, wh)).abs() * _safe_div(1.0, sqrt_denom * sqrt_denom)
    pdf = ggx_D(ax, ay, wh) * tsf.cos_theta(wh) * dwh_dwi
    # world-space same-hemisphere rejection as in the reference
    return torch.where(in_same_hemisphere(wi, wo), 0.0, pdf)


def oren_nayar_f(a, b, n_frame, wi, wo):
    li = tsf.to_local(n_frame, wi)
    lo = tsf.to_local(n_frame, wo)
    cos_ti = tsf.cos_theta(li).abs()
    cos_to = tsf.cos_theta(lo).abs()
    sin_ti = tsf.sin_theta(li)
    sin_to = tsf.sin_theta(lo)

    dcos = tsf.cos_phi(li) * tsf.cos_phi(lo) + tsf.sin_phi(li) * tsf.sin_phi(lo)
    max_cos = torch.where(
        (sin_ti > 1e-4) & (sin_to > 1e-4), maximum(dcos, 0.0), 0.0
    )
    i_gt_o = cos_ti > cos_to
    sin_alpha = torch.where(i_gt_o, sin_to, sin_ti)
    tan_beta = torch.where(
        i_gt_o, _safe_div(sin_ti, cos_ti), _safe_div(sin_to, cos_to)
    )
    return (a + b * max_cos * sin_alpha * tan_beta) * INV_PI


# ---------------------------------------------------------------------------
# Per-type evaluation and sampling (reference eval(), src/bsdf.cpp:29-108;
# bsdf_t::sample, :133-224), each lobe type's arithmetic written once; the
# dense dispatch runs every present type over the whole wavefront.
# ---------------------------------------------------------------------------

class _Lanes:
    """A batch of lobe lanes (params (N, P), shading normals n and wi
    (N, 3); wo (N, 3) to evaluate, u2 (N, 2) to sample) with the work that
    several lobe types share, each part made once, at its first use. The
    dense dispatch hands one _Lanes of the whole wavefront to every
    present type."""

    def __init__(self, params, n, wi, wo=None, u2=None):
        self.params, self.n, self.wi, self.wo, self.u2 = params, n, wi, wo, u2

    @functools.cached_property
    def n_frame(self):
        return tsf.make_frame(self.n)

    @functools.cached_property
    def n_wi(self):
        return dot(self.n, self.wi)

    @functools.cached_property
    def li(self):
        return tsf.to_local(self.n_frame, self.wi)

    @functools.cached_property
    def ones(self):
        return torch.ones_like(self.n_wi)

    @functools.cached_property
    def pdf_cosine_quirk(self):
        return self.n_wi * INV_PI  # reference quirk: cos of the wi arg

    @functools.cached_property
    def cosine(self):
        """The cosine-weighted warp of diffuse, oren-nayar and sheen:
        (wo, pdf)."""
        cos_dir, cos_pdf = cosine_hemisphere(self.u2)
        return tsf.to_world(self.n_frame, cos_dir), cos_pdf

    @functools.cached_property
    def ggx(self):
        """The visible-normal half vector of both GGX lobes: (wh, pdf,
        li.wh)."""
        wh, dpdf = ggx_sample_wh(self.params[..., 0], self.params[..., 1], self.li, self.u2)
        return wh, dpdf, dot(self.li, wh)


def _eval_diffuse(s):
    return torch.full_like(s.n_wi, INV_PI), s.pdf_cosine_quirk


def _eval_oren_nayar(s):
    return (oren_nayar_f(s.params[..., 1], s.params[..., 2], s.n_frame, s.wi, s.wo),
            s.pdf_cosine_quirk)


def _eval_microfacet(s):
    ax, ay = s.params[..., 0], s.params[..., 1]
    return ct_f(ax, ay, s.n_frame, s.wi, s.wo), ct_pdf(ax, ay, s.n_frame, s.wi, s.wo)


def _eval_microfacet_refract(s):
    ax, ay, eta = s.params[..., 0], s.params[..., 1], s.params[..., 2]
    return (ct_refract_f(ax, ay, eta, s.n_frame, s.wi, s.wo),
            ct_refract_pdf(ax, ay, eta, s.n_frame, s.wi, s.wo))


def _eval_sheen(s):
    return sheen_f(s.params[..., 0], s.n_frame, s.wi, s.wo), s.pdf_cosine_quirk


# REFLECTION / REFRACTION / TRANSPARENT evaluate to 0 (specular)
EVALS = {
    DIFFUSE: _eval_diffuse,
    OREN_NAYAR: _eval_oren_nayar,
    MICROFACET: _eval_microfacet,
    MICROFACET_REFRACT: _eval_microfacet_refract,
    SHEEN: _eval_sheen,
}


def _sample_diffuse(s):
    wo, pdf = s.cosine
    return torch.full_like(pdf, INV_PI), wo, pdf


def _sample_oren_nayar(s):
    wo, pdf = s.cosine
    return oren_nayar_f(s.params[..., 1], s.params[..., 2], s.n_frame, s.wi, wo), wo, pdf


def _sample_sheen(s):
    wo, pdf = s.cosine
    return sheen_f(s.params[..., 0], s.n_frame, s.wi, wo), wo, pdf


def _sample_reflection(s):
    # mirror reflection (reference reflection::sample)
    return s.ones, -s.wi + (2.0 * s.n_wi)[..., None] * s.n, s.ones


def _sample_refraction(s):
    # pure refraction (reference refraction::sample)
    eta0 = s.params[..., 0]
    cos_t = s.n_wi
    sin_t = maximum(1.0 - cos_t * cos_t, 0.0)
    entering = cos_t > 0.0
    nn = torch.where(entering[..., None], s.n, -s.n)
    eta_r = torch.where(entering, _safe_div(1.0, eta0, eps=0.0), eta0)
    arg = 1.0 - eta_r * eta_r * sin_t
    nk = eta_r * cos_t.abs() - safe_sqrt(arg)
    wo = -s.wi * eta_r[..., None] + nn * nk[..., None]
    return torch.where(arg >= 0.0, 1.0, 0.0), wo, s.ones


def _sample_microfacet(s):
    # GGX reflect (reference cook_torrance::sample)
    ax, ay = s.params[..., 0], s.params[..., 1]
    wh, dpdf, li_wh = s.ggx
    li = s.li
    lo = -li + (2.0 * li_wh)[..., None] * wh
    wo = tsf.to_world(s.n_frame, lo)
    pdf = dpdf * _safe_div(1.0, 4.0 * li_wh)
    f = ct_f(ax, ay, s.n_frame, s.wi, wo)
    ok = (li[..., 1] != 0.0) & (li_wh >= 0.0) & tsf.ts_in_same_hemisphere(li, lo)
    return torch.where(ok, f, 0.0), wo, torch.where(ok, pdf, 0.0)


def _sample_microfacet_refract(s):
    # GGX refract (reference cook_torrance::refract::sample)
    ax, ay, eta_p = s.params[..., 0], s.params[..., 1], s.params[..., 2]
    wh, dpdf, li_wh = s.ggx
    li = s.li
    eta_t = torch.where(li[..., 1] > 0.0, _safe_div(1.0, eta_p), eta_p)
    cos_ti = li_wh
    sin2_ti = maximum(1.0 - cos_ti * cos_ti, 0.0)
    sin2_tt = eta_t * eta_t * sin2_ti
    cos_tt = safe_sqrt(1.0 - sin2_tt)
    lo = -li * eta_t[..., None] + (eta_t * cos_ti - cos_tt)[..., None] * wh
    sqrt_denom = dot(li, wh) + eta_t * dot(lo, wh)
    dwh_dwi = (
        (eta_t * eta_t * dot(lo, wh)) * _safe_div(1.0, sqrt_denom * sqrt_denom)
    ).abs()
    wo = tsf.to_world(s.n_frame, lo)
    pdf = dpdf * dwh_dwi
    f = ct_refract_f(ax, ay, eta_p, s.n_frame, s.wi, wo)
    ok = (li[..., 1] != 0.0) & (li_wh >= 0.0) & (sin2_tt < 1.0)
    # eta == 1 passthrough branch (reference refract::sample:127-135)
    passthrough = eta_p == 1.0
    f = torch.where(passthrough, 1.0, torch.where(ok, f, 0.0))
    pdf = torch.where(passthrough, 1.0, torch.where(ok, pdf, 0.0))
    wo = torch.where(passthrough[..., None], -s.wi, wo)
    return f, wo, pdf


def _sample_transparent(s):
    # transparent passthrough (reference bsdf.cpp:205-214)
    return s.ones, -s.wi, s.ones


SAMPLERS = {
    DIFFUSE: _sample_diffuse,
    OREN_NAYAR: _sample_oren_nayar,
    SHEEN: _sample_sheen,
    REFLECTION: _sample_reflection,
    REFRACTION: _sample_refraction,
    MICROFACET: _sample_microfacet,
    MICROFACET_REFRACT: _sample_microfacet_refract,
    TRANSPARENT: _sample_transparent,
}


def _dense_dispatch(fns, present, lobe_type, s, outs):
    """Run fns[T] on every lane of ``s`` for each present type T and keep
    each lane's own type's result; lanes of other types keep ``outs``
    (zeros)."""
    present = set(present) if present else set(ALL_TYPES)
    for t, fn in fns.items():
        if t in present:
            sel = lobe_type == t
            outs = [torch.where(sel.reshape(sel.shape + (1,) * (o.dim() - 1)), r, o)
                    for r, o in zip(fn(s), outs)]
    return tuple(outs)


def eval_lobe(lobe_type, params, n, wi, wo, present=None):
    """Evaluate one lobe slot for every hit; dense type dispatch.

    lobe_type: (N,) int; params: (N, P); n: (N, 3) shading normal;
    wi/wo: (N, 3). present: lobe types the scene uses (absent types are
    skipped). Returns (f (N,), pdf (N,)); REFLECTION, REFRACTION and
    TRANSPARENT evaluate to 0 (specular).
    """
    zero = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    return _dense_dispatch(EVALS, present, lobe_type, _Lanes(params, n, wi, wo=wo),
                           (zero, zero))


def sample_lobe(lobe_type, params, n, wi, u2, present=None):
    """Sample one (already selected) lobe for every hit; dense type
    dispatch. Returns (f (N,), wo (N,3), pdf (N,))."""
    zero = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    return _dense_dispatch(SAMPLERS, present, lobe_type, _Lanes(params, n, wi, u2=u2),
                           (zero, torch.zeros_like(wi), zero))


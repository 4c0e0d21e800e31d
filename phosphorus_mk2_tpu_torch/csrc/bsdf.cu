// The BSDF lobe container's three calls (bsdf/bsdf.py bsdf_f, bsdf_pdf,
// bsdf_sample) for Hopper (sm_90a), each one launch, one thread a hit.
//
// No TPU kernel corresponds to it. The JAX package leaves the lobe
// arithmetic to XLA, which fuses it into the step. The port's eager code
// (bsdf/lobes.py) runs each lobe type's arithmetic as hundreds of
// elementwise launches a call. A no-grad render of a six-type scene at
// depth 9 spent most of its host time there, with the card idle. This
// kernel replaces all of it on the no-grad forward; the CPU, and calls
// whose directions or lobe parameters autograd records, keep the eager code.
//
// What bounds it on an H100: neither bytes nor operations. A call reads
// some 100-200 bytes a hit (the lobe slots, the normal, two directions)
// and does a few hundred float operations a slot; at 131,072 hits that is
// ~20 MB, ~6 us at 3.35 TB/s. Its cost is one launch.
//
// Under autograd, a call whose only input that requires grad is the lobe
// weight (bsdf/bsdf.py's kernel_grad route) runs the SAVE instantiation of
// the same kernels, which also writes what the weight's gradient needs,
// and its backward is bsdf_weight_grad_kernel. No TPU kernel corresponds
// to that backward either: JAX differentiates the fused XLA arithmetic.
// The container is linear in the weights, so the gradient is a few
// products a slot of the incoming gradient and the saved values; the
// eager code's backward was hundreds of launches a call. The backward
// reads the gradient (12 B), the slot values (4 B a slot), one float and
// one int32 a hit and writes 12 B a slot: at 262,144 hits x 2 slots
// ~14 MB, ~4 us at 3.35 TB/s, so again one launch is its cost.
//
// The design:
//   * One thread a hit; each slot's lobe type picks its arithmetic in a
//     switch. Neighbouring pixels mostly share a material, so a warp
//     diverges only where it straddles two.
//   * Inputs are read through their strides, as the container's callers
//     hand them over (column blocks of the gathered hit rows), the lobe
//     types, flags and counts as int64.
//   * The values are the eager code's, bit for bit. Every float operation
//     is the one that ATen's CUDA kernel for the eager operation performs,
//     in the same order, and the file is built without contraction
//     (--fmad=false, IEEE division and square root):
//       - `c / t` on a tensor is `t.reciprocal() * c`: 1 / t, times c;
//       - `t / c` by a Python scalar multiplies by the reciprocal of the
//         float32 c (div_true_kernel_cuda);
//       - torch.maximum / minimum return a NaN operand, else fmaxf / fminf;
//       - a sum over an axis follows ATen's reduction (Reduce.cuh): a
//         contiguous last axis of width L is read by the largest power of
//         two P <= L threads, thread x adding elements x and x + P onto the
//         identity 0, the threads then combined by a shuffle-down tree with
//         offsets P/2, P/4, ..., 1; a non-contiguous axis is summed by one
//         thread into four accumulators (element s into accumulator s % 4),
//         combined in order. So a dot product of three is
//         ((0 + p0) + p2) + p1;
//       - torch.linalg.cross contracts each component into an fma (PyTorch
//         is built with --fmad=true): a*b - c*d is fma(a, b, -(c*d));
//       - sin, cos, exp, pow, sqrt and rsqrt are the CUDA math library's
//         sinf, cosf, expf, powf, sqrtf and rsqrtf, as ATen calls them.
#include <cuda_runtime.h>

// What a call hands over: pointers, and strides in elements. Every field
// is 8 bytes wide, so the ctypes mirror in bsdf/kernel.py has no padding.
struct BsdfArgs {
  const long long* type; long long type_s0, type_s1;
  const long long* flags; long long flags_s0, flags_s1;
  const float* weight; long long weight_s0, weight_s1, weight_s2;
  const float* param; long long param_s0, param_s1, param_s2;
  const long long* n_lobes; long long n_lobes_s0;
  const float* n; long long n_s0, n_s1;
  const float* wi; long long wi_s0, wi_s1;
  const float* wo; long long wo_s0, wo_s1;  // bsdf_eval only
  const float* u2; long long u2_s0, u2_s1;  // bsdf_sample only
  long long lanes;
  long long max_lobes;  // L: the slots the eval calls read
  long long sel_slots;  // the slots bsdf_sample selects from (type's columns)
  long long present;    // bit t: lobe type t is evaluated and sampled
  float* f_out;         // (lanes, 3) f, or (lanes,) pdf for bsdf_pdf
  float* wo_out;        // (lanes, 3)
  float* pdf_out;       // (lanes,)
  long long* flags_out; // (lanes,)
  // SAVE (set when e_out is not null): what bsdf_weight_grad_kernel reads
  float* e_out;         // (lanes, max_lobes) each slot's lobe value (bsdf_sample: L > 1 only)
  float* scale_out;     // (lanes,) n.wi (bsdf_f) or the selected lobe's value (bsdf_sample)
  int* bits_out;        // (lanes,) see GRAD_BITS
};

// GRAD_BITS, a hit's int32 of the SAVE forward: bit s (s < max_lobes) is
// slot s's mask (bsdf_f: active and hemisphere-matching; bsdf_sample:
// folded in); bsdf_sample adds the selected slot in bits 8-15 (255: none
// of the weight's slots) and whether the sample was valid in bit 16.
constexpr int SEL_SHIFT = 8, SEL_NONE = 255, VALID_BIT = 1 << 16;

namespace {

// lobe type codes and flags (core/material.py)
constexpr long long DIFFUSE = 1, OREN_NAYAR = 2, REFLECTION = 3, REFRACTION = 4,
                    MICROFACET = 5, MICROFACET_REFRACT = 6, SHEEN = 7, TRANSPARENT = 8;
constexpr long long FLAG_REFLECT = 8, FLAG_TRANSMIT = 16;
constexpr int MAX_SLOTS = 8;  // core/material.py MAX_LOBES
constexpr int THREADS = 256;

// float32 roundings of the Python constants of bsdf/lobes.py and math/
constexpr float PI_F = 3.14159265358979323846f;          // math.pi
constexpr float INV_PI_F = 0.318309886183790671538f;     // 1.0 / math.pi
constexpr float TWO_PI_F = 6.28318530717958647692f;      // 2.0 * math.pi
constexpr float INV_TWO_PI_F = 1.0f / TWO_PI_F;          // t / (2.0 * math.pi)
constexpr float ONE_MINUS_EPS_F = 0.99999988079071044922f;  // 1 - 2**-23

// ---------------------------------------------------------------------------
// ATen's elementwise operations (math/vec.py, math/frame.py, bsdf/lobes.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float tmax(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {  // torch.minimum
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) { return tmin(tmax(x, lo), hi); }
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }  // Tensor.reciprocal
__device__ __forceinline__ float safe_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }
__device__ __forceinline__ float safe_pow(float x, float e) { return x > 0.0f ? powf(x, e) : 0.0f; }
// _safe_div(a, b) of two tensors, and _safe_div(1.0, b): reciprocal * 1.0
__device__ __forceinline__ float safe_div(float a, float b) { return b == 0.0f ? 0.0f : a / b; }
__device__ __forceinline__ float safe_rcp(float b) { return b == 0.0f ? 0.0f : rcp(b) * 1.0f; }

// (a * b).sum(-1) over three: ATen's reduction of a contiguous last axis of 3
__device__ __forceinline__ float dot(const float a[3], const float b[3]) {
  return ((0.0f + a[0] * b[0]) + a[2] * b[2]) + (0.0f + a[1] * b[1]);
}

__device__ __forceinline__ void normalize(const float v[3], float out[3]) {
  const float r = rsqrtf(tmax(dot(v, v), 1e-20f));
  out[0] = v[0] * r; out[1] = v[1] * r; out[2] = v[2] * r;
}

// one component of torch.linalg.cross, a*b - c*d as PyTorch's build contracts it
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -(c * d));
}

struct Frame { float a[3], n[3], c[3]; };

__device__ __forceinline__ void make_frame(const float n[3], Frame& fr) {
  const float nx = n[0], ny = n[1], nz = n[2];
  const bool degenerate = (nx == ny) && (nx == nz);
  const float v[3] = {nz - ny, degenerate ? nx + nz : nx - nz, degenerate ? -ny - nx : ny - nx};
  normalize(v, fr.a);
  const float* a = fr.a;
  const float cr[3] = {cross_term(a[1], n[2], a[2], n[1]), cross_term(a[2], n[0], a[0], n[2]),
                       cross_term(a[0], n[1], a[1], n[0])};
  normalize(cr, fr.c);
  fr.n[0] = nx; fr.n[1] = ny; fr.n[2] = nz;
}

__device__ __forceinline__ void to_local(const Frame& fr, const float v[3], float out[3]) {
  out[0] = dot(v, fr.a); out[1] = dot(v, fr.n); out[2] = dot(v, fr.c);
}

__device__ __forceinline__ void to_world(const Frame& fr, const float v[3], float out[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = (v[0] * fr.a[k] + v[1] * fr.n[k]) + v[2] * fr.c[k];
}

__device__ __forceinline__ float sin_theta(const float v[3]) {
  return safe_sqrt(1.0f - v[1] * v[1]);
}

__device__ __forceinline__ float cos_phi(const float v[3]) {
  const float s = sin_theta(v);
  return s == 0.0f ? 1.0f : clip(v[0] / s, -1.0f, 1.0f);
}

__device__ __forceinline__ float sin_phi(const float v[3]) {
  const float s = sin_theta(v);
  return s == 0.0f ? 0.0f : clip(v[2] / s, -1.0f, 1.0f);
}

// math/fresnel.py dielectric
__device__ float dielectric(float cosi, float eta) {
  const float eta_eff = cosi < 0.0f ? rcp(eta == 0.0f ? 1.0f : eta) * 1.0f : eta;
  const float c = fabsf(cosi);
  const float g2 = (eta_eff * eta_eff - 1.0f) + c * c;
  const float g = safe_sqrt(g2);
  const float gc = g + c;
  const float A = (g - c) / (gc == 0.0f ? 1.0f : gc);
  float denom_b = c * (g - c) + 1.0f;
  denom_b = denom_b == 0.0f ? 1.0f : denom_b;
  const float B = (c * (g + c) - 1.0f) / denom_b;
  float f = ((0.5f * A) * A) * (1.0f + B * B);
  f = g2 > 0.0f ? f : 1.0f;
  return eta == 0.0f ? 1.0f : f;
}

// ---------------------------------------------------------------------------
// GGX and sheen distributions (bsdf/lobes.py)
// ---------------------------------------------------------------------------

__device__ float ggx_D(float ax, float ay, const float v[3]) {
  const float cos2 = v[1] * v[1];
  const float sin2 = tmax(1.0f - cos2, 0.0f);
  const float tan2 = safe_div(sin2, cos2);
  const float cos4 = cos2 * cos2;
  const float cp = cos_phi(v), sp = sin_phi(v);
  const float e = (safe_div(cp * cp, ax * ax) + safe_div(sp * sp, ay * ay)) * tan2;
  const float d = safe_rcp(((((PI_F * ax) * ay) * cos4) * (1.0f + e)) * (1.0f + e));
  return cos2 == 0.0f ? 0.0f : d;
}

__device__ float ggx_Lambda(float ax, float ay, const float v[3]) {
  const float cos2 = v[1] * v[1];
  const float sin2 = tmax(1.0f - cos2, 0.0f);
  const float abs_tan = safe_sqrt(safe_div(sin2, cos2));
  const float t = safe_sqrt(ax * ay) * abs_tan;
  const float lam = (sqrtf(1.0f + t * t) + -1.0f) * 0.5f;
  return cos2 == 0.0f ? 0.0f : lam;
}

__device__ __forceinline__ float ggx_G(float ax, float ay, const float li[3], const float lo[3]) {
  return rcp((1.0f + ggx_Lambda(ax, ay, li)) + ggx_Lambda(ax, ay, lo)) * 1.0f;
}

__device__ __forceinline__ float ggx_G1(float ax, float ay, const float v[3]) {
  return rcp(1.0f + ggx_Lambda(ax, ay, v)) * 1.0f;
}

__device__ void ggx_sample_slope(float cos_theta, float u, float v, float& sx, float& sy) {
  const float r_ni = sqrtf(safe_div(u, 1.0f - u));
  const float phi_ni = 6.28318530718f * v;
  const float sx_ni = r_ni * cosf(phi_ni);
  const float sy_ni = r_ni * sinf(phi_ni);

  const float sin_t = safe_sqrt(1.0f - cos_theta * cos_theta);
  const float tan_theta = sin_t / (cos_theta == 0.0f ? 1.0f : cos_theta);
  const float safe_tan = tan_theta == 0.0f ? 1.0f : tan_theta;
  const float a = rcp(safe_tan) * 1.0f;
  const float g1 = rcp(1.0f + sqrtf(rcp(a * a) * 1.0f + 1.0f)) * 2.0f;

  const float A = (2.0f * u) / g1 - 1.0f;
  const float denom = A * A - 1.0f;
  const float tmp = tmin(safe_rcp(denom), 1e10f);
  const float B = tan_theta;
  const float Dterm = safe_sqrt(((B * B) * tmp) * tmp - ((A * A) - (B * B)) * tmp);
  const float x1 = B * tmp - Dterm;
  const float x2 = B * tmp + Dterm;
  const float slope_x = (A < 0.0f || x2 > rcp(safe_tan) * 1.0f) ? x1 : x2;

  const float S = v > 0.5f ? 1.0f : -1.0f;
  const float v2 = v > 0.5f ? 2.0f * (v - 0.5f) : 2.0f * (0.5f - v);
  const float z = (v2 * (v2 * (v2 * 0.27385f - 0.73369f) + 0.46341f)) /
                  (v2 * (v2 * (v2 * 0.093073f + 0.309420f) - 1.0f) + 0.597999f);
  const float slope_y = (S * z) * sqrtf(1.0f + slope_x * slope_x);

  const bool ni = cos_theta > 0.9999f;
  sx = ni ? sx_ni : slope_x;
  sy = ni ? sy_ni : slope_y;
}

// the visible-normal half vector: wh (local) and its pdf
__device__ void ggx_sample_wh(float ax, float ay, const float li[3], float u0, float u1,
                              float wh[3], float& pdf) {
  const float st[3] = {ax * li[0], li[1], ay * li[2]};
  float s[3];
  normalize(st, s);
  float sx, sy;
  ggx_sample_slope(s[1], u0, u1, sx, sy);
  const float cp = cos_phi(s), sp = sin_phi(s);
  const float rx = (cp * sx - sp * sy) * ax;
  const float ry = (sp * sx + cp * sy) * ay;
  const float h[3] = {-rx, 1.0f, -ry};
  normalize(h, wh);
  pdf = ((ggx_D(ax, ay, wh) * ggx_G1(ax, ay, li)) * fabsf(dot(li, wh))) /
        tmax(fabsf(li[1]), 1e-12f);
}

__device__ float sheen_L(float x, float r) {
  const float t = (1.0f - r) * (1.0f - r);
  const float it = 1.0f - t;
  const float a = t * 25.3245f + it * 21.5473f;
  const float b = t * 3.32435f + it * 3.82987f;
  const float c = t * 0.16801f + it * 0.19823f;
  const float d = t * -1.27393f + it * -1.97760f;
  const float e = t * -4.85967f + it * -4.32054f;
  const float xc = safe_pow(x, c);
  return (a / (1.0f + b * xc) + d * x) + e;
}

__device__ float sheen_D(float r, const float v[3]) {
  const float oor = safe_rcp(r);
  return ((2.0f + oor) * safe_pow(sin_theta(v), oor)) * INV_TWO_PI_F;
}

__device__ float sheen_Lambda(float r, const float v[3]) {
  const float L5 = sheen_L(0.5f, r);
  const float ct = v[1];
  const float lo = sheen_L(ct, r);
  const float hi = 2.0f * L5 - sheen_L(1.0f - ct, r);
  return expf(tmin(ct < 0.5f ? lo : hi, 60.0f));
}

// ---------------------------------------------------------------------------
// Lobe evaluations (bsdf/lobes.py ct_f, ct_pdf, sheen_f, ct_refract_f,
// ct_refract_pdf, oren_nayar_f); li, lo local, wi, wo world
// ---------------------------------------------------------------------------

__device__ float ct_f_local(float D, float G, const float li[3], const float lo[3],
                            const float wh[3]) {
  const float cos_ti = fabsf(li[1]), cos_to = fabsf(lo[1]);
  const bool flip = wh[1] < 0.0f;
  const float whf[3] = {flip ? -wh[0] : wh[0], flip ? -wh[1] : wh[1], flip ? -wh[2] : wh[2]};
  const float F = dielectric(dot(lo, whf), 0.5f);
  const float c = ((D * G) * F) * safe_rcp((4.0f * cos_ti) * cos_to);
  const bool valid = (li[1] * lo[1] > 0.0f) && cos_ti != 0.0f && cos_to != 0.0f;
  return valid ? c : 0.0f;
}

__device__ __forceinline__ bool half_degenerate(const float whs[3]) {
  return whs[0] == 0.0f || whs[1] == 0.0f || whs[2] == 0.0f;
}

__device__ float ct_f(float ax, float ay, const float li[3], const float lo[3]) {
  const float whs[3] = {li[0] + lo[0], li[1] + lo[1], li[2] + lo[2]};
  float wh[3];
  normalize(whs, wh);
  const float c = ct_f_local(ggx_D(ax, ay, wh), ggx_G(ax, ay, li, lo), li, lo, wh);
  return half_degenerate(whs) ? 0.0f : c;
}

__device__ float ct_pdf(float ax, float ay, const float li[3], const float lo[3]) {
  const float whs[3] = {li[0] + lo[0], li[1] + lo[1], li[2] + lo[2]};
  float wh[3];
  normalize(whs, wh);
  const float li_wh = dot(li, wh);
  const float pdf = (((ggx_D(ax, ay, wh) * ggx_G1(ax, ay, li)) * fabsf(li_wh)) *
                     safe_rcp(fabsf(li[1]))) * safe_rcp(4.0f * li_wh);
  return li[1] * lo[1] > 0.0f ? pdf : 0.0f;
}

__device__ float sheen_f(float r, const float li[3], const float lo[3]) {
  r = clip(r, 5e-3f, 1.0f);
  const float whs[3] = {li[0] + lo[0], li[1] + lo[1], li[2] + lo[2]};
  float wh[3];
  normalize(whs, wh);
  const float G = rcp((1.0f + sheen_Lambda(r, li)) + sheen_Lambda(r, lo)) * 1.0f;
  const float c = ct_f_local(sheen_D(r, wh), G, li, lo, wh);
  return half_degenerate(whs) ? 0.0f : c;
}

__device__ float ct_refract_f(float ax, float ay, float eta_param, const float li[3],
                              const float lo[3]) {
  const float eta = li[1] > 0.0f ? eta_param : safe_rcp(eta_param);
  const float cos_ti = li[1], cos_to = lo[1];
  const float hs[3] = {li[0] + lo[0] * eta, li[1] + lo[1] * eta, li[2] + lo[2] * eta};
  float wh[3];
  normalize(hs, wh);
  if (wh[1] < 0.0f) {
    wh[0] = -wh[0]; wh[1] = -wh[1]; wh[2] = -wh[2];
  }
  const float lo_wh = dot(lo, wh), li_wh = dot(li, wh);
  const float F = dielectric(lo_wh, eta);
  const float sqrt_denom = li_wh + eta * lo_wh;
  const float factor = safe_rcp(eta);
  const float d = ggx_D(ax, ay, wh);
  const float g = ggx_G(ax, ay, li, lo);
  const float inner = (((((((d * g) * eta) * eta) * fabsf(lo_wh)) * fabsf(li_wh)) * factor) *
                       factor) * safe_rcp(((cos_ti * cos_to) * sqrt_denom) * sqrt_denom);
  const float c = (1.0f - F) * fabsf(inner);
  const bool invalid = (li[1] * lo[1] > 0.0f) || cos_ti == 0.0f || cos_to == 0.0f ||
                       (lo_wh * li_wh > 0.0f);
  return invalid ? 0.0f : c;
}

__device__ float ct_refract_pdf(float ax, float ay, float eta_param, const float li[3],
                                const float lo[3], float wi_wo) {
  const float eta = li[1] > 0.0f ? eta_param : safe_rcp(eta_param);
  const float hs[3] = {li[0] + lo[0] * eta, li[1] + lo[1] * eta, li[2] + lo[2] * eta};
  float wh[3];
  normalize(hs, wh);
  const float lo_wh = dot(lo, wh);
  const float sqrt_denom = dot(li, wh) + eta * lo_wh;
  const float dwh_dwi = fabsf((eta * eta) * lo_wh) * safe_rcp(sqrt_denom * sqrt_denom);
  const float pdf = (ggx_D(ax, ay, wh) * wh[1]) * dwh_dwi;
  return wi_wo > 0.0f ? 0.0f : pdf;
}

__device__ float oren_nayar_f(float a, float b, const float li[3], const float lo[3]) {
  const float cos_ti = fabsf(li[1]), cos_to = fabsf(lo[1]);
  const float sin_ti = sin_theta(li), sin_to = sin_theta(lo);
  const float dcos = cos_phi(li) * cos_phi(lo) + sin_phi(li) * sin_phi(lo);
  const float max_cos = (sin_ti > 1e-4f && sin_to > 1e-4f) ? tmax(dcos, 0.0f) : 0.0f;
  const bool i_gt_o = cos_ti > cos_to;
  const float sin_alpha = i_gt_o ? sin_to : sin_ti;
  const float tan_beta = i_gt_o ? safe_div(sin_ti, cos_ti) : safe_div(sin_to, cos_to);
  return (a + ((b * max_cos) * sin_alpha) * tan_beta) * INV_PI_F;
}

__device__ __forceinline__ bool is_present(long long present, long long type) {
  return type >= 0 && type < 63 && ((present >> type) & 1);
}

// EVALS: (f, pdf) of one slot; REFLECTION, REFRACTION, TRANSPARENT and
// absent types evaluate to 0
__device__ void eval_slot(long long type, long long present, float p0, float p1, float p2,
                          const float li[3], const float lo[3], float n_wi, float wi_wo,
                          float& f, float& pdf) {
  f = 0.0f;
  pdf = 0.0f;
  if (!is_present(present, type)) return;
  switch (type) {
    case DIFFUSE:
      f = INV_PI_F;
      pdf = n_wi * INV_PI_F;
      break;
    case OREN_NAYAR:
      f = oren_nayar_f(p1, p2, li, lo);
      pdf = n_wi * INV_PI_F;
      break;
    case MICROFACET:
      f = ct_f(p0, p1, li, lo);
      pdf = ct_pdf(p0, p1, li, lo);
      break;
    case MICROFACET_REFRACT:
      f = ct_refract_f(p0, p1, p2, li, lo);
      pdf = ct_refract_pdf(p0, p1, p2, li, lo, wi_wo);
      break;
    case SHEEN:
      f = sheen_f(p0, li, lo);
      pdf = n_wi * INV_PI_F;
      break;
    default:
      break;
  }
}

// SAMPLERS: (f, wo world, pdf) of the selected lobe
__device__ void sample_slot(long long type, long long present, float p0, float p1, float p2,
                            const Frame& fr, const float wi[3], const float li[3], float n_wi,
                            float u0, float u1, float& f, float wo[3], float& pdf) {
  f = 0.0f;
  pdf = 0.0f;
  wo[0] = wo[1] = wo[2] = 0.0f;
  if (!is_present(present, type)) return;
  const float* n = fr.n;
  switch (type) {
    case DIFFUSE:
    case OREN_NAYAR:
    case SHEEN: {
      // math/sampling.py cosine_hemisphere, then to the world
      const float r = sqrtf(u0);
      const float theta = TWO_PI_F * u1;
      const float y = sqrtf(tmax(1.0f - u0, 0.0f));
      const float d[3] = {r * cosf(theta), y, r * sinf(theta)};
      to_world(fr, d, wo);
      pdf = y * INV_PI_F;
      if (type == DIFFUSE) {
        f = INV_PI_F;
      } else {
        float lo[3];
        to_local(fr, wo, lo);
        f = type == OREN_NAYAR ? oren_nayar_f(p1, p2, li, lo) : sheen_f(p0, li, lo);
      }
      break;
    }
    case REFLECTION: {
      const float s = 2.0f * n_wi;
      for (int k = 0; k < 3; ++k) wo[k] = -wi[k] + s * n[k];
      f = 1.0f;
      pdf = 1.0f;
      break;
    }
    case REFRACTION: {
      const float cos_t = n_wi;
      const float sin_t = tmax(1.0f - cos_t * cos_t, 0.0f);
      const bool entering = cos_t > 0.0f;
      const float eta_r = entering ? safe_rcp(p0) : p0;
      const float arg = 1.0f - (eta_r * eta_r) * sin_t;
      const float nk = eta_r * fabsf(cos_t) - safe_sqrt(arg);
      for (int k = 0; k < 3; ++k) wo[k] = -wi[k] * eta_r + (entering ? n[k] : -n[k]) * nk;
      f = arg >= 0.0f ? 1.0f : 0.0f;
      pdf = 1.0f;
      break;
    }
    case MICROFACET: {
      float wh[3], dpdf;
      ggx_sample_wh(p0, p1, li, u0, u1, wh, dpdf);
      const float li_wh = dot(li, wh);
      const float s = 2.0f * li_wh;
      const float lo[3] = {-li[0] + s * wh[0], -li[1] + s * wh[1], -li[2] + s * wh[2]};
      to_world(fr, lo, wo);
      float lo2[3];
      to_local(fr, wo, lo2);
      const float fv = ct_f(p0, p1, li, lo2);
      const float pv = dpdf * safe_rcp(4.0f * li_wh);
      const bool ok = li[1] != 0.0f && li_wh >= 0.0f && li[1] * lo[1] > 0.0f;
      f = ok ? fv : 0.0f;
      pdf = ok ? pv : 0.0f;
      break;
    }
    case MICROFACET_REFRACT: {
      float wh[3], dpdf;
      ggx_sample_wh(p0, p1, li, u0, u1, wh, dpdf);
      const float li_wh = dot(li, wh);
      const float eta_t = li[1] > 0.0f ? safe_rcp(p2) : p2;
      const float cos_ti = li_wh;
      const float sin2_ti = tmax(1.0f - cos_ti * cos_ti, 0.0f);
      const float sin2_tt = (eta_t * eta_t) * sin2_ti;
      const float cos_tt = safe_sqrt(1.0f - sin2_tt);
      const float s = eta_t * cos_ti - cos_tt;
      const float lo[3] = {-li[0] * eta_t + s * wh[0], -li[1] * eta_t + s * wh[1],
                           -li[2] * eta_t + s * wh[2]};
      const float lo_wh = dot(lo, wh);
      const float sqrt_denom = dot(li, wh) + eta_t * lo_wh;
      const float dwh_dwi = fabsf(((eta_t * eta_t) * lo_wh) * safe_rcp(sqrt_denom * sqrt_denom));
      to_world(fr, lo, wo);
      float lo2[3];
      to_local(fr, wo, lo2);
      const float fv = ct_refract_f(p0, p1, p2, li, lo2);
      const float pv = dpdf * dwh_dwi;
      const bool ok = li[1] != 0.0f && li_wh >= 0.0f && sin2_tt < 1.0f;
      const bool pass = p2 == 1.0f;  // the eta == 1 passthrough
      f = pass ? 1.0f : (ok ? fv : 0.0f);
      pdf = pass ? 1.0f : (ok ? pv : 0.0f);
      if (pass) {
        wo[0] = -wi[0]; wo[1] = -wi[1]; wo[2] = -wi[2];
      }
      break;
    }
    case TRANSPARENT:
      wo[0] = -wi[0]; wo[1] = -wi[1]; wo[2] = -wi[2];
      f = 1.0f;
      pdf = 1.0f;
      break;
    default:
      break;
  }
}

// ---------------------------------------------------------------------------
// The container (bsdf/bsdf.py)
// ---------------------------------------------------------------------------

// a (N, L) sum over the slots, contiguous: see the file's head
__device__ float sum_slots_contiguous(const float* v, int L) {
  const int w = L >= 8 ? 8 : (L >= 4 ? 4 : (L >= 2 ? 2 : 1));
  float t[MAX_SLOTS];
  for (int x = 0; x < w; ++x) {
    t[x] = 0.0f + v[x];
    if (x + w < L) t[x] = t[x] + v[x + w];
  }
  for (int off = w / 2; off > 0; off /= 2)
    for (int x = 0; x < off; ++x) t[x] = t[x] + t[x + off];
  return t[0];
}

// a (N, L, 3) sum over the slots, strided: four accumulators in order
__device__ float sum_slots_strided(const float* v, int L) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < L; ++s) acc[s & 3] = acc[s & 3] + v[s];
  return ((acc[0] + acc[1]) + acc[2]) + acc[3];
}

__device__ __forceinline__ bool hemisphere_match(long long fl, bool reflect) {
  return reflect ? (fl & FLAG_REFLECT) == FLAG_REFLECT : (fl & FLAG_TRANSMIT) == FLAG_TRANSMIT;
}

__device__ __forceinline__ void load3(const float* p, long long s0, long long s1, long long i,
                                      float out[3]) {
  const float* q = p + i * s0;
  out[0] = q[0]; out[1] = q[s1]; out[2] = q[2 * s1];
}

__device__ __forceinline__ float param_at(const BsdfArgs& a, long long i, long long s, int k) {
  return a.param[i * a.param_s0 + s * a.param_s1 + k * a.param_s2];
}

__device__ __forceinline__ float weight_at(const BsdfArgs& a, long long i, long long s, int k) {
  return a.weight[i * a.weight_s0 + s * a.weight_s1 + k * a.weight_s2];
}

// bsdf_f (want_pdf 0): the active hemisphere-matching slots' f * weight
// times n.wi; bsdf_pdf (want_pdf 1): their pdfs' sum over max(n_lobes, 1)
// SAVE (bsdf_f only): each slot's value, active or not, as the eager
// code's dense evaluation has it, n.wi and the slots' masks
template <bool WANT_PDF, bool SAVE>
__global__ void __launch_bounds__(THREADS) bsdf_eval_kernel(const BsdfArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= a.lanes) return;
  float n[3], wi[3], wo[3];
  load3(a.n, a.n_s0, a.n_s1, i, n);
  load3(a.wi, a.wi_s0, a.wi_s1, i, wi);
  load3(a.wo, a.wo_s0, a.wo_s1, i, wo);
  Frame fr;
  make_frame(n, fr);
  float li[3], lo[3];
  to_local(fr, wi, li);
  to_local(fr, wo, lo);
  const float n_wi = dot(n, wi);
  const float wi_wo = dot(wi, wo);
  const bool reflect = n_wi * dot(n, wo) > 0.0f;
  const long long nl = a.n_lobes[i * a.n_lobes_s0];
  const int L = static_cast<int>(a.max_lobes);
  float terms[3][MAX_SLOTS];
  float pdfs[MAX_SLOTS];
  int mask = 0;
  for (int s = 0; s < L; ++s) {
    const long long type = a.type[i * a.type_s0 + s * a.type_s1];
    const long long fl = a.flags[i * a.flags_s0 + s * a.flags_s1];
    const bool use = s < nl && hemisphere_match(fl, reflect);
    float f = 0.0f, pdf = 0.0f;
    if (SAVE || use)
      eval_slot(type, a.present, param_at(a, i, s, 0), param_at(a, i, s, 1),
                param_at(a, i, s, 2), li, lo, n_wi, wi_wo, f, pdf);
    if (SAVE) {
      a.e_out[i * L + s] = f;
      mask |= static_cast<int>(use) << s;
    }
    pdfs[s] = use ? pdf : 0.0f;
    for (int k = 0; k < 3; ++k) terms[k][s] = use ? (f * weight_at(a, i, s, k)) * n_wi : 0.0f;
  }
  if (SAVE) {
    a.scale_out[i] = n_wi;
    a.bits_out[i] = mask;
  }
  if (WANT_PDF) {
    const float total = sum_slots_contiguous(pdfs, L);
    a.f_out[i] = total / static_cast<float>(nl < 1 ? 1 : nl);
  } else {
    for (int k = 0; k < 3; ++k) a.f_out[i * 3 + k] = sum_slots_strided(terms[k], L);
  }
}

// bsdf_sample: pick a slot uniformly (remap_index_sample), sample its lobe,
// fold in the other flag-compatible slots' values and pdfs. SAVE: the
// selected lobe's value, each slot's value at the sampled direction (L > 1)
// and GRAD_BITS
template <bool SAVE>
__global__ void __launch_bounds__(THREADS) bsdf_sample_kernel(const BsdfArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= a.lanes) return;
  float n[3], wi[3];
  load3(a.n, a.n_s0, a.n_s1, i, n);
  load3(a.wi, a.wi_s0, a.wi_s1, i, wi);
  const float u0 = a.u2[i * a.u2_s0], u1 = a.u2[i * a.u2_s0 + a.u2_s1];
  const long long nl = a.n_lobes[i * a.n_lobes_s0];

  // math/sampling.py remap_index_sample
  const float count_f = static_cast<float>(nl < 1 ? 1 : nl);
  const float idx_f = tmin(floorf(u0 * count_f), count_f - 1.0f);
  const float u_remap = tmin(u0 * count_f - idx_f, ONE_MINUS_EPS_F);
  const long long idx = static_cast<long long>(idx_f);

  // the selected slot; a sum of one slot and zeros, as the eager select is
  long long type_sel = 0, flags_sel = 0;
  float w_sel[3] = {0.0f, 0.0f, 0.0f}, p_sel[3] = {0.0f, 0.0f, 0.0f};
  const bool selected = idx >= 0 && idx < a.sel_slots;
  int bits = (selected ? static_cast<int>(idx) : SEL_NONE) << SEL_SHIFT;
  if (selected) {
    type_sel = a.type[i * a.type_s0 + idx * a.type_s1];
    flags_sel = a.flags[i * a.flags_s0 + idx * a.flags_s1];
    for (int k = 0; k < 3; ++k) {
      w_sel[k] = 0.0f + weight_at(a, i, idx, k);
      p_sel[k] = 0.0f + param_at(a, i, idx, k);
    }
  }

  Frame fr;
  make_frame(n, fr);
  float li[3];
  to_local(fr, wi, li);
  const float n_wi = dot(n, wi);
  float f_s, wo[3], pdf;
  sample_slot(type_sel, a.present, p_sel[0], p_sel[1], p_sel[2], fr, wi, li, n_wi, u_remap, u1,
              f_s, wo, pdf);
  const bool selected_valid = pdf != 0.0f;
  float result[3] = {f_s * w_sel[0], f_s * w_sel[1], f_s * w_sel[2]};

  const int L = static_cast<int>(a.max_lobes);
  if (L > 1) {
    float lo[3];
    to_local(fr, wo, lo);
    const float wi_wo = dot(wi, wo);
    const bool reflect = n_wi * dot(n, wo) > 0.0f;
    float terms[3][MAX_SLOTS];
    float pdfs[MAX_SLOTS];
    long long uses = 0;
    for (int s = 0; s < L; ++s) {
      const long long type = a.type[i * a.type_s0 + s * a.type_s1];
      const long long fl = a.flags[i * a.flags_s0 + s * a.flags_s1];
      const bool use =
          s != idx && s < nl && (flags_sel & fl) == fl && hemisphere_match(fl, reflect);
      float f = 0.0f, p = 0.0f;
      if (SAVE || use)
        eval_slot(type, a.present, param_at(a, i, s, 0), param_at(a, i, s, 1),
                  param_at(a, i, s, 2), li, lo, n_wi, wi_wo, f, p);
      if (SAVE) {
        a.e_out[i * L + s] = f;
        bits |= static_cast<int>(use) << s;
      }
      uses += use;
      pdfs[s] = use ? p : 0.0f;
      for (int k = 0; k < 3; ++k) terms[k][s] = use ? f * weight_at(a, i, s, k) : 0.0f;
    }
    for (int k = 0; k < 3; ++k) result[k] = result[k] + sum_slots_strided(terms[k], L);
    pdf = (pdf + sum_slots_contiguous(pdfs, L)) / static_cast<float>(1 + uses);
  }
  for (int k = 0; k < 3; ++k) {
    a.f_out[i * 3 + k] = selected_valid ? result[k] : 0.0f;
    a.wo_out[i * 3 + k] = wo[k];
  }
  a.pdf_out[i] = selected_valid ? pdf : 0.0f;
  a.flags_out[i] = flags_sel;
  if (SAVE) {
    a.scale_out[i] = f_s;
    a.bits_out[i] = bits | (selected_valid ? VALID_BIT : 0);
  }
}

// The gradient of a container call's weight input, (lanes, out_slots, 3),
// from the incoming gradient g of its value and its SAVE forward's values:
// one thread a hit. Each value is the product eager autograd forms for it
// (bsdf/bsdf.py _bsdf_f_eager, _bsdf_sample_eager), in the same order:
//   bsdf_f:      (where(mask_s, g, 0) * n.wi) * e_s, 0 past max_lobes;
//   bsdf_sample: g1 = where(valid, g, 0); the selected slot's g1 * f_s
//                (+0 on the others), plus, where max_lobes > 1,
//                where(folded_s, g1, 0) * e_s (+0 past max_lobes): the sum
//                autograd accumulates from the weight's two uses.
template <bool SAMPLE>
__global__ void __launch_bounds__(THREADS) bsdf_weight_grad_kernel(
    const float* g, long long g_s0, long long g_s1, const float* e, const float* scale,
    const int* bits, float* out, long long lanes, int L, int out_slots) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= lanes) return;
  const int b = bits[i];
  const float sc = scale[i];
  float gk[3];
  load3(g, g_s0, g_s1, i, gk);
  float* o = out + i * out_slots * 3;
  if (!SAMPLE) {
    for (int s = 0; s < out_slots; ++s) {
      const bool m = s < L && ((b >> s) & 1);
      const float es = s < L ? e[i * L + s] : 0.0f;
      for (int k = 0; k < 3; ++k) o[s * 3 + k] = s < L ? ((m ? gk[k] : 0.0f) * sc) * es : 0.0f;
    }
    return;
  }
  const bool valid = (b & VALID_BIT) != 0;
  const int sel = (b >> SEL_SHIFT) & 0xFF;
  float g1[3];
  for (int k = 0; k < 3; ++k) g1[k] = valid ? gk[k] : 0.0f;
  for (int s = 0; s < out_slots; ++s) {
    const bool folded = s < L && ((b >> s) & 1);
    const float es = (L > 1 && s < L) ? e[i * L + s] : 0.0f;
    for (int k = 0; k < 3; ++k) {
      const float picked = s == sel ? g1[k] * sc : 0.0f;
      if (L > 1) {
        const float fold = s < L ? (folded ? g1[k] : 0.0f) * es : 0.0f;
        o[s * 3 + k] = picked + fold;
      } else {
        o[s * 3 + k] = picked;
      }
    }
  }
}

}  // namespace

// a non-null e_out selects the SAVE instantiation (bsdf_f and bsdf_sample)
extern "C" int bsdf_eval_launch(const BsdfArgs* args, int want_pdf, void* stream) {
  if (args->lanes <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((args->lanes + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (want_pdf)
    bsdf_eval_kernel<true, false><<<blocks, THREADS, 0, s>>>(*args);
  else if (args->e_out != nullptr)
    bsdf_eval_kernel<false, true><<<blocks, THREADS, 0, s>>>(*args);
  else
    bsdf_eval_kernel<false, false><<<blocks, THREADS, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsdf_sample_launch(const BsdfArgs* args, void* stream) {
  if (args->lanes <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((args->lanes + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->e_out != nullptr)
    bsdf_sample_kernel<true><<<blocks, THREADS, 0, s>>>(*args);
  else
    bsdf_sample_kernel<false><<<blocks, THREADS, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bsdf_weight_grad_launch(const float* g, long long g_s0, long long g_s1,
                                       const float* e, const float* scale, const int* bits,
                                       float* out, long long lanes, int max_lobes,
                                       int out_slots, int sample, void* stream) {
  if (lanes <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((lanes + THREADS - 1) / THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample)
    bsdf_weight_grad_kernel<true><<<blocks, THREADS, 0, s>>>(g, g_s0, g_s1, e, scale, bits, out,
                                                             lanes, max_lobes, out_slots);
  else
    bsdf_weight_grad_kernel<false><<<blocks, THREADS, 0, s>>>(g, g_s0, g_s1, e, scale, bits,
                                                              out, lanes, max_lobes, out_slots);
  return static_cast<int>(cudaGetLastError());
}

// the layout check of bsdf/kernel.py: the size of BsdfArgs and MAX_SLOTS
extern "C" void bsdf_geometry(long long* args_bytes, long long* max_slots) {
  *args_bytes = static_cast<long long>(sizeof(BsdfArgs));
  *max_slots = MAX_SLOTS;
}

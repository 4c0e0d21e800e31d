"""Moller-Trumbore ray-triangle intersection.

Counterpart of ``phosphorus_mk2_tpu/accel/intersect.py`` (reference
src/accel/triangle.hpp:25-290): the batched test, its struct-of-arrays
form, the scene-level oracle tracers ``intersect_brute`` /
``occluded_brute`` (every ray against every triangle, in chunks: the
JAX package's correctness oracle, the analogue of the reference's debug
``linear_mbvh_kernel_t``, src/kernels/cpu/linear_bvh_kernel.hpp:8-15)
and ``reintersect``, the re-evaluation of a known (ray, triangle) pair
that the integrator shades from. The integrator's own brute-force tracer
is the hand kernels of ``accel/mt.py``.

Barycentric convention (triangle.hpp:84-100): u weights vertex b, v
weights vertex c, hit P = (1-u-v)a + u*b + v*c.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.math.vec import cross, dot

DET_EPS = 1e-8
T_MAX = 3.4e38  # rounds to float32 3.4e38, as in the JAX package
MISS_KEY = 0x7F800000  # +inf's bits, lane cleared: above the key of any finite t
WORD = 0xFFFFFFFF
# elements of one (rays x chunk) slab of the brute tracers: a bound on
# their temporaries; rays are traced in slices of at most this over chunk
SLAB_ELEMENTS = 1 << 24


def mt_intersect(p, d, a, b, c):
    """Batched MT test, all arguments broadcastable to (..., 3).

    Returns (t, u, v, valid): valid requires |det| >= eps, 0<=u<=1,
    v>=0, u+v<=1, t>=0 (reference triangle.hpp:84-116 semantics).
    """
    e0 = b - a
    e1 = c - a
    pvec = cross(d, e1)
    det = dot(e0, pvec)
    near_zero = det.abs() < DET_EPS
    ood = 1.0 / torch.where(near_zero, 1.0, det)
    tvec = p - a
    u = dot(tvec, pvec) * ood
    qvec = cross(tvec, e0)
    v = dot(d, qvec) * ood
    t = dot(e1, qvec) * ood
    valid = (
        ~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    )
    return t, u, v, valid


def mt_intersect_soa(p, d, a, e0, e1):
    """SoA Moller-Trumbore: rays as tuples of (N, 1) components against
    triangles as tuples of (1, C) components (or any two broadcastable
    shapes); every intermediate is (N, C) and is rounded after each
    operation, in the order the hand kernels of ``accel/mt.py`` use.
    Returns (t, u, v, valid) as (N, C).
    """
    px, py, pz = p
    dx, dy, dz = d
    ax, ay, az = a
    e0x, e0y, e0z = e0
    e1x, e1y, e1z = e1

    pvx = dy * e1z - dz * e1y
    pvy = dz * e1x - dx * e1z
    pvz = dx * e1y - dy * e1x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    near_zero = det.abs() < DET_EPS
    ood = 1.0 / torch.where(near_zero, 1.0, det)
    tx = px - ax
    ty = py - ay
    tz = pz - az
    u = (tx * pvx + ty * pvy + tz * pvz) * ood
    qvx = ty * e0z - tz * e0y
    qvy = tz * e0x - tx * e0z
    qvz = tx * e0y - ty * e0x
    v = (dx * qvx + dy * qvy + dz * qvz) * ood
    t = (e1x * qvx + e1y * qvy + e1z * qvz) * ood
    valid = (
        ~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    )
    return t, u, v, valid


def reintersect(scene, tri, p, d, attr=None, row=None):
    """(t, u, v) for known triangle ids (N,), clamped to valid ids.

    row: pre-gathered attribute rows (N, >= 9) — zero gathers here;
    attr: triangle_attribute_table rows to gather from; otherwise the
    vertices are gathered through scene.faces.
    """
    if row is None:
        safe = torch.clamp(tri, min=0).long()
        if attr is not None:
            row = attr[safe]
        else:
            f = scene.faces[safe].long()
            row = torch.cat(
                [scene.vertices[f[:, 0]], scene.vertices[f[:, 1]], scene.vertices[f[:, 2]]],
                dim=1,
            )
    a, b, c = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    t, u, v, _ = mt_intersect(p, d, a, b, c)
    return t, u, v


def _tri_soa(scene):
    """(1, T) components of a, e0, e1 for every triangle, from the
    detached vertices."""
    f = scene.faces.long()
    v = scene.vertices.detach()
    a = v[f[:, 0]]
    e0 = v[f[:, 1]] - a
    e1 = v[f[:, 2]] - a
    return tuple(tuple(x[None, :, k] for k in range(3)) for x in (a, e0, e1))


def ray_soa(p, d):
    """(N, 1) components of rays p, d (N, 3), as mt_intersect_soa takes them."""
    return (p[:, 0:1], p[:, 1:2], p[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3])


def _chunk_of(num_tris: int, chunk: int | None) -> int:
    # a lane-multiple round-up for small scenes instead of a fixed 512
    return chunk or min(512, max(128, ((num_tris + 127) // 128) * 128))


def _slices(n: int, chunk: int):
    step = max(1, SLAB_ELEMENTS // chunk)
    return [slice(r, min(n, r + step)) for r in range(0, n, step)]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its uint32 bits as an int64 in [0, 2^32)."""
    return x.view(torch.int32).to(torch.int64) & WORD


def intersect_brute(scene, p, d, tmax=None, chunk: int | None = None):
    """Closest hit over the whole triangle soup (the oracle tracer), with
    the JAX package's contract: p, d (N, 3), tmax (N,) or None; returns
    {"t", "tri" (int32, -1 on a miss), "u", "v", "hit"}.

    The triangles are taken in chunks of ``chunk`` lanes; in each, a
    packed key ``(t_bits & ~lane_mask) | lane`` reduces with one min, so
    the winning lane lives in t's cleared low mantissa bits (the keys
    are uint32 words held in int64). Within one quantization step (2^-15
    relative at 512-lane chunks) the lower lane wins even at a slightly
    larger t. A hit needs t < tmax strictly. The winner's t, u and v are
    recomputed with ``mt_intersect`` from the scene's vertices, which
    carries their gradient as in the JAX package; the choice of triangle
    carries none.
    """
    n = p.shape[0]
    num_tris = scene.faces.shape[0]
    chunk = _chunk_of(num_tris, chunk)
    lane_bits = max(1, (chunk - 1).bit_length())  # 512 lanes -> 9 bits
    lane_mask = (1 << lane_bits) - 1
    with torch.no_grad():
        a, e0, e1 = _tri_soa(scene)
        pd, dd = p.detach(), d.detach()
        t0 = (torch.full((n,), T_MAX, dtype=torch.float32, device=p.device)
              if tmax is None else tmax.detach().to(torch.float32))
        # the worst lane at the bound: any strictly closer cleared t wins
        best_key = (torch.clamp(_bits(t0), max=MISS_KEY) & (WORD ^ lane_mask)) | lane_mask
        best_tri = torch.full((n,), -1, dtype=torch.int64, device=p.device)
        lanes = torch.arange(chunk, dtype=torch.int64, device=p.device)[None, :]
        for rs in _slices(n, chunk):
            rp, rd = ray_soa(pd[rs], dd[rs])
            for base in range(0, num_tris, chunk):
                cs = slice(base, min(num_tris, base + chunk))  # the pad lanes are misses
                t, _, _, valid = mt_intersect_soa(
                    rp, rd, *(tuple(c[:, cs] for c in x) for x in (a, e0, e1)))
                if tmax is not None:
                    valid = valid & (t < t0[rs, None])
                keys = torch.where(valid, (_bits(t) & (WORD ^ lane_mask)) | lanes[:, : t.shape[1]],
                                   MISS_KEY)
                kmin = keys.amin(dim=1)
                better = (kmin < best_key[rs]) & (kmin < MISS_KEY)
                best_key[rs] = torch.where(better, kmin, best_key[rs])
                best_tri[rs] = torch.where(better, base + (kmin & lane_mask), best_tri[rs])
    tri = best_tri.to(torch.int32)
    hit = tri >= 0
    f = scene.faces[tri.clamp(min=0).long()].long()
    v = scene.vertices
    t, u, vv, _ = mt_intersect(p, d, v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    return {"t": torch.where(hit, t, T_MAX), "tri": tri, "u": torch.where(hit, u, 0.0),
            "v": torch.where(hit, vv, 0.0), "hit": hit}


def occluded_brute(scene, p, d, tmax, chunk: int | None = None):
    """Any hit with t in [0, tmax) over the whole triangle soup: (N,)
    bool, an OR over the chunks."""
    n = p.shape[0]
    num_tris = scene.faces.shape[0]
    chunk = _chunk_of(num_tris, chunk)
    with torch.no_grad():
        a, e0, e1 = _tri_soa(scene)
        pd, dd, tmax = p.detach(), d.detach(), tmax.detach()
        hit = torch.zeros((n,), dtype=torch.bool, device=p.device)
        for rs in _slices(n, chunk):
            rp, rd = ray_soa(pd[rs], dd[rs])
            for base in range(0, num_tris, chunk):
                cs = slice(base, min(num_tris, base + chunk))
                t, _, _, valid = mt_intersect_soa(
                    rp, rd, *(tuple(c[:, cs] for c in x) for x in (a, e0, e1)))
                hit[rs] |= (valid & (t < tmax[rs, None])).any(dim=1)
    return hit

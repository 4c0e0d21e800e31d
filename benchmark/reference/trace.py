"""Closest-hit and any-hit ray casting for the reference, in plain PyTorch.

Moller-Trumbore ("Fast, Minimum Storage Ray/Triangle Intersection", 1997)
with every product and sum rounded in one fixed order, against every
triangle a ray can reach. The culling is the reference's own and decides no
result: triangles are ordered along a Morton curve of their centroids and
cut into runs of GROUP, and runs of GROUP runs; a ray meets a run's
triangles only where it meets the run's box, grown by a margin. The closest
hit is the valid hit of least t, ties to the lowest triangle id; t is stored
as +0.0 where it is -0.0.
"""
from __future__ import annotations

import torch

T_MAX = 3.4e38
DET_EPS = 1e-8
GROUP = 64
NO_HIT = (1 << 63) - 1
PAIR_BUDGET = 1 << 22  # (pair, member) tests of one step: bounds the temporaries
RAY_STEP = 8192        # rays whose group pairs are found together


def mt_soa(p, d, a, e0, e1):
    """t, u, v, valid of rays (..., 3) against triangles (..., 3), broadcast,
    component by component in the order of the program's kernels."""
    px, py, pz = p.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ax, ay, az = a.unbind(-1)
    e0x, e0y, e0z = e0.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    pvx = dy * e1z - dz * e1y
    pvy = dz * e1x - dx * e1z
    pvz = dx * e1y - dy * e1x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    near_zero = det.abs() < DET_EPS
    ood = 1.0 / torch.where(near_zero, 1.0, det)
    tx, ty, tz = px - ax, py - ay, pz - az
    u = (tx * pvx + ty * pvy + tz * pvz) * ood
    qvx = ty * e0z - tz * e0y
    qvy = tz * e0x - tx * e0z
    qvz = tx * e0y - ty * e0x
    v = (dx * qvx + dy * qvy + dz * qvz) * ood
    t = (e1x * qvx + e1y * qvy + e1z * qvz) * ood
    valid = ~near_zero & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return t, u, v, valid


def _morton(c):
    """30-bit Morton codes of points c (N, 3) in their bounding box."""
    lo, hi = c.min(0).values, c.max(0).values
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0).long().clamp(0, 1023)
    code = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def _boxes(lo, hi, valid, n_groups):
    """Per-group bounds of members (n_groups * GROUP, 3), grown by a margin."""
    big = torch.tensor(3e38, device=lo.device)
    lo = torch.where(valid[:, None], lo, big).reshape(n_groups, GROUP, 3).min(1).values
    hi = torch.where(valid[:, None], hi, -big).reshape(n_groups, GROUP, 3).max(1).values
    pad = 1e-4 * (1.0 + torch.maximum(lo.abs(), hi.abs()))
    return lo - pad, hi + pad, valid.reshape(n_groups, GROUP).any(1)


class Tracer:
    """Rays against the triangles a, b, c (F, 3) float32 (global ids 0..F-1)."""

    def __init__(self, a, b, c):
        dev = a.device
        n = a.shape[0]
        order = torch.argsort(_morton((a + b + c) / 3.0), stable=True)
        n1 = -(-n // GROUP)
        n2 = -(-n1 // GROUP)
        slots = n2 * GROUP * GROUP
        ids = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        ids[:n] = order
        safe = ids.clamp(min=0)
        self.ids = ids                                  # (slots,) triangle id or -1
        self.a = a[safe]
        self.e0 = b[safe] - self.a
        self.e1 = c[safe] - self.a
        valid = ids >= 0
        tlo = torch.minimum(torch.minimum(a, b), c)[safe]
        thi = torch.maximum(torch.maximum(a, b), c)[safe]
        self.lo1, self.hi1, v1 = _boxes(tlo, thi, valid, n2 * GROUP)
        self.lo2, self.hi2, self.v2 = _boxes(self.lo1, self.hi1, v1, n2)
        self.v1 = v1

    @staticmethod
    def _slab(o, inv, lo, hi, tmax):
        t0 = (lo - o) * inv
        t1 = (hi - o) * inv
        tn = torch.minimum(t0, t1).max(-1).values
        tf = torch.maximum(t0, t1).min(-1).values
        return (tn <= tf) & (tf >= 0.0) & (tn <= tmax)

    def _pairs(self, p, d, tmax):
        """(ray, first-level group) pairs whose boxes the rays meet."""
        dd = torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
        inv = 1.0 / dd
        hit2 = self._slab(p[:, None], inv[:, None], self.lo2[None], self.hi2[None],
                          tmax[:, None]) & self.v2[None]
        r, g2 = hit2.nonzero(as_tuple=True)
        kids = g2[:, None] * GROUP + torch.arange(GROUP, device=p.device)[None]
        hit1 = self._slab(p[r, None], inv[r, None], self.lo1[kids], self.hi1[kids],
                          tmax[r, None]) & self.v1[kids]
        k = hit1.nonzero(as_tuple=True)
        return r[k[0]], kids[k]

    def _walk(self, p, d, tmax, fn):
        """fn(ray ids, slot ids (P, GROUP)) over the member triangles of every
        group a ray meets, in steps of at most PAIR_BUDGET tests."""
        step = RAY_STEP
        for r0 in range(0, p.shape[0], step):
            r1 = min(r0 + step, p.shape[0])
            rays, groups = self._pairs(p[r0:r1], d[r0:r1], tmax[r0:r1])
            rays = rays + r0
            per = max(1, PAIR_BUDGET // GROUP)
            for s0 in range(0, rays.shape[0], per):
                rr = rays[s0:s0 + per]
                slots = groups[s0:s0 + per, None] * GROUP + torch.arange(GROUP, device=p.device)
                fn(rr, slots)

    def closest(self, p, d, tmax):
        """tri (N,) int64, -1 where no valid hit has t < tmax."""
        key = torch.full((p.shape[0],), NO_HIT, dtype=torch.int64, device=p.device)

        def fn(rr, slots):
            t, _, _, ok = mt_soa(p[rr, None], d[rr, None], self.a[slots], self.e0[slots],
                                 self.e1[slots])
            tri = self.ids[slots]
            ok = ok & (tri >= 0)
            t = t + 0.0
            k = torch.where(ok, (t.view(torch.int32).long() << 32) | tri.clamp(min=0), NO_HIT)
            key.scatter_reduce_(0, rr, k.min(1).values, "amin")

        self._walk(p, d, tmax, fn)
        hit = key != NO_HIT
        t = (key >> 32).to(torch.int32).view(torch.float32)
        tri = torch.where(hit, key & 0xFFFFFFFF, -1)
        return torch.where(hit & (t < tmax), tri, -1)

    def occluded(self, p, d, tmax):
        """(N,) bool: some valid hit with t < tmax; never where tmax <= 0."""
        occ = torch.zeros((p.shape[0],), dtype=torch.bool, device=p.device)
        live = (tmax > 0.0).nonzero()[:, 0]
        if live.numel() == 0:
            return occ
        pl, dl, tl = p[live], d[live], tmax[live]

        def fn(rr, slots):
            t, _, _, ok = mt_soa(pl[rr, None], dl[rr, None], self.a[slots], self.e0[slots],
                                 self.e1[slots])
            ok = ok & (self.ids[slots] >= 0) & (t < tl[rr, None])
            occ[live[rr[ok.any(1)]]] = True

        self._walk(pl, dl, tl, fn)
        return occ

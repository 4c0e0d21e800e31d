#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --profile  # every phase, plus a torch.profiler
                                     # trace of one pass of each render
    python3 chip_smoke.py --upto 3   # stop after phase 3 (no result line)

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/mt.cu, csrc/front.cu and csrc/wave.cu with nvcc and the
     native BVH builder csrc/bvh_builder.cpp with g++, all started
     together; the ptxas report, and the instructions of the MT kernels'
     inner loops as compiled (cuobjdump -sass);
  3. kernel parity on the card, each kernel against its plain PyTorch
     version on 65,536 seeded rays: mt_closest and mt_anyhit on
     cornell_box and multi_bsdf_scene, also on 1 and 31 rays, on 262,144
     (multi_bsdf_scene) and on 4,096 that start on a cornell_box triangle
     (a winning -0.0 is stored as +0.0), each walking the table's live
     columns as the brute tracer does, and on 65,536 rays also the whole
     table: t and tri equal to the bit, u
     and v within 1e-6, occlusion equal; front_full and front_slab_extract on the
     tables of the full-size terrain_scene and of multi_bsdf_scene, both
     with NaN rows, t_limit mixed (T_MAX, short, 0): every packed key
     equal bit for bit; row_gather (direct and staged) against indexing
     at the TPU probe's geometry (K 10,987, R 4,096) and on the terrain's
     row table with repeated and boundary indices; wave_mt against
     wave_mt_plain on both scenes' front tables (W = 1 and W = 4, closest
     and any-hit, dead rays, dead columns with out-of-range ids) and
     wave_sweep against wave_sweep_plain on 300 rays, and both on rays
     that start on a triangle (a winning t of -0.0 is stored as +0.0):
     t, cluster and lane equal bit for bit;
  4. tracer against oracle: intersect_clusters / occluded_clusters on the
     full-size terrain_scene against mt_closest / mt_anyhit over all its
     triangles, 65,536 camera and random rays: occlusion equal, tri equal
     but for rays whose two t are bit-equal (exact ties, counted);
  5. main path, through Renderer(..., device="cuda"): cornell_box
     256x256 and multi_bsdf_scene 512x512 with the brute tracer (as
     before), then terrain_scene 256x256 with use_bvh=True (hierarchical
     front table, front_full, wave_mt, wave_sweep), a short terrain
     render with tracer_tune={"sc_topk": "pallas"} (front_slab_extract),
     and multi_bsdf_scene 512x512 with use_bvh=True (dense front table,
     wave_mt), whose film is held against the brute film; last the
     row-gather probe through its entry point
     (tools/row_gather_probe.py: row_gather, both variants). Films are
     checked; the launch counts are zeroed before each run and read
     after it; every BVH render must take fewer host syncs than waves;
     prints wall seconds and rays/s, rays counted as W*H*spp*depth*2 as
     in bench.py;
  6. the whole path with the kernels against the whole path with their
     plain versions, both on the card: cornell_box 64x64 (MT kernels),
     terrain_scene 256x256 and multi_bsdf_scene 512x512 with the BVH
     (front and wave kernels against plain=True), films equal to rtol
     1e-5;
  7. kernel timing with CUDA events, beside each kernel's bound and its
     plain version's time: the MT kernels at 65,536 rays on both scenes
     and 262,144 on multi_bsdf_scene, beside the issue floor (the inner
     loop's instructions a test x tests / 32 over 4 warp-instructions a
     clock on every SM, at the SM clock nvidia-smi reads under load),
     both counting the tests over the columns that hold a triangle;
     the front kernels at 65,536 rays;
     row_gather at the probe's geometry (both variants, also as ns per
     row and GB/s, beside index_select); wave_mt on the terrain's first
     and eighth wave of 65,536 rays; wave_sweep at 8 rays x all clusters.

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_RAYS = 65536
BIG_RAYS = 262144        # the multi_bsdf_scene brute render's rays per trace
H100_FP32_OPS = 67e12    # FP32 operations/s outside the tensor cores (H100 SXM, at 700 W)
H100_BYTES = 3.35e12     # HBM bytes/s (H100 SXM)
MT_OPS_PER_TEST = 46     # FP32 arithmetic of one ray-triangle test (csrc/mt.cu mt_test)
SLAB_OPS = 28            # FP32 arithmetic of one slab test (csrc/front.cu: 3 axes x
                         # (2 sub, 2 mul, 2 min, 2 max), the clamp, 3 compares)
T_MAX = 3.4e38


class PhaseError(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseError(what)


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def device_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def build_all(mods):
    """Phase 2: every library of the port, the compilers started together."""
    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {name: pool.submit(timed, mod) for name, mod in mods.items()}
        secs = {name: f.result() for name, f in futures.items()}
    print(f"built into {mods['mt'].BUILD_DIR} in {time.perf_counter() - t0:.2f} s "
          + " ".join(f"{k} {v:.2f} s" for k, v in secs.items()), flush=True)
    for name in ("mt", "front", "wave"):
        for line in mods[name].build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  " + line.strip(), flush=True)


def random_rays(seed, n, device):
    """Origins inside the unit box, random directions, tmax in [0, 3) with
    every 7th bound 0 (the masked shadow rays of the integrator)."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rs.uniform(0.0, 3.0, size=n).astype(np.float32)
    tmax[::7] = 0.0
    return tuple(torch.from_numpy(x).to(device) for x in (p, d, tmax))


def terrain_rays(seed, n, scene, device):
    """Half camera rays of the scene (random pixels, jittered), half random
    rays with origins in the terrain's box. Returns p, d."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params, generate_rays

    rs = np.random.RandomState(seed)
    cam = scene.camera
    m = n // 2
    px = torch.from_numpy(rs.randint(0, cam.width, size=m)).to(device)
    py = torch.from_numpy(rs.randint(0, cam.height, size=m)).to(device)
    film_u = torch.from_numpy(rs.uniform(size=(m, 2)).astype(np.float32)).to(device)
    lens_u = torch.from_numpy(rs.uniform(size=(m, 2)).astype(np.float32)).to(device)
    cp, cd = generate_rays(camera_to_params(cam, device), px, py, film_u, lens_u)
    p = rs.uniform([-4.0, -1.6, -4.0], [4.0, 1.5, 4.0], size=(n - m, 3)).astype(np.float32)
    d = rs.normal(size=(n - m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = torch.cat([cp, torch.from_numpy(p).to(device)]).contiguous()
    d = torch.cat([cd, torch.from_numpy(d).to(device)]).contiguous()
    return p, d


def mixed_limits(seed, n, device):
    """t_limit by thirds: T_MAX (a closest-hit ray), a short bound (a
    shadow ray), 0 (a masked ray)."""
    rs = np.random.RandomState(seed)
    t = rs.uniform(0.05, 3.0, size=n).astype(np.float32)
    t[0::3] = T_MAX
    t[2::3] = 0.0
    return torch.from_numpy(t).to(device)


def on_triangles(table, num, n, seed, dev):
    """n rays that start at the centroid of a triangle (the table's num
    triangles in turn), random directions. On an axis-aligned triangle the
    test gives t = +0.0 or -0.0 by the determinant's sign, and the ray
    wins there at t = 0."""
    cols = torch.arange(n, device=dev) % num
    a, e0, e1 = (table[r : r + 3, cols].T for r in (0, 3, 6))
    return (a + (e0 + e1) / 3).contiguous(), random_rays(seed, n, dev)[1]


def mt_parity(mt, scenes, dev):
    """Each MT kernel against its plain version on the same card inputs:
    65,536 random rays on both scenes, then 1 and 31 (a ragged tile),
    262,144 on multi_bsdf_scene and 4,096 that start on a cornell_box
    triangle. Each walks the table's live columns, as the brute tracer
    does; on the 65,536 rays also the whole table, which must change
    nothing. t and tri equal to the bit, u and v within 1e-6, occlusion
    equal. Returns the largest absolute differences seen per kernel."""
    err = {"mt_closest": 0.0, "mt_anyhit": 0.0}
    cases = []
    for seed, name in enumerate(("cornell_box", "multi_bsdf_scene")):
        data = getattr(scenes, name)(8, 8).build(device=dev)
        table = mt.tri_table(data)
        p, d, tmax = random_rays(seed, N_RAYS, dev)
        cases.append((name, data.num_tris, table, p, d, tmax))
        cases.append((f"{name} whole table", data.num_tris, table, p, d, tmax))
        for n in (1, 31):
            cases.append((name, data.num_tris, table, p[:n].contiguous(), d[:n].contiguous(),
                          tmax[:n].contiguous()))
        if name == "multi_bsdf_scene":
            cases.append((name, data.num_tris, table, *random_rays(9, BIG_RAYS, dev)))
        else:
            p0, d0 = on_triangles(table, data.num_tris, 4096, 8, dev)
            cases.append((f"{name} origins on triangles", data.num_tris, table, p0, d0,
                          random_rays(8, 4096, dev)[2]))
    for name, num_tris, table, p, d, tmax in cases:
        n = p.shape[0]
        cols = table.shape[1] if "whole table" in name else mt.live_columns(table)
        check(cols >= num_tris, f"{name}: {cols} live columns for {num_tris} triangles")
        t, tri, u, v = mt.mt_closest(table, p, d, cols=cols)
        pt, ptri, pu, pv = mt.mt_closest_plain(table, p, d)
        torch.cuda.synchronize()
        hit = ptri >= 0
        bad_tri = int((tri != ptri).sum())
        bad_t = int((bits(t) != bits(pt)).sum())
        duv = max([float((u - pu)[hit].abs().max()), float((v - pv)[hit].abs().max())]
                  if bool(hit.any()) else [0.0])
        dt = float((t - pt)[hit].abs().max()) if bool(hit.any()) else 0.0
        occ = mt.mt_anyhit(table, p, d, tmax, cols=cols)
        pocc = mt.mt_anyhit_plain(table, p, d, tmax)
        bad_occ = int((occ != pocc).sum())
        zero = pt == 0
        print(f"{name}: {num_tris} tris ({cols} columns walked), {n} rays, {int(hit.sum())} "
              f"hits ({int(zero.sum())} at t = 0), {int(pocc.sum())} occluded; mismatches tri "
              f"{bad_tri} t {bad_t} occ {bad_occ}; max |du|,|dv| {duv:.3g}", flush=True)
        check(bad_tri == 0 and bad_t == 0, f"mt_closest disagrees with its plain version on {name}")
        check(duv <= 1e-6, f"mt_closest u/v off by {duv} on {name}")
        check(bad_occ == 0, f"mt_anyhit disagrees with its plain version on {name}")
        check(bool((bits(t)[zero] == 0).all()), f"mt_closest stores a t of -0.0 on {name}")
        if "origins on triangles" in name:
            check(int(zero.sum()) > n // 10, f"{name}: too few rays win at t = 0 to test it")
        err["mt_closest"] = max(err["mt_closest"], dt, duv)
        err["mt_anyhit"] = max(err["mt_anyhit"], float(bad_occ > 0))  # |1 - 0| on a mismatch
    return err


def front_args(bvh, p, d, tlim):
    """The arguments of the front kernels for one BVH and ray set."""
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct

    jj = min(ct.SC_FRONT, bvh["sc_bmin"].shape[0])
    slab = (bvh["sc_bmin"], bvh["sc_bmax"], p, d, tlim, jj)
    full = (bvh["sc_bmin"], bvh["sc_bmax"], bvh["sc_member_bmin"], bvh["sc_member_bmax"],
            p, d, tlim, jj)
    return slab, full, jj


def front_parity(front, cases):
    """Both front kernels against their plain versions: every packed key
    bit for bit. cases: (name, bvh, p, d, tlim). Returns the largest
    absolute key difference per kernel (0 when they agree)."""
    err = {"front_full": 0.0, "front_slab_extract": 0.0}
    for name, bvh, p, d, tlim in cases:
        slab, full, jj = front_args(bvh, p, d, tlim)
        nan_rows = int(torch.isnan(bvh["sc_member_bmin"]).any(dim=-1).sum())
        check(nan_rows > 0, f"{name}: the member table has no NaN row to test the NaN rule on")
        pk, ck = front.front_full(*full)
        ppk, pck = front.front_full_plain(*full)
        sk = front.front_slab_extract(*slab)
        psk = front.front_slab_extract_plain(*slab)
        torch.cuda.synchronize()
        bad_full = int((pk != ppk).sum()) + int((ck != pck).sum())
        bad_slab = int((sk != psk).sum())
        nbits = front.key_bits(ck.shape[1])
        pending = int(((ck & -(1 << nbits)) < front.tmax_key(nbits)).sum())
        k2, sc = bvh["sc_member_bmin"].shape[:2]
        print(f"{name}: K2 {k2}, jj {jj}, SC {sc}, {nan_rows} NaN member rows, {p.shape[0]} rays, "
              f"{pending} pending candidates; mismatched keys front_full {bad_full} of "
              f"{pk.numel() + ck.numel()}, front_slab_extract {bad_slab} of {sk.numel()}",
              flush=True)
        check(bad_full == 0, f"front_full disagrees with its plain version on {name}")
        check(bad_slab == 0, f"front_slab_extract disagrees with its plain version on {name}")
        check(torch.equal(sk, pk), f"{name}: the two kernels' parent keys differ")
        err["front_full"] = max(err["front_full"], float((pk.long() - ppk.long()).abs().max()),
                                float((ck.long() - pck.long()).abs().max()))
        err["front_slab_extract"] = max(err["front_slab_extract"],
                                        float((sk.long() - psk.long()).abs().max()))
    return err


def bits(x):
    """A float32 tensor as its int32 bits, for comparisons to the bit."""
    return x.contiguous().view(torch.int32)


def fresh_state(best_t):
    """The tracer's state before its first wave: best t as given, no
    cluster (-1), lane 0."""
    n, dev = best_t.shape[0], best_t.device
    return [best_t.clone(), torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev)]


def front_table(ct, data, p, d, tlim):
    """The front table (ttbl, ctbl) the tracer makes for these rays."""
    bvh = data.bvh
    k = bvh["cluster_rows"].shape[0]
    kk = min(ct.MAX_FRONT, k)
    if k > ct.DENSE_K and "sc_bmin" in bvh:
        ttbl, ctbl, _ = ct._front_table_hierarchical(p, d, bvh, tlim, kk)
    else:
        ttbl, ctbl, _ = ct._front_table_dense(p, d, bvh, tlim, kk)
    return ttbl, ctbl


def wave_parity(wave, ct, probe, cases, dev):
    """The three wave kernels against their plain versions, bit for bit.
    cases: (name, scene data with its BVH, p, d, tlim). Returns the
    largest absolute difference per kernel (0 when they agree)."""
    err = {"row_gather": 0.0, "wave_mt": 0.0, "wave_sweep": 0.0}

    # row_gather: the probe's table and indices, then the terrain's own
    # table with repeated and boundary indices
    gathers = [("probe geometry", *probe.inputs(dev))]
    table = cases[0][1].bvh["cluster_rows"]
    k = table.shape[0]
    rs = np.random.RandomState(21)
    idx = rs.randint(0, k, size=4099).astype(np.int32)
    idx[:64] = idx[64]          # one row 65 times
    idx[100:104] = (0, k - 1, 0, k - 1)
    gathers.append((f"{cases[0][0]} rows", torch.from_numpy(idx).to(dev), table))
    for label, idx, table in gathers:
        want = table[idx.long()]
        for variant in wave.VARIANTS:
            got = wave.row_gather(idx, table, variant)
            torch.cuda.synchronize()
            bad = int((bits(got) != bits(want)).sum())
            print(f"row_gather {variant} on {label}: K {table.shape[0]}, R {idx.shape[0]}, "
                  f"mismatched words {bad} of {want.numel()}", flush=True)
            check(bad == 0, f"row_gather {variant} differs from indexing on {label}")
            err["row_gather"] = max(err["row_gather"], float((got - want).abs().max()))

    def agree(kname, label, got, want):
        bad = [int((bits(g) != bits(w)).sum()) if g.dtype == torch.float32
               else int((g != w).sum()) for g, w in zip(got, want)]
        hits = int((want[1] >= 0).sum())
        print(f"{kname} {label}: {hits} rays hold a hit; mismatches t {bad[0]} cluster "
              f"{bad[1]} lane {bad[2]}", flush=True)
        check(sum(bad) == 0, f"{kname} disagrees with its plain version on {label}")
        err[kname] = max(err[kname], float((got[0] - want[0]).abs().max()))
        return hits

    # rays that start ON a triangle (the first vertex of lane 0 of their
    # cluster): t is +0.0 or -0.0 by the determinant's sign, and both the
    # kernels and the plain versions store +0.0
    table = cases[0][1].bvh["cluster_rows"]
    n0 = 4096
    cid = torch.arange(n0, dtype=torch.int32, device=dev) % table.shape[0]
    p0 = table[cid.long(), 0:3, 0].contiguous()
    d0 = random_rays(23, n0, dev)[1]
    far = torch.full((n0,), T_MAX, dtype=torch.float32, device=dev)
    for kname, run in (
        ("wave_mt", lambda fn, st: fn(p0, d0, table, torch.zeros_like(far)[:, None],
                                      cid[:, None], False, *st)),
        ("wave_sweep", lambda fn, st: fn(p0, d0, table, cid[:300], *st)),  # rays 0..299
    ):
        states = []
        for fn in (getattr(wave, kname), getattr(wave, kname + "_plain")):
            states.append(fresh_state(far))
            run(fn, states[-1])
        torch.cuda.synchronize()
        zero = states[1][0] == 0
        print(f"{kname}, origins on a triangle: {int(zero.sum())} rays win at t = 0", flush=True)
        agree(kname, f"on {cases[0][0]}, {n0} origins on a triangle", *states)
        check(int(zero.sum()) > n0 // 100, f"{kname}: no ray wins at t = 0, no test")
        check(bool((bits(states[0][0])[zero] == 0).all()), f"{kname} stores a t of -0.0")

    for name, data, p, d, tlim in cases:
        table = data.bvh["cluster_rows"]
        k = table.shape[0]
        n = p.shape[0]
        ttbl, ctbl = front_table(ct, data, p, d, tlim)
        for any_hit in (False, True):
            for lo, hi in ((0, 1), (0, 4), (5, 6)):
                # the table's own column range (row stride kk), and for the
                # any-hit runs a copy whose every fifth ray has only dead
                # columns, their ids out of range
                col_t, col_c = ttbl[:, lo:hi], ctbl[:, lo:hi]
                if any_hit:
                    col_t, col_c = col_t.clone(), col_c.clone()
                    col_t[::5] = T_MAX
                    col_c[::5] = k + 100
                    col_c[::10] = -7
                states = []
                for fn in (wave.wave_mt, wave.wave_mt_plain):
                    state = fresh_state(tlim)
                    if any_hit:
                        state[1][1::4] = 3  # rays that already hold a hit
                    fn(p, d, table, col_t, col_c, any_hit, *state)
                    states.append(state)
                torch.cuda.synchronize()
                label = (f"on {name}, columns [{lo}, {hi}), "
                         f"{'any-hit' if any_hit else 'closest'}")
                hits = agree("wave_mt", label, *states)
                check(0 < hits < n, f"wave_mt {label}: {hits} of {n} rays hit, no test")
        idx = torch.from_numpy(np.random.RandomState(22).permutation(n)[:300].astype(np.int32)).to(dev)
        states = []
        for fn in (wave.wave_sweep, wave.wave_sweep_plain):
            state = fresh_state(tlim)
            fn(p, d, table, idx, *state)
            states.append(state)
        torch.cuda.synchronize()
        hits = agree("wave_sweep", f"on {name}, 300 rays x {k} clusters", *states)
        check(0 < hits <= 300, f"wave_sweep on {name}: {hits} rays hit, no test")
    return err


def tracer_vs_oracle(mt, ct, terrain, data, dev):
    """Phase 4: the cluster tracer on the full-size terrain against the
    brute kernels over all its triangles."""
    p, d = terrain_rays(11, N_RAYS, terrain, dev)
    tmax = mixed_limits(12, N_RAYS, dev)
    tmax[0::3] = 1e-6  # the integrator's dead lanes
    table = mt.tri_table(data)
    for k in ct.STATS:
        ct.STATS[k] = 0
    got = ct.intersect_clusters(data, p, d)
    occ = ct.occluded_clusters(data, p, d, tmax)
    torch.cuda.synchronize()
    counts = dict(ct.STATS)
    t, tri, _, _ = mt.mt_closest(table, p, d)
    oref = mt.mt_anyhit(table, p, d, tmax)
    diff = got["tri"] != tri
    ties = diff & (got["t"] == t)
    bad = int((diff & ~ties).sum())
    bad_t = int((got["t"] != t).sum())
    bad_occ = int((occ != oref).sum())
    share = counts["fallback_rays"] / counts["rays"]
    print(f"terrain_scene: {data.num_tris} tris, {N_RAYS} rays, {int((tri >= 0).sum())} hits, "
          f"{int(oref.sum())} occluded; tri differs on {int(diff.sum())} rays, of which exact-t "
          f"ties {int(ties.sum())}, other {bad}; t differs on {bad_t}; occlusion differs on "
          f"{bad_occ}; exact-fallback rays {counts['fallback_rays']} of {counts['rays']} "
          f"(share {share:.6f}); {counts['waves']} waves and {counts['syncs']} host syncs in "
          f"{counts['traces']} traces", flush=True)
    check(bad == 0, f"the cluster tracer names another triangle than the oracle on {bad} rays")
    check(bad_t == 0, f"the cluster tracer's t differs from the oracle's on {bad_t} rays")
    check(bad_occ == 0, f"occluded_clusters disagrees with mt_anyhit on {bad_occ} rays")
    check(int(ties.sum()) <= N_RAYS // 1000, f"{int(ties.sum())} exact-t ties: too many to be ties")
    return int(ties.sum()), share


def box_film_checks(film, name):
    c = film["color"]
    h, w, _ = c.shape
    check(np.isfinite(c).all(), f"{name}: film not finite")
    check(c.mean() > 0, f"{name}: film is black")
    band = c[h // 4 : 3 * h // 4]
    left, right = band[:, : w // 10].mean(axis=(0, 1)), band[:, -w // 10 :].mean(axis=(0, 1))
    check(left[0] - left[1] > right[0] - right[1], f"{name}: left wall not redder {left} {right}")
    check(right[1] > left[1], f"{name}: right wall not greener {left} {right}")
    top, bottom = c[: h // 8].mean(), c[-h // 8 :].mean()
    check(top > bottom, f"{name}: top {top} not brighter than bottom {bottom}")
    return f"mean {c.mean():.6f} left {left.round(4)} right {right.round(4)} top {top:.4f} bottom {bottom:.4f}"


def terrain_film_checks(film, name, env):
    """Finite, lit, and every pixel whose samples all left the scene at
    once (alpha 0) shows the environment: colour x power. A pixel's value
    is a float32 sum of spp equal terms over spp, hence rtol 1e-6."""
    c, alpha = film["color"], film["alpha"]
    check(np.isfinite(c).all(), f"{name}: film not finite")
    sky = alpha == 0.0
    check(sky.any() and (alpha == 1.0).any(), f"{name}: no sky or no ground in view")
    check(np.allclose(c[sky], env[None, :], rtol=1e-6, atol=0.0),
          f"{name}: sky pixels differ from the environment {env}")
    ground = c[alpha == 1.0]
    check(ground.mean() > 0, f"{name}: the terrain is black")
    return (f"mean {c.mean():.6f}, sky pixels {int(sky.sum())} = {env.round(4)}, "
            f"ground pixels {len(ground)} mean {ground.mean():.6f}")


def zero_counts(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def main_path(mt, front, wave, ct, probe, pt, scenes, dev):
    """Phase 5: the full-size renders through the Renderer entry point,
    then the row-gather probe through its own. Returns the launch counts
    summed over them."""
    from phosphorus_mk2_tpu_torch.integrator.path import make_scene_tables

    brute = dict(samples_per_pixel=16, samples_per_pass=4)
    configs = [
        # (label, scene, w, h, options, kernels that must launch)
        ("cornell_box brute", "cornell_box", 256, 256,
         dict(use_bvh=False, use_pallas=True, path_depth=4, **brute),
         ("mt_closest", "mt_anyhit")),
        ("multi_bsdf_scene brute", "multi_bsdf_scene", 512, 512,
         dict(use_bvh=False, path_depth=9, **brute), ("mt_closest", "mt_anyhit")),
        ("terrain_scene bvh", "terrain_scene", 256, 256,
         dict(use_bvh=True, path_depth=4, **brute), ("front_full", "wave_mt", "wave_sweep")),
        ("terrain_scene bvh sc_topk=pallas", "terrain_scene", 256, 256,
         dict(use_bvh=True, path_depth=2, samples_per_pixel=2, samples_per_pass=2,
              tracer_tune={"sc_topk": "pallas"}), ("front_slab_extract", "wave_mt")),
        ("multi_bsdf_scene bvh", "multi_bsdf_scene", 512, 512,
         dict(use_bvh=True, path_depth=9, **brute), ("wave_mt",)),
    ]
    totals = {k: 0 for k in (*mt.LAUNCHES, *front.LAUNCHES, *wave.LAUNCHES)}
    per_render, films = [], {}
    for label, name, w, h, kw, expect in configs:
        opts = pt.Options(**kw)
        scene = getattr(scenes, name)(width=w, height=h)
        t0 = time.perf_counter()
        r = pt.Renderer(scene, opts, device="cuda")
        setup = time.perf_counter() - t0
        r.render()  # warm-up: allocator and first launches, not timed
        torch.cuda.synchronize()
        zero_counts(mt, front, wave)
        for k in ct.STATS:
            ct.STATS[k] = 0
        t0 = time.perf_counter()
        film = r.render()  # returns host arrays: the device work is done
        secs = time.perf_counter() - t0
        counts = {**mt.LAUNCHES, **front.LAUNCHES, **wave.LAUNCHES}
        traced = dict(ct.STATS)
        for k in expect:
            check(counts[k] > 0, f"{label}: kernel {k} was not launched on the main path")
        for k in counts:
            totals[k] += counts[k]
        rays = w * h * opts.samples_per_pixel * opts.path_depth * 2
        passes = math.ceil(opts.samples_per_pixel / opts.samples_per_pass)
        if name == "terrain_scene":
            env = r.data.emission[r.data.env_mat].cpu().numpy()
            stats = terrain_film_checks(film, label, env)
            bvh = r.data.bvh
            k, k2 = bvh["cluster_bmin"].shape[0], bvh["sc_bmin"].shape[0]
            tables = make_scene_tables(r.data)
            row_bytes = sum(tables[t].numel() * tables[t].element_size() for t in ("hit_f", "hit_i"))
            stats += (f"; {r.data.num_tris} triangles, K {k} clusters, K2 {k2} superclusters, "
                      f"hit rows {tuple(tables['hit_f'].shape)} {row_bytes} bytes")
            check(k > 2048, f"{label}: K = {k} clusters do not take the hierarchical front table")
        else:
            stats = box_film_checks(film, label)
        if opts.use_bvh:
            stats += (f"; {traced['traces']} traces, {traced['waves']} waves, {traced['syncs']} "
                      f"host syncs, {traced['fallback_rays']} exact-fallback rays")
            check(traced["syncs"] < traced["waves"],
                  f"{label}: {traced['syncs']} host syncs for {traced['waves']} waves")
        films[label] = film["color"]
        print(f"{label} {w}x{h} spp {opts.samples_per_pixel} depth {opts.path_depth}: "
              f"{secs:.6f} s, {rays / secs:.1f} rays/s ({rays / secs / 1e6:.4f} Mrays/s); "
              f"set-up {setup:.3f} s; launches {counts} over {passes} passes; {stats}",
              flush=True)
        per_render.append({"render": label, "width": w, "height": h, "seconds": secs,
                           "rays_per_s": rays / secs, "setup_seconds": setup,
                           "launches": counts, "passes": passes, "traced": traced})
    # the dense-front cluster tracer against the brute tracer, whole films:
    # both find the same triangles but for exact-t ties, and a tie changes
    # one path's whole contribution
    a, b = films["multi_bsdf_scene bvh"], films["multi_bsdf_scene brute"]
    close = np.isclose(a, b, rtol=1e-5, atol=1e-7).all(axis=-1).mean()
    print(f"multi_bsdf_scene bvh vs brute film: max |diff| {np.abs(a - b).max():.3g}, "
          f"pixels within rtol 1e-5 {close:.6f}, means {a.mean():.6f} {b.mean():.6f}", flush=True)
    check(close >= 0.999, f"multi_bsdf_scene: only {close} of the bvh film's pixels match brute")
    check(np.isclose(a.mean(), b.mean(), rtol=1e-4), "multi_bsdf_scene: film means differ")
    # the row-gather probe, as its command line runs it
    zero_counts(mt, front, wave)
    probed = [probe.probe(variant, device="cuda") for variant in wave.VARIANTS]
    check(wave.LAUNCHES["row_gather"] > 0, "the probe did not launch row_gather")
    totals["row_gather"] += wave.LAUNCHES["row_gather"]
    idx, table = probe.inputs("cpu")
    want = float(table[idx.long(), 0].double().sum())  # float64 sums: order-safe to 1e-12
    for res in probed:
        print(f"row_gather_probe {json.dumps(res)}", flush=True)
        check(math.isclose(res["checksum"], want, rel_tol=1e-12),
              f"the probe's checksum {res['checksum']} is not {want}")
    per_render.append({"render": "row_gather_probe", "launches": dict(wave.LAUNCHES),
                       "variants": probed})
    print(json.dumps({"main_path": per_render}), flush=True)
    return totals


def whole_path_vs_plain(mt, pt, scenes, dev):
    """Phase 6: the same render with the kernels and with their plain versions."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import render_pass

    scene = scenes.cornell_box(64, 64)
    data = scene.build(device=dev)
    cam = camera_to_params(scene.camera, dev)
    table = mt.tri_table(data)
    films = []
    for plain in (False, True):
        out = render_pass(data, cam, 0, 0, 4, width=64, height=64, max_depth=4,
                          tracer=mt.brute_tracer(table, plain=plain), film_strata=2)
        films.append(out["color"].cpu().numpy())
    diff = float(np.abs(films[0] - films[1]).max())
    print(f"cornell_box 64x64 4 spp depth 4: kernel vs plain film max |diff| {diff:.3g}, "
          f"mean {films[0].mean() / 4:.6f}", flush=True)
    check(np.allclose(films[0], films[1], rtol=1e-5, atol=0.0),
          f"kernel path film differs from the plain path film by {diff}")

    for name, w, h, depth in (("terrain_scene", 256, 256, 4), ("multi_bsdf_scene", 512, 512, 9)):
        films = []
        for tune in (None, {"plain": True}):
            opts = pt.Options(use_bvh=True, samples_per_pixel=2, samples_per_pass=2,
                              path_depth=depth, tracer_tune=tune)
            films.append(pt.Renderer(getattr(scenes, name)(width=w, height=h), opts,
                                     device="cuda").render()["color"])
        diff = float(np.abs(films[0] - films[1]).max())
        print(f"{name} {w}x{h} 2 spp depth {depth} use_bvh=True: front and wave kernels vs "
              f"plain=True film max |diff| {diff:.3g}, mean {films[0].mean():.6f}", flush=True)
        check(np.allclose(films[0], films[1], rtol=1e-5, atol=0.0),
              f"{name}: the kernels' film differs from the plain=True film by {diff}")


def device_events(fn):
    """Run fn under torch.profiler; returns (wall seconds, device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_traces(ct, data, p, d, tmax):
    """--profile: one closest-hit and one any-hit trace of 65,536 rays on
    the full-size terrain under torch.profiler: device launches, waves,
    host syncs, wall and device time of each."""
    for label, fn in (("intersect_clusters", lambda: ct.intersect_clusters(data, p, d)),
                      ("occluded_clusters", lambda: ct.occluded_clusters(data, p, d, tmax))):
        fn()
        torch.cuda.synchronize()
        for k in ct.STATS:
            ct.STATS[k] = 0
        wall, kernels = device_events(fn)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        s = ct.STATS
        print(f"profile {label} terrain_scene {p.shape[0]} rays: wall {wall:.6f} s, "
              f"{len(kernels)} device launches, device busy {busy:.6f} s, {s['waves']} waves, "
              f"{s['syncs']} host syncs, {s['fallback_rays']} exact-fallback rays", flush=True)


def profile_render(pt, ct, scenes):
    """--profile: one 4-spp pass of each main-path render under
    torch.profiler. Prints the device's busy and idle share over the span
    of its kernels, the kernel count, the kernels that take the most
    device time and, for the cluster tracer, waves and host syncs per
    trace."""
    for name, w, h, depth, bvh, wavefront in (
            ("cornell_box", 256, 256, 4, False, 0), ("multi_bsdf_scene", 512, 512, 9, False, 0),
            ("terrain_scene", 256, 256, 4, True, 0), ("multi_bsdf_scene", 512, 512, 9, True, 0),
            # the brute tracer's wavefront for the cluster tracer: one chunk a pass, not 8
            ("multi_bsdf_scene", 512, 512, 9, True, 1 << 20)):
        opts = pt.Options(use_bvh=bvh, samples_per_pixel=4, samples_per_pass=4,
                          path_depth=depth, max_wavefront=wavefront)
        r = pt.Renderer(getattr(scenes, name)(width=w, height=h), opts, device="cuda")
        r.render()
        torch.cuda.synchronize()
        for k in ct.STATS:
            ct.STATS[k] = 0
        wall, kernels = device_events(r.render)
        tag = (f"profile {name} {w}x{h} 4 spp depth {depth} use_bvh={bvh}"
               + (f" max_wavefront={wavefront}" if wavefront else ""))
        if bvh:
            s = ct.STATS
            tr = max(s["traces"], 1)
            print(f"{tag}: {s['traces']} traces of {s['rays'] / tr:.0f} rays, per trace "
                  f"{s['waves'] / tr:.2f} waves, {s['syncs'] / tr:.2f} host syncs, "
                  f"{s['fallback_rays'] / tr:.1f} exact-fallback rays")
        if not kernels:
            print(f"{tag}: no device events traced (wall {wall:.6f} s); device time not measured")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels)) / 1e6
        by_name = {}
        for e in kernels:
            n, s = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, s + e.time_range.elapsed_us() / 1e6)
        print(f"{tag}: wall {wall:.6f} s, "
              f"{len(kernels)} kernels, device busy {busy:.6f} s over a span of {span:.6f} s "
              f"(idle share {1 - busy / span:.4f} of the span, {1 - busy / wall:.4f} of the wall)")
        for kname, (n, s) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {s:.6f} s {100 * s / busy:6.2f}% {n:6d}x  {kname[:110]}")


def anyhit_tests_needed(mt, table, p, d, tmax):
    """Ray-triangle tests the any-hit function needs on these rays: every
    triangle (id >= 0) up to and including the first occluding column,
    all of them for a ray never occluded, none for tmax <= 0. A pad
    column is settled by its id and needs no test."""
    from phosphorus_mk2_tpu_torch.accel.intersect import mt_intersect_soa

    n, tp = p.shape[0], table.shape[1]
    tris_upto = torch.cumsum((table[9].view(torch.int32) >= 0).long(), 0)  # through column c
    total = 0
    for r0 in range(0, n, N_RAYS):  # rays in slices: (rays, 512) temporaries
        sp, sd, tm = p[r0 : r0 + N_RAYS], d[r0 : r0 + N_RAYS], tmax[r0 : r0 + N_RAYS]
        first = torch.full((sp.shape[0],), tp, dtype=torch.int64, device=p.device)
        rp = (sp[:, 0:1], sp[:, 1:2], sp[:, 2:3])
        rd = (sd[:, 0:1], sd[:, 1:2], sd[:, 2:3])
        for base in range(tp - mt.TRI_TILE, -1, -mt.TRI_TILE):
            rows = table[:, base : base + mt.TRI_TILE]
            t, _, _, ok = mt_intersect_soa(rp, rd, tuple(rows[0:3, None]),
                                           tuple(rows[3:6, None]), tuple(rows[6:9, None]))
            ok = ok & (t < tm[:, None]) & (rows[9].view(torch.int32) >= 0)[None, :]
            col = torch.where(ok, torch.arange(mt.TRI_TILE, device=p.device)[None, :],
                              mt.TRI_TILE)
            c = col.min(dim=1).values
            first = torch.where(c < mt.TRI_TILE, base + c, first)
        needed = torch.where(first < tp, tris_upto[first.clamp(max=tp - 1)], tris_upto[-1])
        total += int(torch.where(tm > 0, needed, 0).sum())
    return total


def sass_loops(mt):
    """Phase 2: the MT kernels' inner loops as compiled, from cuobjdump
    -sass of the built library; {} where the toolkit has no cuobjdump."""
    from phosphorus_mk2_tpu_torch.accel.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("sass: no cuobjdump beside nvcc; instructions a test not measured", flush=True)
        return {}
    sass = subprocess.run([tool, "-sass", mt.build()._name], capture_output=True, text=True,
                          timeout=120).stdout
    out = loop_counts(sass, mt.CLOSEST_RAYS)
    for kname, c in out.items():
        print(f"sass {kname}: inner loop {c['loop_instructions']} instructions for {c['tests']} "
              f"tests, {c['per_test']:.2f} a test ({c['fp32']} FP32/MUFU, {c['lds']} LDS)",
              flush=True)
    return out


def loop_counts(sass, closest_rays):
    """Instructions of each MT kernel's innermost loop that holds the
    division (MUFU.RCP): mt_closest's column step (4 columns x
    closest_rays rays) and mt_anyhit's ray step (4 columns a lane).
    Static counts: the division's rare slow path lies outside the loop."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for kname, tests in (("mt_closest_kernel", 4 * closest_rays), ("mt_anyhit_kernel", 4)):
        ins = next((v for k, v in funcs.items() if kname in k), [])
        loops = []
        for addr, text in ins:  # a loop: a branch back to a lower address
            m = re.search(r"BRA\S*\s+(?:\S+,\s*)?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= addr:
                body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                if any("MUFU.RCP" in t for t in body):
                    loops.append(body)
        if not loops:
            continue
        body = min(loops, key=len)
        ops = [t.split()[1] if t.startswith("@") else t.split()[0] for t in body]
        out[kname] = {"loop_instructions": len(body), "tests": tests,
                      "per_test": len(body) / tests,
                      "fp32": sum(o.startswith(("F", "MUFU")) for o in ops),
                      "lds": sum(o.startswith("LDS") for o in ops)}
    return out


def sm_clock_under(fn, ms):
    """(SM clock, its maximum) in MHz as nvidia-smi reads them while fn
    runs back to back for about half a second."""
    for _ in range(max(1, int(500 / max(ms, 1e-3)))):
        fn()
    q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       timeout=60)
    torch.cuda.synchronize()
    try:
        return tuple(float(x) for x in q.stdout.strip().splitlines()[0].split(","))
    except (IndexError, ValueError):
        return None, None


def mt_timing(mt, scenes, dev, launches, errs, sass):
    """Phase 7, MT kernels: ms per launch at the main path's shapes (65,536
    rays against the cornell_box table, the headline; 65,536 and 262,144
    against multi_bsdf_scene's), the bound, the issue floor (instructions
    a test as compiled x tests / 32 over 4 warp-instructions a clock on
    every SM, at the SM clock read under load) and the plain ms. Tests
    count the triangles only: a pad column (id -1) is settled by its id.
    The kernels are given the live columns, as the brute tracer gives
    them."""
    from phosphorus_mk2_tpu_torch.tools.row_gather_probe import launch_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = None
    out = []
    for name, n in (("cornell_box", N_RAYS), ("multi_bsdf_scene", N_RAYS),
                    ("multi_bsdf_scene", BIG_RAYS)):
        data = getattr(scenes, name)(8, 8).build(device=dev)
        table = mt.tri_table(data)
        tp, cols = table.shape[1], mt.live_columns(table)
        tris = int((table[9].view(torch.int32) >= 0).sum())
        p, d, tmax = random_rays(7, n, dev)
        tests_closest = n * tris
        tests_any = anyhit_tests_needed(mt, table, p, d, tmax)
        rows = []
        for kname, fn, plain, tests, in_b, out_b in (
            ("mt_closest", lambda: mt.mt_closest(table, p, d, cols=cols),
             lambda: mt.mt_closest_plain(table, p, d, cols=cols), tests_closest, 24, 16),
            ("mt_anyhit", lambda: mt.mt_anyhit(table, p, d, tmax, cols=cols),
             lambda: mt.mt_anyhit_plain(table, p, d, tmax, cols=cols), tests_any, 28, 4),
        ):
            ms = launch_ms(fn)
            plain_ms = launch_ms(plain, reps=3)
            if clock is None and name == "multi_bsdf_scene":
                clock, clock_max = sm_clock_under(fn, ms)
                print(f"SM clock under mt_closest: {clock} MHz (max {clock_max} MHz)", flush=True)
            ops_ms = tests * MT_OPS_PER_TEST / H100_FP32_OPS * 1e3
            bytes_ms = (n * (in_b + out_b) + tris * 40) / H100_BYTES * 1e3
            row = {
                "name": kname, "route": "cuda",
                "source": "phosphorus_mk2_tpu_torch/csrc/mt.cu",
                "replaces": ("phosphorus_mk2_tpu/accel/pallas_mt.py:29" if kname == "mt_closest"
                             else "phosphorus_mk2_tpu/accel/pallas_mt.py:186"),
                "launches": launches[kname], "max_abs_err": errs[kname],
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None, "parity": True,
                "shape": f"{n} rays x {tris} tris ({tp} columns, {name})",
                "tests": tests,
            }
            if kname == "mt_closest":
                row["plan"] = mt.closest_plan(n, cols, *mt.resident(mt.build(), p.device))
            rows.append(row)
            print(f"{kname} on {name}, {n} rays: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {tests} tests, "
                  f"ops {ops_ms:.5f} ms, bytes {bytes_ms:.5f} ms)", flush=True)
        out.append(rows)
    for row in (r for rows in out for r in rows):
        per_test = sass.get(f"{row['name']}_kernel", {}).get("per_test")
        row["sm_clock_mhz"] = clock
        row["issue_floor_ms"] = (per_test * row["tests"] / 32 / (4 * sms * clock * 1e6) * 1e3
                                 if per_test and clock else None)
        print(f"{row['name']} on {row['shape']}: issue floor " + (
            f"{row['issue_floor_ms']:.5f} ms ({per_test:.2f} instructions a test, {clock} MHz, "
            f"{row['ms'] / row['issue_floor_ms']:.3f}x)" if row["issue_floor_ms"]
            else "not measured"), flush=True)
    print(json.dumps({"kernels_multi_bsdf_scene": out[1]}), flush=True)
    print(json.dumps({f"kernels_multi_bsdf_scene_{BIG_RAYS}": out[2]}), flush=True)
    for row in out[0]:  # the headline rows carry the other shapes' times
        row["other_shapes"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                  "issue_floor_ms", "tests")}
                               for rows in out[1:] for r in rows if r["name"] == row["name"]]
    return out[0]  # the headline shape: 65,536 rays on cornell_box


def front_timing(front, cases, launches, errs):
    """Phase 7, front kernels: ms per launch at 65,536 rays on the terrain
    tables (the first case; the others are printed beside it), the bound
    from this run's inputs and the plain ms.

    Bound: bytes = rays x (28 B in + 4 B per key out) + the tables once;
    operations = per ray K2 slab tests + jj x K2 key compares + SC member
    slab tests per VALID parent (counted from these rays' parent keys)."""
    from phosphorus_mk2_tpu_torch.tools.row_gather_probe import launch_ms

    out = []
    for name, bvh, p, d, tlim in cases:
        slab, full, jj = front_args(bvh, p, d, tlim)
        k2, sc = bvh["sc_member_bmin"].shape[:2]
        n = p.shape[0]
        pk = front.front_slab_extract(*slab)
        nbits = front.parent_key_bits(k2)
        valid = int(((pk & -(1 << nbits)) < front.tmax_key(nbits)).sum())
        base_ops = n * (k2 * SLAB_OPS + jj * k2)
        rows = []
        for kname, fn, plain, ops, keys, table_b, line in (
            ("front_full", lambda: front.front_full(*full),
             lambda: front.front_full_plain(*full), base_ops + valid * sc * SLAB_OPS,
             jj + jj * sc, k2 * 24 + k2 * sc * 24, "phosphorus_mk2_tpu/accel/pallas_front.py:136"),
            ("front_slab_extract", lambda: front.front_slab_extract(*slab),
             lambda: front.front_slab_extract_plain(*slab), base_ops, jj, k2 * 24,
             "phosphorus_mk2_tpu/accel/pallas_front.py:36"),
        ):
            ms = launch_ms(fn)
            plain_ms = launch_ms(plain, reps=3)
            ops_ms = ops / H100_FP32_OPS * 1e3
            bytes_ms = (n * (28 + 4 * keys) + table_b) / H100_BYTES * 1e3
            row = {
                "name": kname, "route": "cuda",
                "source": "phosphorus_mk2_tpu_torch/csrc/front.cu", "replaces": line,
                "launches": launches[kname], "max_abs_err": errs[kname],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None, "parity": True,
                "shape": f"{n} rays x K2 {k2}, jj {jj}, SC {sc} ({name})",
                "operations": ops, "valid_parents": valid,
            }
            rows.append(row)
            print(f"{kname} on {name}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {ops} operations, "
                  f"{valid} valid parents, ops {ops_ms:.5f} ms, bytes {bytes_ms:.5f} ms)",
                  flush=True)
        out.append(rows)
    for name, rows in zip([c[0] for c in cases[1:]], out[1:]):
        print(json.dumps({f"kernels_{name}": rows}), flush=True)
    return out[0]


def wave_timing(wave, ct, probe, case, launches, errs, dev):
    """Phase 7, wave kernels. Bounds from this run's inputs.

    row_gather: the probe's geometry; bytes = each DISTINCT row read once
    (the indices are drawn with replacement) + every row written + the
    indices. wave_mt: waves 1 and 8 of a closest-hit trace of the case's
    rays (the state wave 8 meets is made by the kernel itself; the table
    is as warm in L2 as a trace leaves it); bytes = 28 a live pair (ray
    and id) + 8 a ray (tnear, best t) + 12 a winner written + the rows,
    given twice: each DISTINCT cluster's 4,608-byte row once (the table
    is one input, read once: the bound), and every live pair's row from
    device memory; operations = live pairs x 128 tests x 46. wave_sweep: 8 rays x every
    cluster; bytes = the table once; operations = pairs x 128 x 46."""
    launch_ms = probe.launch_ms
    rows = []
    # ---- row_gather: cold (the L2 emptied before each launch, what the
    # bound assumes) and warm (launch after launch, rows and output in L2)
    idx, table = probe.inputs(dev)
    idx_long = idx.long()
    r = idx.shape[0]
    row_b = table.shape[1] * table.shape[2] * 4
    calls = {v: (lambda v=v: wave.row_gather(idx, table, v)) for v in wave.VARIANTS}
    calls["indexing"] = lambda: wave.row_gather_plain(idx, table)
    calls["index_select"] = lambda: torch.index_select(table, 0, idx_long)
    flush = probe.l2_flush()
    cold = {k: launch_ms(fn, before=flush) for k, fn in calls.items()}
    warm = {k: launch_ms(fn) for k, fn in calls.items()}
    distinct = int(torch.unique(idx).numel())  # a row fetched twice is read once
    bound = (distinct * row_b + r * row_b + r * 4) / H100_BYTES * 1e3
    rows.append({
        "name": "row_gather", "route": "cuda",
        "source": "phosphorus_mk2_tpu_torch/csrc/wave.cu",
        "replaces": "tools/tpu_r4q_dma.py:46",
        "launches": launches["row_gather"], "max_abs_err": errs["row_gather"],
        "ms": cold["direct"], "ms_staged": cold["staged"], "plain_ms": cold["indexing"],
        "bound_ms": bound, "bound_by": "bytes", "library_ms": cold["index_select"],
        "parity": True,
        "shape": f"R {r} rows ({distinct} distinct) of {row_b} B out of K {table.shape[0]}",
        "cold": {k: {"ms": t, **probe.per_row(t, r)} for k, t in cold.items()},
        "warm": {k: {"ms": t, **probe.per_row(t, r)} for k, t in warm.items()},
    })
    for label, ms in (("cold", cold), ("warm", warm)):
        print(f"row_gather R {r}, K {table.shape[0]}, L2 {label}: " + ", ".join(
            f"{k} {t:.5f} ms ({probe.per_row(t, r)['ns_per_row']:.2f} ns/row, "
            f"{probe.per_row(t, r)['eff_gbps']:.1f} GB/s fetched)" for k, t in ms.items())
            + f"; bound {bound:.5f} ms (bytes: {distinct} distinct rows read, {r} written)",
            flush=True)

    # ---- wave_mt: the first and the eighth wave of a closest-hit trace
    name, data, p, d, _ = case
    table = data.bvh["cluster_rows"]
    k = table.shape[0]
    n = p.shape[0]
    tlim = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    ttbl, ctbl = front_table(ct, data, p, d, tlim)
    state = fresh_state(tlim)
    waves = []
    for w in range(8):
        col_t, col_c = ttbl[:, w : w + 1], ctbl[:, w : w + 1]
        if w in (0, 7):
            saved = [x.clone() for x in state]

            def reset(saved=saved):
                for x, y in zip(state, saved):
                    x.copy_(y)

            live = wave.live_columns(col_t, state[0], state[1], False)[:, 0]
            pairs = int(live.sum())
            distinct = int(torch.unique(col_c[:, 0][live]).numel())
            ms_k = launch_ms(lambda: wave.wave_mt(p, d, table, col_t, col_c, False, *state),
                             before=reset)
            ms_p = launch_ms(
                lambda: wave.wave_mt_plain(p, d, table, col_t, col_c, False, *state), reps=3,
                before=reset)
            reset()
            wave.wave_mt(p, d, table, col_t, col_c, False, *state)
            won = int((bits(state[0]) != bits(saved[0])).sum())
            ops_ms = pairs * 128 * MT_OPS_PER_TEST / H100_FP32_OPS * 1e3
            rest = pairs * 28 + n * 8 + won * 12
            hbm_ms = (pairs * row_b + rest) / H100_BYTES * 1e3
            l2_ms = (distinct * row_b + rest) / H100_BYTES * 1e3
            waves.append({"wave": w + 1, "rays": n, "live_pairs": pairs, "live_share": pairs / n,
                          "distinct_clusters": distinct, "winners": won, "ms": ms_k,
                          "plain_ms": ms_p, "ops_ms": ops_ms, "bound_ms": max(ops_ms, l2_ms),
                          "bound_ms_every_row_from_device_memory": max(ops_ms, hbm_ms)})
            print(f"wave_mt on {name}, wave {w + 1} of {n} rays: live share {pairs / n:.4f} "
                  f"({pairs} rows, {distinct} distinct clusters), {won} winners; {ms_k:.5f} "
                  f"ms/launch, plain {ms_p:.4f} ms; bound {max(ops_ms, l2_ms):.5f} ms with each "
                  f"distinct row read once, {max(ops_ms, hbm_ms):.5f} ms with every row from "
                  f"device memory (ops {ops_ms:.5f} ms)", flush=True)
        else:
            wave.wave_mt(p, d, table, col_t, col_c, False, *state)
    first = waves[0]
    rows.append({
        "name": "wave_mt", "route": "cuda",
        "source": "phosphorus_mk2_tpu_torch/csrc/wave.cu",
        "replaces": "phosphorus_mk2_tpu/accel/cluster_traverse.py:680",
        "launches": launches["wave_mt"], "max_abs_err": errs["wave_mt"],
        "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": "bytes" if first["bound_ms"] > first["ops_ms"] else "operations",
        "library_ms": None, "parity": True,
        "shape": f"{n} rays x 1 column, K {k} clusters ({name}), wave 1", "waves": waves,
    })

    # ---- wave_sweep: 8 rays against every cluster
    m = 8
    idx8 = torch.arange(0, n, n // m, dtype=torch.int32, device=dev)[:m]
    start = fresh_state(tlim)
    state = [x.clone() for x in start]

    def reset8():
        for x, y in zip(state, start):
            x.copy_(y)

    ms_k = launch_ms(lambda: wave.wave_sweep(p, d, table, idx8, *state), before=reset8)
    ms_p = launch_ms(lambda: wave.wave_sweep_plain(p, d, table, idx8, *state), reps=3,
                     before=reset8)
    ops_ms = m * k * 128 * MT_OPS_PER_TEST / H100_FP32_OPS * 1e3
    bytes_ms = (k * row_b + m * (28 + 12)) / H100_BYTES * 1e3
    rows.append({
        "name": "wave_sweep", "route": "cuda",
        "source": "phosphorus_mk2_tpu_torch/csrc/wave.cu",
        "replaces": "phosphorus_mk2_tpu/accel/cluster_traverse.py:834",
        "launches": launches["wave_sweep"], "max_abs_err": errs["wave_sweep"],
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
        "library_ms": None, "parity": True,
        "shape": f"{m} rays x K {k} clusters ({name})",
    })
    print(f"wave_sweep on {name}, {m} rays x {k} clusters: {ms_k:.5f} ms/launch, plain "
          f"{ms_p:.4f} ms, bound {max(ops_ms, bytes_ms):.5f} ms (ops {ops_ms:.5f} ms, bytes "
          f"{bytes_ms:.5f} ms)", flush=True)
    return rows


def run(profile: bool, upto: int) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    try:
        import phosphorus_mk2_tpu_torch as pt
        from phosphorus_mk2_tpu_torch import scenes
        from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct
        from phosphorus_mk2_tpu_torch.accel import front, mt, native_bvh, wave
        from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
        from phosphorus_mk2_tpu_torch.tools import row_gather_probe as probe
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    phase("1 device")
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}", flush=True)

    phase("2 build")
    build_all({"mt": mt, "front": front, "wave": wave, "native_bvh": native_bvh})
    sass = sass_loops(mt)
    if upto < 3:
        return 0

    phase("3 kernel parity")
    errs = mt_parity(mt, scenes, dev)
    t0 = time.perf_counter()
    terrain = scenes.terrain_scene()
    terrain_data = attach_bvh(terrain.build(device=dev), builder="native")
    multi_data = attach_bvh(scenes.multi_bsdf_scene(8, 8).build(device=dev), builder="native")
    bvh = terrain_data.bvh
    print(f"terrain_scene: {terrain_data.num_tris} triangles, K "
          f"{bvh['cluster_bmin'].shape[0]} clusters, K2 {bvh['sc_bmin'].shape[0]} "
          f"superclusters, scene and tables built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    tp, td = terrain_rays(3, N_RAYS, terrain, dev)
    mp, md, _ = random_rays(4, N_RAYS, dev)
    cases = [("terrain_scene", bvh, tp, td, mixed_limits(5, N_RAYS, dev)),
             ("multi_bsdf_scene", multi_data.bvh, mp, md, mixed_limits(6, N_RAYS, dev))]
    errs.update(front_parity(front, cases))
    wave_cases = [("terrain_scene", terrain_data, tp, td, cases[0][4]),
                  ("multi_bsdf_scene", multi_data, mp, md, cases[1][4])]
    errs.update(wave_parity(wave, ct, probe, wave_cases, dev))
    if upto < 4:
        return 0

    phase("4 cluster tracer vs brute oracle")
    ties, fallback_share = tracer_vs_oracle(mt, ct, terrain, terrain_data, dev)

    phase("5 main path")
    launches = main_path(mt, front, wave, ct, probe, pt, scenes, dev)

    if profile:
        phase("profile")
        profile_traces(ct, terrain_data, tp, td, mixed_limits(13, N_RAYS, dev))
        profile_render(pt, ct, scenes)

    phase("6 whole path: kernels vs plain versions")
    whole_path_vs_plain(mt, pt, scenes, dev)

    phase("7 kernel timing")
    rows = mt_timing(mt, scenes, dev, launches, errs, sass)
    rows += front_timing(front, cases, launches, errs)
    rows += wave_timing(wave, ct, probe, wave_cases[0], launches, errs, dev)

    print(json.dumps({"tracer_vs_oracle": {"exact_t_ties": ties, "rays": N_RAYS,
                                           "fallback_share": fallback_share}}))
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all", flush=True)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one pass of each main-path render with torch.profiler")
    ap.add_argument("--upto", type=int, default=7, metavar="PHASE",
                    help="stop after this phase (2 or 3: build and parity only, for a "
                         "first look at a new kernel); prints no result line")
    args = ap.parse_args()
    try:
        rc = run(args.profile, args.upto)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if rc == 0 and args.upto < 7:
        print(f"chip_smoke: stopped after phase {args.upto}; no result", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

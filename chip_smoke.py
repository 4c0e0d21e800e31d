#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # every phase; needs one CUDA device
    python3 chip_smoke.py --profile  # every phase, plus a torch.profiler
                                     # trace of one pass of each render
                                     # (the textured terrain's texture
                                     # lookups and footprints counted,
                                     # and of a gradient step's forward
                                     # and backward)
    python3 chip_smoke.py --upto 3   # stop after phase 3 (no result line)
    python3 chip_smoke.py --only-tunables
                                     # phases 1-3, then phase 12 alone (no
                                     # result line)
    python3 chip_smoke.py --only-options
                                     # phases 1-3, then phase 13 alone (no
                                     # result line)
    python3 chip_smoke.py --only-shading [--profile]
                                     # phases 1-3, then phase 14 alone (no
                                     # result line; --profile adds the
                                     # device kernels a bounce-step and
                                     # the gradient steps' backward)
    python3 chip_smoke.py --only-blender
                                     # phases 1-3, then phase 15 alone (no
                                     # result line)
    python3 chip_smoke.py --upto 5 --package DIR
                                     # phases 1-5 of the port in DIR (another
                                     # checkout): its main path timed
    python3 chip_smoke.py --sweep-timing [--m 24,25] [--package DIR]
                                     # only wave_sweep at phase 7's shapes
                                     # (of the port in DIR: another checkout)

Phases (any failure ends the run with a non-zero exit and no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: csrc/mt.cu, csrc/front.cu, csrc/wave.cu, csrc/rows_backward.cu
     and csrc/bsdf.cu with nvcc and the native BVH builder csrc/bvh_builder.cpp with g++, all started
     together; the ptxas report, and the instructions of the MT kernels'
     inner loops, wave_mt's loop over a group's rays and wave_sweep's
     loops (a warp's rows in the warp layout, a thread's staged quads in
     the other) as compiled (cuobjdump -sass);
  3. kernel parity on the card, each kernel against its plain PyTorch
     version on 65,536 seeded rays: mt_closest and mt_anyhit on
     cornell_box and multi_bsdf_scene, also on 1 and 31 rays, on 262,144
     (multi_bsdf_scene) and on 4,096 that start on a cornell_box triangle
     (a winning -0.0 is stored as +0.0), each walking the table's live
     columns as the brute tracer does, and on 65,536 rays also the whole
     table: t and tri equal to the bit, u
     and v within 1e-6, occlusion equal; front_full (candidates by column,
     and the kk it selects) and front_slab_extract on the tables of the
     full-size terrain_scene and of multi_bsdf_scene, both with NaN rows,
     t_limit mixed (T_MAX, short, 0), and on synthetic tables: K2 45 (not
     a multiple of 32), jj 1 (jj * SC below kk), K2 768 with every near
     parent in one lane's columns, K2 700 with jj 32 and the near
     candidates crowding two lanes, rays with a zero, denormal or
     infinite direction component, and the flat supercluster whose
     tnear is -0.0, tied at 0: every packed key equal bit for bit;
     row_gather (direct and staged) against indexing
     at the TPU probe's geometry (K 10,987, R 4,096) and on the terrain's
     row table with repeated and boundary indices; wave_mt against
     wave_mt_plain on both scenes' front tables (W = 1 and W = 4, closest
     and any-hit, dead rays, dead columns with out-of-range ids), on the
     terrain's table with every ray of a warp on one cluster, every ray
     on its own and one triangle at equal t in two columns, at the plan's
     gate and at each gate forced, beside wave_mt_plain(gate=) walking the
     same decomposition; wave_sweep against wave_sweep_plain on 300 rays,
     and both on rays
     that start on a triangle (a winning t of -0.0 is stored as +0.0),
     then on the terrain's table at m = 1, 8 (the warp layout), 33 (a
     ragged tile) and 2,048 rays (rows staged) with best t T_MAX, short
     and 0 (K = 5,803 is no multiple of the plan's range), on one
     triangle met at equal t in two clusters that fall in different
     ranges (clusters K.. copy 0..63), and on the table with the first
     edge zeroed on a third of its quads and on single lanes (the quads
     the staged kernel skips), beside wave_sweep_plain(plan=) walking the
     same cut: t, cluster and lane equal bit for bit;
  4. tracer against oracle: intersect_clusters / occluded_clusters on the
     full-size terrain_scene against mt_closest / mt_anyhit over all its
     triangles, 65,536 camera and random rays: occlusion equal, tri equal
     but for rays whose two t are bit-equal (exact ties, counted); then
     the same with tracer_tune front_k 8, whose shallow table sends many
     rays to the exact fallback (printed per trace);
  5. main path, through Renderer(..., device="cuda"): cornell_box
     256x256 and multi_bsdf_scene 512x512 with the brute tracer (as
     before), then terrain_scene 256x256 with use_bvh=True (hierarchical
     front table, front_full, wave_mt, wave_sweep), a short terrain
     render with tracer_tune={"sc_topk": "pallas"} (front_slab_extract),
     and multi_bsdf_scene 512x512 with use_bvh=True (dense front table,
     wave_mt), whose film is held against the brute film; then the
     textured path: textured_terrain_scene (grid 512, 530,912 terrain
     triangles, the checker texture, the lamp and the sky) 256x256 with
     use_bvh=True and mis=True, and a texture-heavy cornell_box 256x256
     (four 2,048 x 2,048 image textures with mips, a normal map, a
     musgrave and a random-noise procedural, a 2,048 x 1,024 lat-long
     environment; mis=True, aniso_taps=4, the brute tracer) rendered with
     an f32 and an f16 atlas, whose films agree within the JAX test's
     atol 2e-3 at depth 1 and in their means at depth 4, with at most
     0.5% of the pixels beyond that atol; the texture lookups on both
     atlases on the card against the same calls on the CPU (every filter
     mode, the procedurals, the lat-long uv, the hash bit for bit), and
     the texture-heavy scene at 64x64 rendered on the card and on the
     CPU at depth 1 (per pixel) and depth 4 (statistics), both atlases;
     a resume: one pass of cornell_box
     256x256 with checkpoint_every=1, the rest in a new Renderer, equal
     to an uninterrupted render within atol 1e-6, and a resume with
     another spp target refused (its launches counted from the first
     pass, not the uninterrupted reference); last the
     row-gather probe through its entry point
     (tools/row_gather_probe.py: row_gather, both variants). Films are
     checked; the launch counts are zeroed before each run and read
     after it; every BVH render must take fewer host syncs than waves;
     prints wall seconds and rays/s, rays counted as W*H*spp*depth*2 as
     in bench.py;
  6. the whole path with the kernels against the whole path with their
     plain versions, both on the card: cornell_box 64x64 (MT kernels),
     terrain_scene 256x256 and multi_bsdf_scene 512x512 with the BVH
     (front and wave kernels against plain=True), and terrain_scene
     256x256 with front_k 8 (the fallback at many rays), and
     textured_terrain_scene 256x256 with mis=True, films equal to
     rtol 1e-5;
  7. kernel timing with CUDA events, beside each kernel's bound and its
     plain version's time: the MT kernels at 65,536 rays on both scenes
     and 262,144 on multi_bsdf_scene, beside the issue floor (the inner
     loop's instructions a test x tests / 32 over 4 warp-instructions a
     clock on every SM, at the SM clock nvidia-smi reads under load),
     both counting the tests over the columns that hold a triangle;
     the front kernels at 65,536 rays, front_full selecting kk = 32 beside
     torch.sort of its candidate rows (the call it replaces);
     row_gather at the probe's geometry (both variants, also as ns per
     row and GB/s, beside index_select); wave_mt on the terrain's first
     and eighth wave of 65,536 rays and the first and fourth of 131,072
     rays on multi_bsdf_scene, beside three bounds (each distinct row
     once, each group's row once, every row from device memory);
     wave_sweep on the terrain's 5,803 clusters at 8 rays, at the mean
     needy count of phase 4's front_k 8 traces (their rays and state) and
     at 2,048 rays, beside its bytes bound (the table once), its
     operations bound and its issue floor (the loop's instructions a
     (ray, row) pair x pairs over 4 warp-instructions a clock on every
     SM), both over the table's real triangles, not its pads; the floor
     over every lane of every row beside it; beside each wave_mt shape its
     bf16-row instance, and both instances over the rays in dedup_order
     (the sort timed apart), and beside each wave_sweep shape its bf16-row
     instance, each with 2,304-byte rows in its bytes bound, its own
     instructions in its issue floor and its plain version's time;
     7b. the lobe container's kernels (csrc/bsdf.cu: bsdf_eval for
     bsdf_f and bsdf_pdf, bsdf_sample) on the inputs of the main path's
     own calls, kept from one pass of multi_bsdf_scene 512x512 and of
     cornell_box 256x256 (131,072 hits x 2 slots, 65,536 x 1): bit-equal
     to the eager lobe code (the dense dispatch), twice bit-equal,
     counted once a call, timed beside the bytes bound and the eager
     code;
     7c. the weight-gradient route's kernels at multi_bsdf.inverse's
     262,144 hits x 2 slots (six lobe types at random): the SAVE
     forwards timed beside the no-grad ones, bsdf_weight_grad (bsdf_f and
     bsdf_sample) bit-equal to its plain version and to eager autograd's
     weight gradient, timed beside its bytes bound, its plain version and
     the eager call's forward and backward;
  8. gradients and inverse rendering (integrator/path.py render_pass with
     gradients, trainable=; optim.InverseRenderer),
     every tracer call primal: (1) gradients of color.sum() with respect
     to emission, lobe_weight and vertices with the kernels and with
     their plain versions, both on the card: cornell_box 64x64 4 spp
     depth 4 (brute) and terrain_scene 256x256 1 spp depth 2 (cluster
     tracer): films at rtol 1e-5, gradients within 1e-4 of each field's
     max |g| (a bound relative to the field's scale, since a backward
     that sums with atomics is not bit-stable); (2) tests/test_grad.py's sphere_in_box 16x16
     gradients on the card against the CPU (the same bound) and its
     finite-difference checks on the card; (3) bench.py's headline
     shape, cornell_box 256x256 16 spp depth 4 brute: the forward, the
     gradient (emission, lobe_weight, vertices) and the scoped gradient
     (emission, lobe_weight), rays/s and peak memory of each, scoped
     equal to unscoped within 1e-4 (--profile: the forward and the
     backward of a 4-spp gradient step traced); (4) bench.py's
     bmw_fwd_bwd shape on the full-size terrain_scene (1 << 16 pixels,
     2 spp, depth 3, use_bvh=True): gradients
     finite, front and wave kernels launched; (5) multi_bsdf_scene
     512x512 depth 9 2 spp, no-grad, on the eager lobe code and on the
     kernel route: the two films bit-equal, each timed; gradients (the
     eager code: the lobe parameters take gradient) at 256x256 depth 2,
     finite and not all zero; (6) InverseRenderer
     recovering cornell_box's lamp from 0.3x at 256x256 (log emission,
     unbiased loss, 8 spp, depth 3), the criteria of tests/test_optim.py,
     then a checkpoint resumed in a new
     InverseRenderer equal to the uninterrupted run within 1e-6.
     The launches of the timed calls of (3)-(6) count in the kernels
     line, each counted from 0 just before the call and read just after
     it; warm-ups, references, comparisons and the resume do not.
  9. scene I/O and the sharded render (io/, parallel/, Renderer and
     InverseRenderer over a device mesh): (a) the BMW asset
     (tools/bmw_asset.py of the port, scale 1.0: 14 meshes, 887,604
     triangles) written by the port's Alembic writer into a temporary
     directory, imported by its Ogawa reader, built with the native BVH
     builder and rendered through Renderer(use_bvh=True) at 512x512, 4
     spp, depth 4 (bench.py's bmw_live shape): the seconds to write, to
     import and to build the BVH, K and K2, rays/s; the film finite and
     lit; at 256x256, 1 spp, depth 2 the BVH film equal to the brute
     kernels' on >= 99.9% of the pixels; (b) examples/cornell.yaml
     imported and rendered at 64x64 on the card and on the CPU (phase 5's
     card-against-CPU limits), the film written with io/exr.write_film
     and read back bit for bit; (c) Renderer(n_devices=1) equal to phase
     5's cornell_box film bit for bit; a world-size-1 NCCL group
     (parallel.initialize) rendering and reducing on the card; two gloo
     ranks on the one card (tools/rank_parity.py; NCCL refuses two ranks
     on one device) whose all-gathered films of cornell_box 256x256
     (brute) and terrain_scene 256x256 (use_bvh=True) are bit-equal to
     one process's, and whose all-reduced gradient of color.sum() with
     respect to (emission, lobe_weight) is within 1e-4 of each field's
     max |g| of one process's. A rank that fails or hangs fails the
     phase. The timed BMW render, the BMW's 256x256 renders, the card's
     cornell.yaml renders and the n_devices=1 render are counted;
 10. the CLI, the bench and the entry points (cli.py, bench.py, entry.py,
     utils/profiling.py): (a) `cli.main` on builtin:cornell_box 256x256
     -s 16 -d 4 --no-bvh -1, its EXR (half, zip) equal to phase 5's
     cornell_box film cast to float16 bit for bit; (b) examples/cornell.yaml
     128x128 through the CLI with --mis, equal to the same render through
     Renderer on the card; (c) --optimize against an EXR target rendered on
     the card, 4 steps with a checkpoint every 2: finite losses, the npz
     with the JAX package's keys, a second call resuming at step 4; (d)
     `python -m phosphorus_mk2_tpu_torch.bench --bmw` in a child process,
     its six lines echoed as they come: rc 0, the six metrics of bench.py,
     each > 0 with no error; (e) entry()'s forward step on the card against
     the CPU and dryrun_multichip(1); (f) utils.profiling.trace around one
     cornell_box pass writes a Chrome trace with kernel events. The calls of
     (a)-(c), (e) and (f) are counted (the bench's process is not);
 11. the oracle tracers and the segment-sum row gather (accel/traverse.py,
     accel/block_traverse.py with accel/sort.py, accel/intersect.py
     intersect_brute / occluded_brute, math/grad_gather.py): (a) per_ray,
     block (sorted_trace) and brute, closest and any-hit, on 65,536 seeded
     rays with phase 3's mixed tmax on cornell_box and sphere_in_box with a
     BVH, and on the full-size terrain_scene's 256x256 pixel-centre rays,
     against mt_closest / mt_anyhit: hit and occlusion equal, tri equal but
     for counted exact ties (t bit-equal under the kernels' arithmetic, or
     one packed-key bucket for brute) and edge ties (a shared edge, t
     within 1e-6), t within 1e-5 (|t| + 0.01); ms a trace, rays/s, lockstep steps
     and host syncs; (b) cornell_box 256x256 4 spp depth 4 with a BVH
     through render_pass and make_tracer(kind="block") and "per_ray", each
     film against the brute kernels' on >= 99.9% of the pixels, rays/s;
     (c) gather_rows at cornell_box's shape (65,536 indices into 36 rows of
     the hit rows' width: its pixel rays' hit triangles, and uniform) and
     the BMW's (262,144 uniform into 887,604): the primal
     bit-equal to table[idx], the segsum and scatter gradients within rtol
     1e-5 / atol 1e-6 of table[idx]'s, two segsum backwards bit-equal, and
     the three backwards timed with CUDA events. The timed kernel calls of
     (a) and the brute film of (b) are counted;
 12. the cluster tracer's four tunables (slab_bf16, front_levels=3,
     wave_dedup / dedup_d, rows_bf16) on the BMW asset (bench.load_bmw:
     887,604 triangles, K 10,987, K2 687, K3 43): (a) the new kernel
     instances against their plain versions, bit for bit (t, cluster,
     lane): wave_mt on the bf16 rows on the terrain's first and eighth
     wave of 65,536 rays and the BMW's first and second of 131,072, at the
     plan's gate and every gate forced (and wave_mt_plain's gate= walk);
     wave_mt over dedup_order's rays against no order with both row
     types, with the rows it fetches either way; the bf16 wave_sweep at
     8 and 16 rays (a warp a tile) and 448 and 2,048 (rows staged) on the
     terrain's 5,803 clusters, beside wave_sweep_plain(plan=); (b) the
     BMW's 131,072 pixel-centre rays (bmw_live's shape), closest hit and any hit with
     shadow-ray limits, under slab_bf16 (sc_topk auto and extract),
     front_levels 3, wave_dedup gather and onehot, the exact ones
     together, rows_bf16, and rows_bf16 with wave_dedup: the exact ones
     equal to the default trace but for counted exact-t and edge ties,
     rows_bf16's hit agreement > 0.99, its same-triangle share, median t
     error and occlusion agreement printed beside JAX's bounds
     (tests/test_front_table.py:118-147), its traces with the kernels
     equal to those with plain=True; ms a trace in turns
     with the default, waves and host syncs a trace; the rows wave_mt
     fetches in a trace with and without dedup_order (the dedup factor
     on this card); the front table's ms at front_levels 2 and 3; (c)
     the BMW at bmw_fwd's shape (512x512, 4 spp, depth 4, render_pass):
     the exact tunables together equal to the default film on >= 99.9%
     of the pixels, rows_bf16 with the kernels equal to rows_bf16 with
     plain=True at rtol 1e-5, rays/s of each and the rows_bf16 film's
     mean against the exact film's. The timed traces of (b) and the
     kernel films of (c) are counted, and every new instance must launch;
 13. the integrator's options (integrator/path.py pipeline_shadow,
     spp_batch and remat, through render_pass, Renderer and
     render_pass_pixels), with the card's name and power limit: (a)
     pipeline_shadow on cornell_box 256x256 (brute) and the BMW asset at
     bench bmw_fwd's shape (512x512), 4 spp, depth 4, one render_pass,
     pipelined and not in turns: the pipelined film with the kernels
     equal to plain=True's (rtol 1e-5), and to the non-pipelined film
     within rtol 1e-4, atol 1e-5 (every cornell_box pixel, >= 99.9% of
     the BMW's, the others counted); per pass the kernel launches (a
     pipelined brute pass: one mt_anyhit launch a sample), the cluster
     tracer's traces, waves and host syncs, rays/s (medians of 3); the
     cornell_box gradient (emission, lobe_weight) pipelined against not
     within 1e-4 of each field's max |g|; (b) spp_batch 1, 2 and 4
     through Renderer on cornell_box 256x256 16 spp depth 4 (brute) and
     the BMW 512x512 4 spp depth 4 (its 1 << 17-pixel chunks): films
     equal to spp_batch 1's within rtol 1e-4, atol 1e-5, launches a pass,
     peak memory, rays/s in turns (medians of 3); (c) remat on the
     gradient steps of bench cornell_fwd_bwd's shape and bmw_fwd_bwd's
     (the BMW's first 1 << 16 pixels, 2 spp, depth 3), with and without:
     the gradients within 1e-4 of the scale (max |diff| and bit-equality
     printed), peak memory, seconds a step, launches with the recompute.
     The timed renders and steps are counted;
 14. the un-consolidated shading path (integrator/path.py above
     HIT_ROW_MAX_TRIS = 262,144 triangles: no hit rows, the hit side
     shaded from the attribute table, scene.tri_mat and the material
     tables, as in the JAX package), with the card's name and power
     limit: (a) terrain_scene 256x256 and textured_terrain_scene (grid
     512) 256x256 with mis=True, both 4 spp depth 4 use_bvh=True, and the
     BMW asset 512x512 4 spp depth 4, through Renderer: make_scene_tables
     builds no hit rows by default; each film under the default and with
     the threshold raised above the scene (the hit rows), in turns: the
     two films bit-equal (within rtol 1e-5 checked, bit-equality and the
     max |diff| printed), the default film equal to a plain=True
     Renderer's (rtol 1e-5), rays/s (medians of 3), the MT, front and
     wave kernels' launches a pass (equal under both) and the hit rows'
     bytes, with --profile the device kernels a bounce-step
     (torch.profiler); (b) bench
     bmw_fwd_bwd's gradient step (the first 1 << 16 pixels, 2 spp, depth
     3) on the full-size terrain and the BMW under
     both branches, in turns: gradients of (emission, lobe_weight,
     vertices) within 1e-4 of each field's max |g|, seconds a step, peak
     memory after a reset; with --profile the backward's busy time and
     indexing_backward_kernel's share. The timed renders and steps are
     counted; (c) the backward of the few-row gathers
     (csrc/rows_backward.cu) at cornell_box.inverse's shapes: every
     gather of an InverseRenderer step through the kernel pair, none
     above the budget; the kernel within 1 float32 ulp of its plain
     version and of a float64 index_put_, bit-equal twice, one count a
     call, a float16 cotangent and a table above the budget refused; ms a
     call beside its bytes bound, the plain version and index_put_;
 15. the Blender add-on (phosphorus_mk2_tpu_torch/blender/), driven
     through tools/blender_stub.py's bpy, depsgraph and engine harness
     (Blender is not on the card's machine), with the card's name and
     power limit: (a) the BMW asset (scale 1.0, 887,604 triangles) as a
     depsgraph with loops and the uv layer, exported by the add-on's
     exporter (its meshes' vertices and faces bit-equal to the asset's,
     the material ids the asset's through the exporter's table) and
     rendered by PhosphorusRenderEngine.render on the card at 512x512
     with the add-on's settings but 8 spp (two passes) and the Normal
     pass: Combined and Normal bit-equal, after the y-flip, to the last
     film of a Renderer of the exported scene with the same Options;
     front_full, wave_mt and wave_sweep launched; stub, export, Renderer
     set-up (beside the asset scene's, which has no corner attributes)
     and pass seconds, Mrays/s and the peak memory printed; (b)
     the JAX add-on test's two-view quad at 64x48 through the engine:
     each eye's passes bit-equal to a Renderer on that eye's camera, the
     eyes apart, mt_closest and mt_anyhit launched, and a test_break
     after the first pass that leaves one pass written. The engine
     renders of (a) and (b)'s stereo render are counted.

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
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
    for name in ("mt", "front", "wave", "grad_gather", "bsdf"):
        for line in mods[name].build_log.splitlines() if name in mods else ():
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


def trace_inputs(terrain, device):
    """The rays of phase 4's terrain traces and the any-hit limits (a
    third 1e-6, the integrator's dead lanes)."""
    p, d = terrain_rays(11, N_RAYS, terrain, device)
    tmax = mixed_limits(12, N_RAYS, device)
    tmax[0::3] = 1e-6
    return p, d, tmax


@contextlib.contextmanager
def fallback_inputs(wave):
    """Record each ``wave.wave_sweep`` call's listed rays and the state it
    met (copies), then make the call. The tracer reaches the fallback
    through the module, so this sees its calls in any version of the
    package, which ``--sweep-timing --package`` needs."""
    seen = []
    sweep = wave.wave_sweep

    def record(p, d, table, idx, best_t, best_c, best_l, **kw):
        seen.append((idx.clone(), [best_t.clone(), best_c.clone(), best_l.clone()]))
        return sweep(p, d, table, idx, best_t, best_c, best_l, **kw)

    wave.wave_sweep = record
    try:
        yield seen
    finally:
        wave.wave_sweep = sweep


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


def front_args(bvh, p, d, tlim, jj=None):
    """The arguments of the front kernels for one BVH and ray set."""
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct

    jj = jj or min(ct.SC_FRONT, bvh["sc_bmin"].shape[0])
    slab = (bvh["sc_bmin"], bvh["sc_bmax"], p, d, tlim, jj)
    full = (bvh["sc_bmin"], bvh["sc_bmax"], bvh["sc_member_bmin"], bvh["sc_member_bmax"],
            p, d, tlim, jj)
    return slab, full, jj


def synthetic_front(k2, seed, dev, hot_lane=None, hot_slot=None, n=N_RAYS):
    """A two-level table of k2 superclusters of 16 member boxes (one member
    slot in six NaN, the last supercluster wholly NaN) and n rays with
    origins near the centre, their limits mixed; some rays have an axis
    component of 0, a denormal one (inv is infinite) or an infinite one
    (inv is 0), which the kernels take through the NaN-propagating slab.
    hot_lane: the superclusters of columns k = hot_lane (mod 32) sit around
    the origins and every other one far off, so a ray's nearest parents all
    lie in one lane's columns (a lane of front_full gives more keys than
    its window holds). hot_slot: member slot s of every supercluster is the
    near one, so the nearest candidates j * 16 + s crowd two lanes."""
    rs = np.random.RandomState(seed)
    sc = 16
    centre = rs.uniform(-6.0, 6.0, size=(k2, 1, 3))
    if hot_lane is not None:
        hot = np.arange(k2) % 32 == hot_lane
        centre[hot] = rs.uniform(-1.0, 1.0, size=(int(hot.sum()), 1, 3))
        centre[~hot] *= 3.0
    lo = (centre + rs.uniform(-0.8, 0.2, size=(k2, sc, 3))).astype(np.float32)
    if hot_slot is not None:
        lo[:, hot_slot] = rs.uniform(-1.2, 0.2, size=(k2, 3))
    hi = (lo + rs.uniform(0.05, 0.6, size=(k2, sc, 3))).astype(np.float32)
    if hot_slot is not None:
        hi[:, hot_slot] = lo[:, hot_slot] + 1.0
    empty = rs.uniform(size=(k2, sc)) < 0.17
    if hot_slot is not None:
        empty[:, hot_slot] = False
    empty[-1] = True
    lo[empty] = np.nan
    hi[empty] = np.nan
    sc_lo = np.min(np.where(empty[..., None], np.inf, lo), axis=1).astype(np.float32)
    sc_hi = np.max(np.where(empty[..., None], -np.inf, hi), axis=1).astype(np.float32)
    sc_lo[-1] = np.nan
    sc_hi[-1] = np.nan
    p = rs.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    dd = rs.normal(size=(n, 3)).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
    dd[1::101, 0] = 0.0
    dd[2::101, 1] = 1e-40
    dd[3::101, 2] = -np.inf
    bvh = {k: torch.from_numpy(v).to(dev) for k, v in
           (("sc_bmin", sc_lo), ("sc_bmax", sc_hi), ("sc_member_bmin", lo),
            ("sc_member_bmax", hi))}
    return bvh, torch.from_numpy(p).to(dev), torch.from_numpy(dd).to(dev)


def flat_front(dev):
    """The flat supercluster of tests/test_torch_front_select.py: rays from
    the plane x = 0 of box 1 with dx < 0, so box 1's raw tnear is -0.0 and
    boxes 0, 1, 2 all tie at tnear 0; one real member each, its own box,
    among NaN slots."""
    bmin = np.array([[-1, -1, -1], [0, -1, -1], [-2, -2, -2], [-3, -1e3, -1e3]], np.float32)
    bmax = np.array([[1, 1, 1], [0, 1, 1], [2, 2, 2], [-2.5, 1e3, 1e3]], np.float32)
    rs = np.random.RandomState(80)
    n = 4096
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = -np.abs(d[:, 0]) - 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.zeros((n, 3), np.float32)
    p[:, 1:] = rs.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    mb_min = np.full((4, 16, 3), np.nan, np.float32)
    mb_max = np.full((4, 16, 3), np.nan, np.float32)
    for s in range(4):
        mb_min[s, (5 * s) % 16], mb_max[s, (5 * s) % 16] = bmin[s], bmax[s]
    bvh = {k: torch.from_numpy(v).to(dev) for k, v in
           (("sc_bmin", bmin), ("sc_bmax", bmax), ("sc_member_bmin", mb_min),
            ("sc_member_bmax", mb_max))}
    return bvh, torch.from_numpy(p).to(dev), torch.from_numpy(d).to(dev)


def front_cases(cases, dev):
    """Phase 3's front inputs: the scenes' tables, then the adversarial
    ones. (name, bvh, p, d, tlim, jj or None, the kk to select)."""
    out = [(name, bvh, p, d, tlim, None, (32, 100)) for name, bvh, p, d, tlim in cases]
    for name, k2, jj, kw in (
        ("synthetic K2 45 (not a multiple of 32)", 45, None, {}),
        ("synthetic K2 45, jj 1 (jj * SC = 16 < kk)", 45, 1, {}),
        ("synthetic K2 768, nearest parents in lane 5", 768, None, {"hot_lane": 5}),
        ("synthetic K2 700, jj 32 (512 candidates), nearest member slot 0", 700, 32,
         {"hot_slot": 0}),
    ):
        bvh, p, d = synthetic_front(k2, 30 + k2 + (jj or 0), dev, **kw)
        out.append((name, bvh, p, d, mixed_limits(31, p.shape[0], dev), jj, (32,)))
    bvh, p, d = flat_front(dev)
    far = torch.full((p.shape[0],), T_MAX, dtype=torch.float32, device=dev)
    out.append(("flat supercluster (tnear -0.0 and ties at 0)", bvh, p, d, far, 4, (4, 100)))
    return out


def front_parity(front, cases):
    """Both front kernels against their plain versions: every packed key
    bit for bit, the candidate keys by column and, given kk, the kk
    selected in ascending order. cases: front_cases(). Returns the
    largest absolute key difference per kernel (0 when they agree)."""
    err = {"front_full": 0.0, "front_slab_extract": 0.0}
    for name, bvh, p, d, tlim, jj, kks in cases:
        slab, full, jj = front_args(bvh, p, d, tlim, jj)
        nan_rows = int(torch.isnan(bvh["sc_member_bmin"]).any(dim=-1).sum())
        check(nan_rows > 0, f"{name}: the member table has no NaN row to test the NaN rule on")
        outs = [(None, front.front_full(*full), front.front_full_plain(*full))]
        outs += [(kk, front.front_full(*full, kk), front.front_full_plain(*full, kk=kk))
                 for kk in kks]
        sk = front.front_slab_extract(*slab)
        psk = front.front_slab_extract_plain(*slab)
        torch.cuda.synchronize()
        k2, sc = bvh["sc_member_bmin"].shape[:2]
        nbits = front.key_bits(jj * sc)
        pk = outs[0][1][0]
        for kk, (gk, gc), (wk, wc) in outs:
            bad = int((gk != wk).sum()) + int((gc != wc).sum())
            pending = int(((wc & -(1 << nbits)) < front.tmax_key(nbits)).sum())
            nohit = int(((wc & -(1 << nbits)) >= front.tmax_key(nbits)).all(dim=1).sum())
            print(f"front_full{'' if kk is None else f' kk {kk}'} on {name}: K2 {k2}, jj {jj}, "
                  f"SC {sc}, {nan_rows} NaN member rows, {p.shape[0]} rays, {pending} pending "
                  f"candidates, {nohit} rows with none; mismatched keys {bad} of "
                  f"{gk.numel() + gc.numel()}", flush=True)
            check(bad == 0, f"front_full (kk {kk}) disagrees with its plain version on {name}")
            check(kk is None or tuple(gc.shape) == (p.shape[0], min(kk, jj * sc)),
                  f"front_full kk {kk} on {name}: {tuple(gc.shape)} keys")
            check(torch.equal(gk, pk), f"{name}: front_full's parent keys differ with kk")
            err["front_full"] = max(err["front_full"],
                                    float((gk.long() - wk.long()).abs().max()),
                                    float((gc.long() - wc.long()).abs().max()))
        bad_slab = int((sk != psk).sum())
        print(f"front_slab_extract on {name}: mismatched keys {bad_slab} of {sk.numel()}",
              flush=True)
        check(bad_slab == 0, f"front_slab_extract disagrees with its plain version on {name}")
        check(torch.equal(sk, pk), f"{name}: the two kernels' parent keys differ")
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

    # wave_mt's grouping, on the terrain's table: every ray of a warp on
    # one cluster, every ray on a cluster of its own, and one triangle met
    # at equal t in two columns (clusters K.. copy 0..63), each with the
    # plan's gate and with every gate forced, and the plain walk of the
    # same decomposition
    table = cases[0][1].bvh["cluster_rows"]
    k = table.shape[0]
    twin = torch.cat([table, table[:64]])
    for label, tbl, col_c in (
        ("all rays on one cluster", table, torch.full((8192, 1), 77, dtype=torch.int32)),
        ("every ray on its own cluster", table, torch.arange(k, dtype=torch.int32)[:, None]),
        ("equal t in columns 0 and 2", twin, tied_columns(k, 8192, dev)),
    ):
        col_c = col_c.to(dev).contiguous()
        n = col_c.shape[0]
        p, d = aimed_rays(tbl, col_c[:, 0], 24, dev)
        col_t = torch.zeros(col_c.shape, dtype=torch.float32, device=dev)
        col_t[::13, 1:] = T_MAX
        want = fresh_state(torch.full((n,), T_MAX, dtype=torch.float32, device=dev))
        wave.wave_mt_plain(p, d, tbl, col_t, col_c, False, *want)
        for gate in (None, *wave.GATES):
            got = fresh_state(want[0].new_full((n,), T_MAX))
            wave.wave_mt(p, d, tbl, col_t, col_c, False, *got, gate=gate)
            walked = fresh_state(want[0].new_full((n,), T_MAX))
            wave.wave_mt_plain(p, d, tbl, col_t, col_c, False, *walked, gate=gate or 8)
            torch.cuda.synchronize()
            g = gate or wave.gate_plan(n, *wave.resident(wave.build(), p.device))["g"]
            groups = wave.wave_groups(col_t, col_c, want[0].new_full((n,), T_MAX),
                                      want[1], False, tbl.shape[0], g)
            hits = agree("wave_mt", f"{label}, {n} rays x {col_c.shape[1]} columns, gate "
                         f"{g}{'' if gate else ' (plan)'}, {groups} rows fetched", got, want)
            check(all(torch.equal(a, b) for a, b in zip(walked, want)),
                  f"wave_mt_plain(gate={gate or 8}) differs from the uncut walk on {label}")
            check(hits > n // 2, f"wave_mt {label}: {hits} of {n} rays hit, no test")
        if tbl is twin:
            both = (want[1] % k == col_c[:, 0] % k) & (want[1] >= 0) & (col_t[:, 2] < T_MAX)
            check(int(both.sum()) > n // 4 and bool((want[1][both] == col_c[both, 0]).all()),
                  "equal t in columns 0 and 2: the winner is not column 0's cluster")
    return err


def sweep_parity(wave, case, dev):
    """wave_sweep against wave_sweep_plain on the terrain's table, bit for
    bit: m = 1, 8 (the warp layout), 33 (a ragged tile) and 2,048 (rows
    staged) listed rays aimed at its triangles, their best t mixed
    (T_MAX, short, 0); one triangle met at equal t in two clusters that
    fall in different ranges of the plan (clusters K.. copy 0..63; the
    winner must be the lower cluster); and the table with the first edge
    zeroed on a third of its quads and on single lanes (quads the staged
    kernel skips, inside rows as well as at their ends); each beside
    wave_sweep_plain(plan=) walking the same cut. Returns the largest
    absolute t difference (0 when they agree)."""
    name, data = case[:2]
    table = data.bvh["cluster_rows"]
    k = table.shape[0]
    lib = wave.build()
    err = 0.0
    rs = np.random.RandomState(26)
    ragged = False
    # rays aimed at a triangle of a random cluster, from 0.5 to 3 away,
    # their best t by thirds T_MAX, short, 0
    ap, ad = aimed_rays(table, torch.from_numpy(rs.randint(0, k, size=2048)).to(dev), 28, dev)
    every = torch.arange(2048, dtype=torch.int32, device=dev)
    runs = [(f"{m} aimed rays on {name}", table, ap, ad, mixed_limits(29, 2048, dev),
             every[:m].contiguous()) for m in (1, 8, 33, 2048)]
    twin = torch.cat([table, table[:64]])
    cid = torch.from_numpy(rs.randint(0, 64, size=2048).astype(np.int32)).to(dev)
    tp, td = aimed_rays(twin, cid, 27, dev)
    far = torch.full((2048,), T_MAX, dtype=torch.float32, device=dev)
    runs += [(f"equal t in clusters c and K + c, {m} rays", twin, tp, td, far,
              every[:m].contiguous()) for m in (8, 2048)]
    holes = table.clone()
    quads = torch.from_numpy(rs.rand(k, 32) < 1 / 3).to(dev).repeat_interleave(4, dim=1)
    lanes = torch.from_numpy(rs.rand(k, 128) < 0.05).to(dev)
    holes[:, 3:6] = torch.where((quads | lanes)[:, None], 0.0, holes[:, 3:6])
    runs += [(f"{m} aimed rays, e0 zeroed on a third of the quads", holes, ap, ad, far,
              every[:m].contiguous()) for m in (8, 2048)]
    for label, tbl, rp, rd, lim, idx in runs:
        m, kt = idx.shape[0], tbl.shape[0]
        want = fresh_state(lim)
        wave.wave_sweep_plain(rp, rd, tbl, idx, *want)
        hits = int((want[1][idx.long()] >= 0).sum())
        plan = wave.sweep_plan(m, kt, *wave.sweep_resident(lib, dev, wave.sweep_tile(m)))
        got = fresh_state(lim)
        wave.wave_sweep(rp, rd, tbl, idx, *got)
        walked = fresh_state(lim)
        wave.wave_sweep_plain(rp, rd, tbl, idx, *walked, plan=plan)
        torch.cuda.synchronize()
        bad = [int((bits(g) != bits(w)).sum()) if g.dtype == torch.float32
               else int((g != w).sum()) for g, w in zip(got, want)]
        same_walk = all(torch.equal(a, b) for a, b in zip(walked, want))
        ragged |= kt % plan["per_block"] != 0
        print(f"wave_sweep {label}: tile {plan['tile']}, {plan['splits']} ranges of "
              f"{plan['per_block']} of {kt} clusters, {plan['blocks']} blocks; {hits} rays hit; "
              f"mismatches t {bad[0]} cluster {bad[1]} lane {bad[2]}, plan walk "
              + ("equal" if same_walk else "DIFFERS"), flush=True)
        check(sum(bad) == 0, f"wave_sweep disagrees with its plain version on {label}")
        check(same_walk, f"wave_sweep_plain(plan=) differs from the uncut walk on {label}")
        err = max(err, float((got[0] - want[0]).abs().max()))
        check(0 < hits, f"wave_sweep {label}: no ray hits, no test")
        if tbl is twin:
            sel = idx.long()
            won = want[1][sel]  # a winner K + c loses to its copy c: equal t, lower index
            check(bool((won < k).all()) and int((won == cid[sel]).sum()) > m // 4,
                  f"{label}: the winner is not the lower of two equal clusters")
            check(plan["splits"] > 1, f"{label}: one range, the twins are not split")
        elif tbl is table:
            start = lim[idx.long()]
            check(m < 3 or ((start == T_MAX).any() and (start == 0).any()
                            and ((start > 0) & (start < T_MAX)).any()),
                  f"{label}: the starting best t are not mixed")
    check(ragged, "no sweep met a table whose K is not a multiple of its range")
    return err


def pixel_rays(scene, dev):
    """One camera ray through the centre of every pixel, row by row."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params, generate_rays

    cam = scene.camera
    i = torch.arange(cam.width * cam.height, device=dev)
    half = torch.full((i.shape[0], 2), 0.5, device=dev)
    p, d = generate_rays(camera_to_params(cam, dev), i % cam.width, i // cam.width, half, half)
    return p.contiguous(), d.contiguous()


def aimed_rays(table, cid, seed, dev):
    """Rays that end on the centroid of a triangle of their cluster cid
    (n,), from 0.5 to 3 away in a random direction."""
    rs = np.random.RandomState(seed)
    n = cid.shape[0]
    lane = torch.from_numpy(rs.randint(0, 128, size=n)).to(dev)
    rows = table[cid.long()]                                   # (n, 9, 128)
    real = rows[:, 3:6].abs().sum(dim=1) > 0                   # (n, 128)
    lane = torch.where(real.gather(1, lane[:, None])[:, 0], lane, real.int().argmax(dim=1))
    tri = rows.gather(2, lane[:, None, None].expand(n, 9, 1))[:, :, 0]
    target = tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3
    back = random_rays(seed, n, dev)[1]
    dist = torch.from_numpy(rs.uniform(0.5, 3.0, size=(n, 1)).astype(np.float32)).to(dev)
    return (target + back * dist).contiguous(), (-back).contiguous()


def tied_columns(k, n, dev):
    """(n, 3) cluster ids: column 0 and column 2 name a cluster of 0..63
    and its copy K + c, by turns which first; column 1 another cluster."""
    rs = np.random.RandomState(25)
    c = rs.randint(0, 64, size=n)
    cols = np.stack([c, rs.randint(0, k, size=n), c], axis=1).astype(np.int32)
    cols[0::2, 0] += k
    cols[1::2, 2] += k
    return torch.from_numpy(cols).to(dev)


def tracer_vs_oracle(mt, ct, terrain, data, dev, tune):
    """Phase 4: the cluster tracer on the full-size terrain, with the
    tracer_tune ``tune``, against the brute kernels over all its
    triangles. Returns (exact-t ties, fallback share, the rays and state
    each call of the fallback met, p, d)."""
    from phosphorus_mk2_tpu_torch.accel import wave

    p, d, tmax = trace_inputs(terrain, dev)  # a third of tmax 1e-6: the dead lanes
    table = mt.tri_table(data)
    for k in ct.STATS:
        ct.STATS[k] = 0
    with fallback_inputs(wave) as seen:
        got = ct.intersect_clusters(data, p, d, **tune)
        occ = ct.occluded_clusters(data, p, d, tmax, **tune)
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
    print(f"terrain_scene, tracer_tune {tune}: {data.num_tris} tris, {N_RAYS} rays, "
          f"{int((tri >= 0).sum())} hits, "
          f"{int(oref.sum())} occluded; tri differs on {int(diff.sum())} rays, of which exact-t "
          f"ties {int(ties.sum())}, other {bad}; t differs on {bad_t}; occlusion differs on "
          f"{bad_occ}; exact-fallback rays {counts['fallback_rays']} of {counts['rays']} "
          f"(share {share:.6f}; per trace, closest then any-hit: "
          f"{[idx.shape[0] for idx, _ in seen]}); {counts['waves']} waves and {counts['syncs']} "
          f"host syncs in {counts['traces']} traces", flush=True)
    check(bad == 0, f"the cluster tracer names another triangle than the oracle on {bad} rays")
    check(bad_t == 0, f"the cluster tracer's t differs from the oracle's on {bad_t} rays")
    check(bad_occ == 0, f"occluded_clusters disagrees with mt_anyhit on {bad_occ} rays")
    check(int(ties.sum()) <= N_RAYS // 1000, f"{int(ties.sum())} exact-t ties: too many to be ties")
    return int(ties.sum()), share, seen, p, d


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


TEX_SIZE = 2048            # the texture-heavy scene's image textures, square
F16_ATOL = 2e-3            # tests/test_texture.py test_f16_atlas_matches_f32_render
F16_FLIPS = 0.005          # share of depth-4 pixels that may lie outside F16_ATOL


def texture_heavy_scene(scenes, texture_dtype, width=256, height=256, seed=17,
                        tex_size=TEX_SIZE):
    """cornell_box with every surface textured from a seeded generator:
    four tex_size x tex_size (2,048) image textures with mips on the
    walls, a tangent-space normal map (half as wide) on the floor, a
    musgrave and a random-noise procedural on the two boxes, and a
    tex_size x tex_size / 2 lat-long environment (an emission texture)
    seen through the box's open side and around the box (the camera
    stands back from the box's own). texture_dtype: "f32" or "f16"
    (Scene.texture_dtype). The scene is built from the classes of the
    package that `scenes` belongs to."""
    import importlib

    pkg = scenes.__name__.rpartition(".")[0]
    Camera = importlib.import_module(f"{pkg}.core.camera").Camera
    Material = importlib.import_module(f"{pkg}.core.material").Material
    Texture = importlib.import_module(f"{pkg}.core.texture").Texture

    rng = np.random.default_rng(seed)
    scene = scenes.cornell_box(width, height)
    scene.camera = Camera.look_at((0.4, 0.3, 5.0), (0.0, 0.0, 0.0), width=width, height=height)
    scene.texture_dtype = texture_dtype
    n = tex_size
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    tids = []
    for k in range(4):  # stripes at seeded frequencies plus texel noise
        f, ph = rng.uniform(2, 24, 3), rng.uniform(0, 2 * np.pi, 3)
        base = 0.5 + 0.25 * np.stack([np.sin(2 * np.pi * f[c] * (x + 0.3 * c * y) + ph[c])
                                      for c in range(3)], -1)
        img = (base + rng.uniform(-0.2, 0.2, (n, n, 3))).astype(np.float32)
        tids.append(scene.add_texture(Texture(img, name=f"image{k}")))
    yy, xx = np.mgrid[0 : n // 2, 0 : n // 2].astype(np.float32) / (n // 2)
    gx = 0.35 * np.sin(2 * np.pi * 12 * xx) * np.cos(2 * np.pi * 9 * yy)
    gy = 0.35 * np.cos(2 * np.pi * 7 * xx) * np.sin(2 * np.pi * 11 * yy)
    nrm = np.stack([gx, gy, np.ones_like(gx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal_tid = scene.add_texture(Texture((nrm * 0.5 + 0.5).astype(np.float32), name="normal"))
    musgrave = scene.add_texture(Texture.musgrave(6.0, name="musgrave"))
    noise = scene.add_texture(Texture.random_noise(24.0, name="random"))
    ey, ex = np.mgrid[0:n // 2, 0:n].astype(np.float32)
    sky = np.stack([0.4 + 0.6 * (1 - ey / (n // 2)), 0.5 + 0.3 * np.sin(ex / n * 6 * np.pi),
                    np.full_like(ex, 0.9)], -1)
    env = Material.background((1.0, 1.0, 1.0), power=1.5, name="sky")
    env.emission_texture = scene.add_texture(
        Texture((sky * rng.uniform(0.8, 1.2, (n // 2, n, 1))).astype(np.float32), name="env"))
    scene.set_environment(env)

    def textured(color, tid, name, normal=-1):
        m = Material.diffuse(color, name=name)
        m.lobes[0].texture = tid
        m.normal_texture = normal
        return scene.add_material(m)

    walls = {"floor": textured((0.8, 0.8, 0.8), tids[0], "floor_tex", normal_tid),
             "ceiling": textured((0.8, 0.8, 0.8), tids[1], "ceiling_tex"),
             "back": textured((0.8, 0.8, 0.8), tids[2], "back_tex"),
             "left": textured((0.7, 0.1, 0.1), tids[3], "left_tex"),
             "right": textured((0.15, 0.6, 0.2), tids[3], "right_tex")}
    boxes = [textured((0.8, 0.8, 0.8), musgrave, "box_musgrave"),
             textured((0.8, 0.8, 0.8), noise, "box_random")]
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * 2.0
    for mesh in scene.meshes:
        if mesh.name in walls:
            mesh.material, mesh.uvs = walls[mesh.name], quad_uv
        elif mesh.name != "light":  # the two boxes
            v = mesh.vertices
            mesh.material = boxes.pop(0)
            mesh.uvs = np.stack([v[:, 0] + v[:, 2], v[:, 1]], -1).astype(np.float32)
    return scene


def heavy_film_checks(film, name, data):
    """Finite and lit; the pixels that miss the box show the textured
    environment (positive, and not one colour)."""
    c, alpha = film["color"], film["alpha"]
    check(np.isfinite(c).all(), f"{name}: film not finite")
    box, sky = c[alpha == 1.0], c[alpha == 0.0]
    check(len(box) and box.mean() > 0, f"{name}: the box is black")
    check(len(sky) and (sky > 0).all() and sky.std(axis=0).min() > 0,
          f"{name}: the environment is not seen, or is black or flat")
    atlas = data.tex_atlas
    check(data.has_textures and data.has_normal_maps and data.has_procedural,
          f"{name}: the scene lost a texture kind")
    return (f"mean {c.mean():.6f}, box pixels {len(box)} mean {box.mean():.6f}, "
            f"environment pixels {len(sky)} mean {sky.mean():.6f}; atlas "
            f"{tuple(atlas.shape)} {atlas.dtype} {atlas.numel() * atlas.element_size()} bytes, "
            f"{data.tex_info.shape[0]} textures x {data.tex_info.shape[1]} levels")


def f16_vs_f32(pt, heavy):
    """Phase 5: the texture-heavy scene's f16 atlas against its f32 atlas.
    Lookups upcast after the gather, so a sample differs by the texels'
    half-precision rounding. At depth 1 every path is the same in both
    films (camera rays and light samples do not depend on texels), so the
    JAX test's atol (tests/test_texture.py
    test_f16_atlas_matches_f32_render) holds on every pixel. At depth 4 a
    throughput moved by that rounding can flip a Russian-roulette
    decision, and a normal-mapped bounce a triangle edge, which changes
    that path's whole contribution: there the film means agree to 1e-4
    and at most F16_FLIPS of the pixels lie outside the atol (an H100 80GB
    HBM3 at 700 W gives 120 of 65,536, 0.18%). The JAX package's f16 film
    flips the same pixels (tests/test_torch_texture_heavy.py, run as a
    script)."""
    a, b = heavy["f32"][1], heavy["f16"][1]
    diff4 = np.abs(a - b).max(axis=-1)
    outside = int((diff4 > F16_ATOL).sum())
    check(np.isclose(a.mean(), b.mean(), rtol=1e-4),
          f"texture-heavy: f16 and f32 film means differ: {a.mean()} {b.mean()}")
    check(outside <= F16_FLIPS * diff4.size,
          f"texture-heavy depth 4: {outside} of {diff4.size} pixels differ by more than "
          f"{F16_ATOL} between the f16 and f32 films (at most {F16_FLIPS:.1%})")
    depth1 = []
    for dtype in ("f32", "f16"):
        r = heavy[dtype][0]
        opts = pt.Options(**{**r.options.__dict__, "path_depth": 1})
        depth1.append(pt.render_aovs(r.data, r.scene.camera, options=opts)["color"].cpu().numpy())
    diff1 = np.abs(depth1[0] - depth1[1]).max(axis=-1)
    check(float(diff1.max()) <= F16_ATOL,
          f"texture-heavy depth 1: the f16 film differs from the f32 one by {diff1.max()}")
    spp = heavy["f32"][0].options.samples_per_pixel
    return (f"texture-heavy f16 vs f32 film: depth 1 ({spp} spp) max |diff| {diff1.max():.3g} "
            f"(atol {F16_ATOL}); depth 4 max |diff| {diff4.max():.3g}, "
            f"{outside} of {diff4.size} pixels outside the atol, means "
            f"{a.mean():.6f} {b.mean():.6f}")


def lookups_card_vs_cpu(heavy, n=N_RAYS, seed=19):
    """Phase 5: the texture lookups on the texture-heavy scene's atlases
    (f32 and f16, as the renders built them on the card) against the same
    calls on the CPU, on seeded inputs: uv in [-2.5, 3.5] (the floor-mod
    wrap on both sides), texture ids from -1 to the last (the images, both
    procedurals, the environment), footprints whose level runs from below
    0 past the last, through sample_texture_any as the integrator calls
    it: bilinear, trilinear and anisotropic with 1 and 4 taps. Then
    direction_to_latlong_uv, and _hash01 bit for bit on lattice
    coordinates of either sign. rtol 1e-5, atol 1e-6 (and atol 1e-6 for
    the lat-long uv): tests/test_torch_texture.py's bounds against JAX."""
    from phosphorus_mk2_tpu_torch.core import texture as tex

    rs = np.random.default_rng(seed)
    uv = rs.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [-1e-7, 0.5], [0.5, 1 - 1e-7], [-0.25, -0.75],
              [2.0, -3.0], [0.999, 0.001], [1e-8, -1e-8]]
    minor = (2.0 ** rs.uniform(-14, 2, n)).astype(np.float32)
    ang, length = rs.uniform(0, 2 * np.pi, n), 2.0 ** rs.uniform(-12, 1, n)
    major = (np.stack([np.cos(ang), np.sin(ang)], -1) * length[:, None]).astype(np.float32)
    on = {"cuda": lambda a: torch.from_numpy(a).cuda(), "cpu": torch.from_numpy}
    out, worst = [], 0.0
    for dtype in ("f32", "f16"):
        data = heavy[dtype][0].data
        tables = {"atlas": data.tex_atlas, "info": data.tex_info, "proc": data.tex_proc,
                  "proc_params": data.tex_proc_params}
        tid = rs.integers(-1, data.tex_info.shape[0], n).astype(np.int32)
        check(set(data.tex_proc.cpu().numpy()[np.maximum(tid, 0)].tolist()) == {0, 1, 2},
              "the lookup inputs miss a texture kind")
        for mode in ("bilinear", "trilinear", "aniso 1", "aniso 4"):
            res = {}
            for d in ("cuda", "cpu"):
                fp = None if mode == "bilinear" else on[d](minor)
                if mode.startswith("aniso"):
                    fp = {"minor": fp, "major_uv": on[d](major), "taps": int(mode[-1])}
                res[d] = tex.sample_texture_any({k: v.to(d) for k, v in tables.items()},
                                                on[d](tid), on[d](uv), footprint=fp).cpu().numpy()
            diff = float(np.abs(res["cuda"] - res["cpu"]).max())
            worst = max(worst, diff)
            check(np.allclose(res["cuda"], res["cpu"], rtol=1e-5, atol=1e-6),
                  f"texture lookup {dtype} {mode}: the card differs from the CPU by {diff}")
        out.append(f"{dtype} {tuple(data.tex_atlas.shape)}")
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]
    ll = {k: tex.direction_to_latlong_uv(on[k](d)).cpu().numpy() for k in on}
    check(np.allclose(ll["cuda"], ll["cpu"], rtol=0, atol=1e-6),
          f"direction_to_latlong_uv: the card differs from the CPU by "
          f"{np.abs(ll['cuda'] - ll['cpu']).max()}")
    ix = rs.integers(-(2 ** 31), 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    iy = rs.integers(-300, 300, n).astype(np.int32)
    ix[:6] = [-1, 0, 1, -(2 ** 31), 2 ** 31 - 1, -7]
    h = {k: tex._hash01(on[k](ix), on[k](iy), 1).cpu().numpy().view(np.uint32) for k in on}
    check(np.array_equal(h["cuda"], h["cpu"]), "_hash01: the card's bits differ from the CPU's")
    return (f"texture lookups card vs CPU, {n} inputs, bilinear / trilinear / aniso 1 / "
            f"aniso 4 on atlases {', '.join(out)}: max |diff| {worst:.3g}; lat-long uv max |diff| "
            f"{np.abs(ll['cuda'] - ll['cpu']).max():.3g}; _hash01 bit-equal")


def heavy_card_vs_cpu(pt, scenes, size=64, spp=8):
    """Phase 5: the texture-heavy scene, small, rendered on the card and
    with device="cpu", both atlases, holds the card's texture lookups
    (floor-mod wrap, floor and log2 of the mip level, the int64 hash of
    the procedurals, the half-precision gather) to the CPU's at the CPU
    tests' tolerances (tests/test_torch_render.py): at depth 1 every
    pixel within rtol 1e-4, atol 1e-6 (the normal AOV atol 1e-5, alpha
    equal); at depth 4 at least 99% of the pixels within rtol 1e-3 and
    the image and channel means within 1e-3 relative. (Against the JAX
    package on the CPU, one depth-1 pixel of this scene can differ: a
    shadow ray that grazes the ceiling flips its occlusion on a
    last-place difference of the hit point, tests/test_torch_texture_heavy.py.
    Should such a pixel appear here, that is where to look first.)"""
    out = []
    for dtype in ("f32", "f16"):
        scene = texture_heavy_scene(scenes, dtype, size, size)
        opts = pt.Options(use_bvh=False, mis=True, aniso_taps=4, samples_per_pixel=spp,
                          samples_per_pass=4)
        made = {d: pt.Renderer(scene, opts, device=d) for d in ("cuda", "cpu")}
        for depth in (1, 4):
            o = pt.Options(**{**opts.__dict__, "path_depth": depth})
            got, want = ({k: v.cpu().numpy() for k, v in
                          pt.render_aovs(made[d].data, scene.camera, options=o).items()}
                         for d in ("cuda", "cpu"))
            g, w = got["color"], want["color"]
            name = f"texture-heavy {size}x{size} {dtype} depth {depth}"
            check(np.isfinite(g).all() and g.mean() > 0, f"{name}: card film not finite or black")
            diff = float(np.abs(g - w).max())
            if depth == 1:
                check(np.allclose(g, w, rtol=1e-4, atol=1e-6)
                      and np.allclose(got["alpha"], want["alpha"], rtol=1e-4, atol=1e-6)
                      and np.allclose(got["normal"], want["normal"], rtol=0, atol=1e-5),
                      f"{name}: the card's film differs from the CPU's by {diff}")
                out.append(f"{dtype} depth 1 max |diff| {diff:.3g}")
            else:
                within = float(np.isclose(g, w, rtol=1e-3, atol=1e-6).all(axis=-1).mean())
                check(within >= 0.99 and np.isclose(g.mean(), w.mean(), rtol=1e-3)
                      and np.allclose(g.mean(axis=(0, 1)), w.mean(axis=(0, 1)), rtol=1e-3),
                      f"{name}: {within} of the pixels within rtol 1e-3 of the CPU's, means "
                      f"{g.mean()} {w.mean()}")
                out.append(f"{dtype} depth 4 pixels within rtol 1e-3 {within:.6f}, max |diff| "
                           f"{diff:.3g}, means {g.mean():.6f} {w.mean():.6f}")
    return f"texture-heavy {size}x{size} {spp} spp, card vs CPU: " + "; ".join(out)


def resume_on_card(pt, scenes, zero, read):
    """Phase 5: checkpoint/resume through Renderer on the card. One pass
    of cornell_box 256x256 (8 spp, 2 a pass) with checkpoint_every=1; a
    new Renderer on the same directory renders the rest; the film equals
    an uninterrupted render's within atol 1e-6 (tests/test_renderer.py's
    bound). Then a resume with another spp target must be refused.
    zero() is called after the uninterrupted render and read() after the
    resumed one: returns (text, read()), the launches of the first pass
    and the resumed passes."""
    import shutil
    from pathlib import Path

    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(ck, ignore_errors=True)
    base = dict(use_bvh=False, samples_per_pixel=8, samples_per_pass=2, path_depth=4)
    full = pt.Renderer(scenes.cornell_box(256, 256), pt.Options(**base), device="cuda").render()
    zero()
    opts = pt.Options(**base, checkpoint_dir=str(ck), checkpoint_every=1)
    _, first = next(pt.Renderer(scenes.cornell_box(256, 256), opts, device="cuda").passes())
    check(first == 2 and (ck / "film_checkpoint.npz").exists(), "no checkpoint after one pass")
    films = list(pt.Renderer(scenes.cornell_box(256, 256), opts, device="cuda").passes())
    counts = read()
    check([d for _, d in films] == [4, 6, 8],
          f"the resume rendered passes {[d for _, d in films]}, not [4, 6, 8]")
    resumed = films[-1][0]
    diff = max(float(np.abs(resumed[k] - full[k]).max()) for k in full)
    check(all(np.allclose(resumed[k], full[k], rtol=0, atol=1e-6) for k in full),
          f"the resumed film differs from the uninterrupted one by {diff}")
    refused = ""
    try:
        pt.Renderer(scenes.cornell_box(256, 256),
                    pt.Options(**{**base, "samples_per_pixel": 16}, checkpoint_dir=str(ck)),
                    device="cuda").render()
    except RuntimeError as e:
        refused = str(e)
    check("different render" in refused, "a resume with another spp target was not refused")
    shutil.rmtree(ck, ignore_errors=True)
    return (f"resume cornell_box 256x256 8 spp, 2 a pass: 1 pass, then passes "
            f"{[d for _, d in films]} in a new Renderer; film max |diff| against the "
            f"uninterrupted render {diff:.3g}; a 16-spp resume refused: {refused[:60]}...",
            counts)


# the modules whose LAUNCHES the kernels line counts: accel/mt.py, front.py,
# wave.py and bsdf/kernel.py (set in run())
COUNTED = ()


def launch_keys():
    return {k: 0 for mod in COUNTED for k in mod.LAUNCHES}


def launches_now():
    return {k: v for mod in COUNTED for k, v in mod.LAUNCHES.items()}


def zero_counts(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def main_path(mt, front, wave, ct, probe, pt, scenes, dev):
    """Phase 5: the full-size renders through the Renderer entry point,
    then the row-gather probe through its own. Returns the launch counts
    summed over them and each render's colour film by label."""
    from phosphorus_mk2_tpu_torch.integrator.path import make_scene_tables

    brute = dict(samples_per_pixel=16, samples_per_pass=4)
    textured = dict(mis=True, aniso_taps=4, use_bvh=False, path_depth=4, **brute)
    configs = [
        # (label, scene, w, h, options, kernels that must launch, film checks:
        # "box", "terrain" or "heavy")
        ("cornell_box brute", lambda: scenes.cornell_box(256, 256), 256, 256,
         dict(use_bvh=False, use_pallas=True, path_depth=4, **brute),
         ("mt_closest", "mt_anyhit"), "box"),
        ("multi_bsdf_scene brute", lambda: scenes.multi_bsdf_scene(512, 512), 512, 512,
         dict(use_bvh=False, path_depth=9, **brute), ("mt_closest", "mt_anyhit"), "box"),
        ("terrain_scene bvh", lambda: scenes.terrain_scene(width=256, height=256), 256, 256,
         dict(use_bvh=True, path_depth=4, **brute), ("front_full", "wave_mt", "wave_sweep"),
         "terrain"),
        ("terrain_scene bvh sc_topk=pallas", lambda: scenes.terrain_scene(width=256, height=256),
         256, 256,
         dict(use_bvh=True, path_depth=2, samples_per_pixel=2, samples_per_pass=2,
              tracer_tune={"sc_topk": "pallas"}), ("front_slab_extract", "wave_mt"), "terrain"),
        ("multi_bsdf_scene bvh", lambda: scenes.multi_bsdf_scene(512, 512), 512, 512,
         dict(use_bvh=True, path_depth=9, **brute), ("wave_mt",), "box"),
        ("textured_terrain_scene bvh mis", lambda: scenes.textured_terrain_scene(
            grid=512, width=256, height=256), 256, 256,
         dict(use_bvh=True, mis=True, path_depth=4, **brute), ("front_full", "wave_mt"),
         "terrain"),
        ("texture-heavy cornell_box f32 brute", lambda: texture_heavy_scene(scenes, "f32"),
         256, 256, textured, ("mt_closest", "mt_anyhit"), "heavy"),
        ("texture-heavy cornell_box f16 brute", lambda: texture_heavy_scene(scenes, "f16"),
         256, 256, textured, ("mt_closest", "mt_anyhit"), "heavy"),
    ]
    totals = launch_keys()
    per_render, films, heavy = [], {}, {}
    for label, make, w, h, kw, expect, checks in configs:
        opts = pt.Options(**kw)
        scene = make()
        t0 = time.perf_counter()
        r = pt.Renderer(scene, opts, device="cuda")
        setup = time.perf_counter() - t0
        r.render()  # warm-up: allocator and first launches, not timed
        torch.cuda.synchronize()
        zero_counts(*COUNTED)
        for k in ct.STATS:
            ct.STATS[k] = 0
        t0 = time.perf_counter()
        film = r.render()  # returns host arrays: the device work is done
        secs = time.perf_counter() - t0
        counts = launches_now()
        traced = dict(ct.STATS)
        for k in expect:
            check(counts[k] > 0, f"{label}: kernel {k} was not launched on the main path")
        for k in counts:
            totals[k] += counts[k]
        rays = w * h * opts.samples_per_pixel * opts.path_depth * 2
        passes = math.ceil(opts.samples_per_pixel / opts.samples_per_pass)
        if checks == "terrain":
            env = r.data.emission[r.data.env_mat].cpu().numpy()
            stats = terrain_film_checks(film, label, env)
            bvh = r.data.bvh
            k, k2 = bvh["cluster_bmin"].shape[0], bvh["sc_bmin"].shape[0]
            # above HIT_ROW_MAX_TRIS the hit side shades from the attribute tables
            check("hit_f" not in make_scene_tables(r.data),
                  f"{label}: {r.data.num_tris} triangles, yet hit rows were built")
            stats += (f"; {r.data.num_tris} triangles, K {k} clusters, K2 {k2} superclusters, "
                      "no hit rows (the attribute tables)")
            check(k > 2048, f"{label}: K = {k} clusters do not take the hierarchical front table")
        elif checks == "heavy":
            stats = heavy_film_checks(film, label, r.data)
            heavy[scene.texture_dtype] = (r, film["color"])
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
    print(f16_vs_f32(pt, heavy), flush=True)
    print(lookups_card_vs_cpu(heavy), flush=True)
    print(heavy_card_vs_cpu(pt, scenes), flush=True)
    text, resume_counts = resume_on_card(
        pt, scenes, lambda: zero_counts(*COUNTED),
        lambda: launches_now())
    print(text, flush=True)
    check(resume_counts["mt_closest"] > 0, "the resumed render did not launch mt_closest")
    for k in resume_counts:
        totals[k] += resume_counts[k]
    per_render.append({"render": "resume cornell_box: first pass + resumed passes",
                       "launches": resume_counts})
    # the row-gather probe, as its command line runs it
    zero_counts(*COUNTED)
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
    return totals, films


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

    for name, w, h, depth, tune, mis in (("terrain_scene", 256, 256, 4, {}, False),
                                         ("multi_bsdf_scene", 512, 512, 9, {}, False),
                                         # a shallow front table: the fallback at many rays
                                         ("terrain_scene", 256, 256, 4, {"front_k": 8}, False),
                                         # textures and MIS on the cluster tracer
                                         ("textured_terrain_scene", 256, 256, 4, {}, True)):
        films = []
        for plain in (False, True):
            opts = pt.Options(use_bvh=True, samples_per_pixel=2, samples_per_pass=2,
                              path_depth=depth, mis=mis, tracer_tune={**tune, "plain": plain})
            extra = {"grid": 512} if name == "textured_terrain_scene" else {}
            films.append(pt.Renderer(getattr(scenes, name)(width=w, height=h, **extra), opts,
                                     device="cuda").render()["color"])
        diff = float(np.abs(films[0] - films[1]).max())
        print(f"{name} {w}x{h} 2 spp depth {depth} use_bvh=True mis={mis} {tune}: front and wave "
              f"kernels vs plain=True film max |diff| {diff:.3g}, mean {films[0].mean():.6f}",
              flush=True)
        check(np.allclose(films[0], films[1], rtol=1e-5, atol=0.0),
              f"{name}: the kernels' film differs from the plain=True film by {diff}")


TEXTURE_RANGES = ("texture_lookup", "texture_footprint")  # profiler ranges (texture_ranges)


def device_events(fn):
    """Run fn under torch.profiler; returns (wall seconds, device
    kernels, the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device side of a record_function range is an event too: not a kernel
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in TEXTURE_RANGES]
    return wall, kernels, prof


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
        wall, kernels, _ = device_events(fn)
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        s = ct.STATS
        print(f"profile {label} terrain_scene {p.shape[0]} rays: wall {wall:.6f} s, "
              f"{len(kernels)} device launches, device busy {busy:.6f} s, {s['waves']} waves, "
              f"{s['syncs']} host syncs, {s['fallback_rays']} exact-fallback rays", flush=True)


@contextlib.contextmanager
def texture_ranges():
    """--profile: wrap the texture lookups (bsdf._sample_any, the normal
    map's sample_texture) and the footprint (path._footprint) in
    torch.profiler ranges, so their device kernels can be counted. A
    function the port no longer has, or no longer calls through its
    module, is counted as 0 kernels and printed as not measured."""
    from torch.profiler import record_function

    from phosphorus_mk2_tpu_torch.bsdf import bsdf
    from phosphorus_mk2_tpu_torch.core import shading
    from phosphorus_mk2_tpu_torch.integrator import path

    def wrapped(fn, label):
        def call(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return call

    saved = [(bsdf, "_sample_any", "texture_lookup"), (shading, "sample_texture", "texture_lookup"),
             (path, "_footprint", "texture_footprint")]
    saved = [(mod, attr, getattr(mod, attr), label) for mod, attr, label in saved
             if hasattr(mod, attr)]
    for mod, attr, fn, label in saved:
        setattr(mod, attr, wrapped(fn, label))
    try:
        yield
    finally:
        for mod, attr, fn, _ in saved:
            setattr(mod, attr, fn)


def range_kernels(evt):
    """(kernels, device seconds) launched under a CPU event and its children."""
    n, t = len(evt.kernels), sum(k.duration for k in evt.kernels) / 1e6
    for child in evt.cpu_children:
        cn, ctime = range_kernels(child)
        n, t = n + cn, t + ctime
    return n, t


def profile_render(pt, ct, scenes):
    """--profile: one 4-spp pass of each main-path render under
    torch.profiler. Prints the device's busy and idle share over the span
    of its kernels, the kernel count, the kernels that take the most
    device time and, for the cluster tracer, waves and host syncs per
    trace; for the textured renders also the texture lookups' and the
    footprint's kernels, device time and launches per bounce-step."""
    textured = dict(mis=True)
    for name, make, w, h, depth, bvh, wavefront, kw in (
            ("cornell_box", scenes.cornell_box, 256, 256, 4, False, 0, {}),
            ("multi_bsdf_scene", scenes.multi_bsdf_scene, 512, 512, 9, False, 0, {}),
            ("terrain_scene", scenes.terrain_scene, 256, 256, 4, True, 0, {}),
            ("multi_bsdf_scene", scenes.multi_bsdf_scene, 512, 512, 9, True, 0, {}),
            # the brute tracer's wavefront for the cluster tracer: one chunk a pass, not 8
            ("multi_bsdf_scene", scenes.multi_bsdf_scene, 512, 512, 9, True, 1 << 20, {}),
            ("textured_terrain_scene",
             lambda width, height: scenes.textured_terrain_scene(grid=512, width=width,
                                                                 height=height),
             256, 256, 4, True, 0, textured),
            ("texture-heavy cornell_box",
             lambda width, height: texture_heavy_scene(scenes, "f32", width, height),
             256, 256, 4, False, 0, dict(textured, aniso_taps=4))):
        opts = pt.Options(use_bvh=bvh, samples_per_pixel=4, samples_per_pass=4,
                          path_depth=depth, max_wavefront=wavefront, **kw)
        r = pt.Renderer(make(width=w, height=h), opts, device="cuda")
        r.render()
        torch.cuda.synchronize()
        for k in ct.STATS:
            ct.STATS[k] = 0
        with texture_ranges() if kw else contextlib.nullcontext():
            wall, kernels, prof = device_events(r.render)
        tag = (f"profile {name} {w}x{h} 4 spp depth {depth} use_bvh={bvh}"
               + (f" max_wavefront={wavefront}" if wavefront else "")
               + "".join(f" {k}={v}" for k, v in kw.items()))
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
        chunks = math.ceil(w * h / r.max_wavefront)
        steps = 4 * chunks * depth  # bounce-steps of the pass
        print(f"{tag}: wall {wall:.6f} s, "
              f"{len(kernels)} kernels ({len(kernels) / steps:.1f} a bounce-step of {steps}), "
              f"device busy {busy:.6f} s over a span of {span:.6f} s "
              f"(idle share {1 - busy / span:.4f} of the span, {1 - busy / wall:.4f} of the wall)")
        if kw:
            for label in TEXTURE_RANGES:
                n, t = 0, 0.0
                for e in prof.events():
                    if e.name == label:
                        en, et = range_kernels(e)
                        n, t = n + en, t + et
                print(f"  {label}: {n} kernels ({n / steps:.1f} a bounce-step, "
                      f"{n / len(kernels):.4f} of the launches), device {t:.6f} s "
                      f"({t / busy:.4f} of the busy time)"
                      + ("; not linked to its kernels by the profiler: not measured"
                         if n == 0 else ""))
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


def sass_loops(mt, wave):
    """Phase 2: the MT kernels' inner loops, wave_mt's loop over a group's
    rays and wave_sweep's loop over a warp's rows (one per tile width) as
    compiled, from cuobjdump -sass of the built libraries; {} where the
    toolkit has no cuobjdump."""
    from phosphorus_mk2_tpu_torch.accel.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("sass: no cuobjdump beside nvcc; instructions a test not measured", flush=True)
        return {}
    sass = "\n".join(subprocess.run([tool, "-sass", lib.build()._name], capture_output=True,
                                    text=True, timeout=120).stdout for lib in (mt, wave))
    out = loop_counts(sass, mt.CLOSEST_RAYS, wave.WARP_TILE, wave.STAGED_TILE)
    for kname, c in out.items():
        print(f"sass {kname}: inner loop {c['loop_instructions']} instructions for {c['tests']} "
              f"tests, {c['per_test']:.2f} a test ({c['fp32']} FP32/MUFU, {c['lds']} LDS)"
              + (f", {c['per_pair']:.1f} a (ray, row) pair" if "per_pair" in c else ""),
              flush=True)
    return out


def loop_counts(sass, closest_rays, warp_tile, staged_tile):
    """Instructions of each MT kernel's innermost loop that holds the
    division (MUFU.RCP): mt_closest's column step (4 columns x
    closest_rays rays), mt_anyhit's ray step (4 columns a lane),
    wave_mt's step over a group's rays (4 triangles a lane, the warp
    reductions and the merge), and wave_sweep's: a warp a tile of R rays,
    its step over the warp's rows (a row fetch and 4 triangles a lane for
    each of the R rays: per_pair is the step over R); rows staged, a thread's
    step over one quad of staged triangles (4 tests a thread, 128 a warp:
    one (ray, row) pair a step).
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
    kernels = [
        ("mt_closest_kernel", "mt_closest_kernel", None, 4 * closest_rays, None),
        ("mt_anyhit_kernel", "mt_anyhit_kernel", None, 4, None),
    ]
    # the wave kernels, one instance a row type (float and bf16)
    for suffix, row_type in (("", "float"), (" bf16", "bf16")):
        kernels += [
            ("wave_mt_kernel" + suffix, "wave_mt_kernel", row_type, 4, None),
            # a warp a tile of r rays: r (ray, row) pairs a step of the warp;
            # rows staged: 4 triangles a thread, one pair a step of a warp
            (f"wave_sweep_kernel<{warp_tile}>" + suffix, "wave_sweep_warp_kernel", row_type,
             4 * warp_tile, warp_tile),
            (f"wave_sweep_kernel<{staged_tile}>" + suffix, "wave_sweep_staged_kernel", row_type,
             4, 1),
        ]
    for kname, pattern, row_type, tests, pairs in kernels:
        ins = next((v for k, v in funcs.items() if instance_of(k, pattern, row_type)), [])
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
        if pairs:
            out[kname]["per_pair"] = len(body) / pairs
    return out


def instance_of(fname, base, row_type):
    """Whether the (mangled or demangled) function name is kernel ``base``,
    and for a template on the row type its ``row_type`` ("float" or
    "bf16") instance."""
    if base not in fname:
        return False
    if row_type is None:
        return True
    after = fname[fname.index(base) + len(base):]
    if row_type == "bf16":
        return after.startswith(("I13__nv_bfloat16", "<__nv_bfloat16"))
    return after.startswith(("If", "<float"))


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
    from this run's inputs and the plain ms. front_full is timed as the
    tracer calls it, selecting kk = 32; its library time is torch.sort of
    the (n, jj * SC) candidate keys, the call whose work the selection
    took over (``front_all`` sorted those rows before).

    Bound: bytes = rays x (28 B in + 4 B per key out: jj + kk for
    front_full, jj for front_slab_extract) + the tables once; operations =
    per ray K2 slab tests + jj x K2 key compares + SC member slab tests
    per VALID parent (counted from these rays' parent keys)."""
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct
    from phosphorus_mk2_tpu_torch.tools.row_gather_probe import launch_ms

    out = []
    for name, bvh, p, d, tlim in cases:
        slab, full, jj = front_args(bvh, p, d, tlim)
        k2, sc = bvh["sc_member_bmin"].shape[:2]
        n = p.shape[0]
        kk = min(ct.MAX_FRONT, jj * sc)
        pk = front.front_slab_extract(*slab)
        nbits = front.parent_key_bits(k2)
        valid = int(((pk & -(1 << nbits)) < front.tmax_key(nbits)).sum())
        base_ops = n * (k2 * SLAB_OPS + jj * k2)
        ck = front.front_full(*full)[1]  # the candidate keys by column
        sort_ms = launch_ms(lambda: torch.sort(ck, dim=1))
        by_column_ms = launch_ms(lambda: front.front_full(*full))
        rows = []
        for kname, fn, plain, ops, keys, table_b, line, library in (
            ("front_full", lambda: front.front_full(*full, kk),
             lambda: front.front_full_plain(*full, kk=kk), base_ops + valid * sc * SLAB_OPS,
             jj + kk, k2 * 24 + k2 * sc * 24, "phosphorus_mk2_tpu/accel/pallas_front.py:136",
             sort_ms),
            ("front_slab_extract", lambda: front.front_slab_extract(*slab),
             lambda: front.front_slab_extract_plain(*slab), base_ops, jj, k2 * 24,
             "phosphorus_mk2_tpu/accel/pallas_front.py:36", None),
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
                "library_ms": library, "parity": True,
                "shape": (f"{n} rays x K2 {k2}, jj {jj}, SC {sc}"
                          + (f", kk {kk}" if kname == "front_full" else "") + f" ({name})"),
                "operations": ops, "valid_parents": valid,
            }
            if kname == "front_full":
                row["ms_by_column"] = by_column_ms
            rows.append(row)
            print(f"{kname} on {name}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
                  f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {ops} operations, "
                  f"{valid} valid parents, ops {ops_ms:.5f} ms, bytes {bytes_ms:.5f} ms)"
                  + (f"; library (torch.sort of the {n} x {jj * sc} candidate keys) "
                     f"{library:.4f} ms; the kernel writing every candidate by column "
                     f"{by_column_ms:.4f} ms" if library is not None else ""),
                  flush=True)
        out.append(rows)
    for name, rows in zip([c[0] for c in cases[1:]], out[1:]):
        print(json.dumps({f"kernels_{name}": rows}), flush=True)
    return out[0]


def wave_timing(wave, ct, probe, scenes, case, multi, launches, errs, dev, loop=None,
                clock=None, loop_bf16=None):
    """Phase 7, wave kernels. Bounds from this run's inputs.

    row_gather: the probe's geometry; bytes = each DISTINCT row read once
    (the indices are drawn with replacement) + every row written + the
    indices. wave_mt: waves 1 and 8 of a closest-hit trace of the case's
    rays (the state wave 8 meets is made by the kernel itself; the table
    is as warm in L2 as a trace leaves it); bytes = 28 a live pair (ray
    and id) + 8 a ray (tnear, best t) + 12 a winner written + the rows,
    given twice: each DISTINCT cluster's 4,608-byte row once (the table
    is one input, read once: the bound), and every live pair's row from
    device memory; operations = live pairs x 128 tests x 46; beside them
    wave_mt's issue floor, the instructions of its loop over a group's
    rays (``loop``, from phase 2) x live pairs over 4 warp-instructions a
    clock on every SM at ``clock`` MHz. wave_sweep: 8 rays x every
    cluster; bytes = the table once; operations = pairs x 128 x 46.
    At each wave, beside wave_mt: its bf16 instance on the bf16 rows
    (2,304 bytes a row in the bounds; issue floor from ``loop_bf16``), and
    both instances over the rays in ``dedup_order`` (the tracer's
    wave_dedup on the card; the order's sort timed apart), each with its
    plain version's time."""
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
    # of the terrain's rays, then the first of 131,072 rays on
    # multi_bsdf_scene's 56 clusters (the wavefront of its BVH renders)
    sms_blocks = wave.resident(wave.build(), dev)

    def time_wave(label, data, p, d, w_at):
        table = data.bvh["cluster_rows"]
        n = p.shape[0]
        tlim = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
        ttbl, ctbl = front_table(ct, data, p, d, tlim)
        state = fresh_state(tlim)
        out = []
        for w in range(max(w_at) + 1):
            col_t, col_c = ttbl[:, w : w + 1], ctbl[:, w : w + 1]
            if w not in w_at:
                wave.wave_mt(p, d, table, col_t, col_c, False, *state)
                continue
            saved = [x.clone() for x in state]

            def reset(saved=saved):
                for x, y in zip(state, saved):
                    x.copy_(y)

            live = wave.live_columns(col_t, state[0], state[1], False)[:, 0]
            pairs = int(live.sum())
            distinct = int(torch.unique(col_c[:, 0][live]).numel())
            g = wave.gate_plan(n, *sms_blocks)["g"]
            groups = wave.wave_groups(col_t, col_c, state[0], state[1], False,
                                      table.shape[0], g)
            ms_k = launch_ms(lambda: wave.wave_mt(p, d, table, col_t, col_c, False, *state),
                             before=reset)
            by_gate = {gate: launch_ms(lambda gate=gate: wave.wave_mt(
                p, d, table, col_t, col_c, False, *state, gate=gate), before=reset)
                for gate in wave.GATES}
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
            group_ms = (groups * row_b + rest) / H100_BYTES * 1e3
            # the bf16 rows and the dedup order, each against its plain version
            order = wave.dedup_order(col_c[:, 0], live)
            ms_order = launch_ms(lambda: wave.dedup_order(col_c[:, 0], live))
            variants, lines = {}, []
            for key, tbl, od, lp in (
                ("wave_mt_bf16", data.bvh["cluster_rows_bf16"], None, loop_bf16),
                ("wave_mt_ordered", table, order, loop),
                ("wave_mt_bf16_ordered", data.bvh["cluster_rows_bf16"], order, loop_bf16),
            ):
                gv = wave.gate_plan(n, *wave.resident(wave.build(), dev, tbl.dtype))["g"]
                groups_v = wave.wave_groups(col_t, col_c, saved[0], saved[1], False,
                                            tbl.shape[0], gv, order=od)
                ms_v = launch_ms(lambda tbl=tbl, od=od: wave.wave_mt(
                    p, d, tbl, col_t, col_c, False, *state, order=od), before=reset)
                ms_vp = launch_ms(lambda tbl=tbl, od=od: wave.wave_mt_plain(
                    p, d, tbl, col_t, col_c, False, *state, order=od), reps=3, before=reset)
                rb = tbl[0].numel() * tbl.element_size()
                ops_v = pairs * 128 * MT_OPS_PER_TEST / H100_FP32_OPS * 1e3
                l2_v = (distinct * rb + rest) / H100_BYTES * 1e3
                floor_v = (lp["loop_instructions"] * pairs / (4 * sms_blocks[0] * clock * 1e6)
                           * 1e3 if lp and clock else None)
                variants[key] = {
                    "ms": ms_v, "plain_ms": ms_vp, "gate": gv, "groups": groups_v,
                    "row_bytes": rb, "ops_ms": ops_v, "bound_ms": max(ops_v, l2_v),
                    "bound_ms_each_group_row_once": max(ops_v, (groups_v * rb + rest)
                                                        / H100_BYTES * 1e3),
                    "issue_floor_ms": floor_v,
                    **({"order_sort_ms": ms_order} if od is not None else {})}
                lines.append(f"  {key}: {ms_v:.5f} ms/launch at gate {gv} ({groups_v} groups), "
                             f"plain {ms_vp:.4f} ms; bound {max(ops_v, l2_v):.5f} ms ({rb} B a "
                             f"row, each distinct row once); issue floor "
                             + (f"{floor_v:.5f} ms" if floor_v else "not measured")
                             + (f"; dedup_order's sort {ms_order:.5f} ms" if od is not None
                                else ""))
            reset()
            wave.wave_mt(p, d, table, col_t, col_c, False, *state)  # the wave, once
            floor_ms = (loop["loop_instructions"] * pairs / (4 * sms_blocks[0] * clock * 1e6)
                        * 1e3 if loop and clock else None)
            out.append({"scene": label, "wave": w + 1, "rays": n, "live_pairs": pairs,
                        "live_share": pairs / n, "distinct_clusters": distinct, "gate": g,
                        "groups": groups, "winners": won, "ms": ms_k, "ms_by_gate": by_gate,
                        "plain_ms": ms_p, "variants": variants,
                        "ops_ms": ops_ms, "issue_floor_ms": floor_ms,
                        "bound_ms": max(ops_ms, l2_ms),
                        "bound_ms_each_group_row_once": max(ops_ms, group_ms),
                        "bound_ms_every_row_from_device_memory": max(ops_ms, hbm_ms)})
            print(f"wave_mt on {label}, wave {w + 1} of {n} rays: live share {pairs / n:.4f} "
                  f"({pairs} rows, {distinct} distinct clusters, {groups} groups at gate {g}), "
                  f"{won} winners; {ms_k:.5f} ms/launch (gate forced: " + ", ".join(
                      f"{gate} {t:.5f}" for gate, t in by_gate.items())
                  + f"), plain {ms_p:.4f} ms; bound "
                  f"{max(ops_ms, l2_ms):.5f} ms with each distinct row read once, "
                  f"{max(ops_ms, group_ms):.5f} ms with each group's row once, "
                  f"{max(ops_ms, hbm_ms):.5f} ms with every row from device memory (ops "
                  f"{ops_ms:.5f} ms); issue floor "
                  + (f"{floor_ms:.5f} ms" if floor_ms else "not measured"), flush=True)
            print("\n".join(lines), flush=True)  # the bf16 and ordered instances beside it
        return out

    name, data, p, d, _ = case
    k = data.bvh["cluster_rows"].shape[0]
    n = p.shape[0]
    waves = time_wave(name, data, p, d, (0, 7))
    # the same scene's camera rays in pixel order, as a render's wavefront
    # holds them: neighbouring rays share clusters
    waves += time_wave(f"{name} camera rays in pixel order", data,
                       *pixel_rays(scenes.terrain_scene(), dev), (0, 7))
    mp, md, _ = random_rays(14, 2 * N_RAYS, dev)
    waves += time_wave("multi_bsdf_scene", multi, mp, md, (0, 3))
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
    for key, ordered in (("wave_mt_bf16", ""), ("wave_mt_ordered", " in dedup_order"),
                         ("wave_mt_bf16_ordered", " in dedup_order")):
        v = first["variants"][key]
        rows.append({
            "name": key, "route": "cuda", "source": "phosphorus_mk2_tpu_torch/csrc/wave.cu",
            "replaces": "phosphorus_mk2_tpu/accel/cluster_traverse.py:680",
            # parity of the variants is phase 12's (a): it fills max_abs_err
            "launches": launches[key], "max_abs_err": errs.get(key),
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": "bytes" if v["bound_ms"] > v["ops_ms"] else "operations",
            "library_ms": None, "parity": True, "issue_floor_ms": v["issue_floor_ms"],
            "shape": f"{n} rays x 1 column{ordered}, K {k} clusters ({name}), wave 1, "
                     f"{v['row_bytes']} B rows",
            "waves": [{"scene": w["scene"], "wave": w["wave"], **w["variants"][key]}
                      for w in waves],
        })
    return rows


def sweep_shapes(n, device, seen, more=()):
    """The timed shapes of wave_sweep, (label, idx, state at the call):
    8 rays of a seeded set with best t T_MAX; the needy rays of phase 4's
    front_k 8 traces (``seen``, from ``fallback_inputs``): m is the mean
    of the traces' counts, the rays and state those the fallback met in
    the first trace that had at least m (its first m); 2,048 rays of the
    seeded set; then m rays of it for each m in ``more``."""
    far = torch.full((n,), T_MAX, dtype=torch.float32, device=device)

    def fresh():
        return [far.clone(), torch.full((n,), -1, dtype=torch.int32, device=device),
                torch.zeros((n,), dtype=torch.int32, device=device)]

    every = torch.from_numpy(np.random.RandomState(27).permutation(n).astype(np.int32)).to(device)
    m = round(sum(idx.shape[0] for idx, _ in seen) / max(len(seen), 1))
    out = [("8 rays", torch.arange(0, n, n // 8, dtype=torch.int32, device=device)[:8], fresh())]
    if m > 0:
        idx, state = next((i, s) for i, s in seen if i.shape[0] >= m)
        out.append((f"the needy rays of a front_k 8 trace (mean of {len(seen)})",
                    idx[:m].contiguous(), state))
    out.append(("2048 rays", every[:2048].contiguous(), fresh()))
    return out + [(f"{m} rays", every[:m].contiguous(), fresh()) for m in more]


def time_sweep(wave, p, d, table, idx, start, plain=True):
    """ms per call of wave_sweep at one shape, the state put back before
    each call; and of wave_sweep_plain unless plain is False (else None)."""
    from phosphorus_mk2_tpu_torch.tools.row_gather_probe import launch_ms

    state = [x.clone() for x in start]

    def reset():
        for x, y in zip(state, start):
            x.copy_(y)

    ms = launch_ms(lambda: wave.wave_sweep(p, d, table, idx, *state), before=reset)
    plain_ms = (launch_ms(lambda: wave.wave_sweep_plain(p, d, table, idx, *state), reps=3,
                          before=reset) if plain else None)
    return ms, plain_ms


def real_triangles(table):
    """Lanes of a (K, 9, 128) row table that hold a triangle: a non-zero
    edge (the rest are the pads past a cluster's triangles)."""
    return int((table[:, 3:9] != 0).any(dim=1).sum())


def sweep_timing(wave, table, p, d, needy, launches, errs, dev, sass, clock, table_bf16):
    """Phase 7, wave_sweep: every cluster of the terrain's table for the
    shapes of ``sweep_shapes`` (8 rays, phase 4's front_k 8 needy rays,
    2,048 rays), with the float32 rows and with the bf16 rows
    (``table_bf16``, its own instances). Bounds from each shape, over the
    table's real triangles (lanes with a non-zero edge), not its pads:
    bytes = the table once (4,608 or 2,304 bytes a row) + 44 a ray
    (index, origin, direction, best t in; a winner's t, cluster, lane
    out); operations = m x triangles x 46; the issue floor = the loop's
    instructions a (ray, row) pair of 128 tests (phase 2, the plan's
    tile, the instance's) x m x triangles / 128 over 4 warp-instructions
    a clock on every SM at the SM clock read under load, printed beside
    the floor over every lane of every row (m x K pairs). The kernels
    line carries the 8-ray shape of each row type, with the others
    beside it."""
    lib = wave.build()
    k, n = table.shape[0], p.shape[0]
    tris = real_triangles(table)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"wave_sweep table: {tris} triangles in {k} rows of {table.shape[2]} lanes", flush=True)
    rows = []
    for key, tbl, suffix in (("wave_sweep", table, ""), ("wave_sweep_bf16", table_bf16, " bf16")):
        row_b = tbl[0].numel() * tbl.element_size()
        out = []
        for label, idx, start in sweep_shapes(n, dev, needy):
            m = idx.shape[0]
            plan = wave.sweep_plan(m, k, *wave.sweep_resident(lib, dev, wave.sweep_tile(m),
                                                              tbl.dtype))
            ms, plain_ms = time_sweep(wave, p, d, tbl, idx, start)
            ops_ms = m * tris * MT_OPS_PER_TEST / H100_FP32_OPS * 1e3
            bytes_ms = (k * row_b + m * 44) / H100_BYTES * 1e3
            per_pair = sass.get(f"wave_sweep_kernel<{plan['tile']}>{suffix}", {}).get("per_pair")
            issue = 4 * sms * clock * 1e6 if clock else None
            floor_ms = (per_pair * m * tris / tbl.shape[2] / issue * 1e3
                        if per_pair and issue else None)
            lanes_ms = per_pair * m * k / issue * 1e3 if per_pair and issue else None
            out.append({"shape": f"{m} rays x K {k} clusters ({label})", "m": m, "ms": ms,
                        "plain_ms": plain_ms, "plan": plan, "triangles": tris,
                        "row_bytes": row_b, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                        "bound_ms": max(ops_ms, bytes_ms),
                        "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                        "issue_floor_ms": floor_ms, "issue_floor_ms_every_lane": lanes_ms,
                        "instructions_a_pair": per_pair})
            print(f"{key}, {m} rays x {k} clusters ({label}): {ms:.5f} ms/launch at tile "
                  f"{plan['tile']} ({plan['splits']} ranges, {plan['blocks']} blocks), plain "
                  f"{plain_ms:.4f} ms; bound {max(ops_ms, bytes_ms):.5f} ms (bytes "
                  f"{bytes_ms:.5f} at {row_b} B a row, ops {ops_ms:.5f}); issue floor " + (
                      f"{floor_ms:.5f} ms over the triangles ({ms / floor_ms:.3f}x), "
                      f"{lanes_ms:.5f} over every lane ({ms / lanes_ms:.3f}x); {per_pair:.1f} "
                      f"instructions a pair, {clock} MHz" if floor_ms else "not measured"),
                  flush=True)
        first = out[0]
        rows.append({
            "name": key, "route": "cuda",
            "source": "phosphorus_mk2_tpu_torch/csrc/wave.cu",
            "replaces": "phosphorus_mk2_tpu/accel/cluster_traverse.py:834",
            "launches": launches[key], "max_abs_err": errs.get(key),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None, "parity": True,
            "shape": first["shape"] + f", {row_b} B rows",
            "issue_floor_ms": first["issue_floor_ms"], "shapes": out,
        })
    return rows


def sweep_timing_only(more) -> int:
    """--sweep-timing: wave_sweep alone on the full-size terrain_scene, at
    the shapes of ``sweep_shapes`` (phase 4's front_k 8 traces run here
    to find the needy rays), then at m rays for each m in ``more``
    (without the plain version). Prints one JSON line: the package's
    path, the device, the needy rays per trace and per shape the ms per
    call of the kernel and of the plain version. With --package DIR it
    times the package of another checkout (its own csrc/wave.cu, built
    into that checkout) on the same inputs, so two designs can be
    compared in one run."""
    from phosphorus_mk2_tpu_torch import scenes
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct
    from phosphorus_mk2_tpu_torch.accel import wave
    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh

    dev = torch.device("cuda")
    terrain = scenes.terrain_scene()
    data = attach_bvh(terrain.build(device=dev), builder="native")
    table = data.bvh["cluster_rows"]
    p, d, tmax = trace_inputs(terrain, dev)
    with fallback_inputs(wave) as seen:
        ct.intersect_clusters(data, p, d, front_k=8)
        ct.occluded_clusters(data, p, d, tmax, front_k=8)
    rows = []
    timed = sweep_shapes(p.shape[0], dev, seen, more)
    for i, (label, idx, start) in enumerate(timed):
        ms, plain_ms = time_sweep(wave, p, d, table, idx, start,
                                  plain=i < len(timed) - len(more))
        rows.append({"shape": label, "m": idx.shape[0], "k": table.shape[0], "ms": ms,
                     "plain_ms": plain_ms})
    print(json.dumps({"package": wave.__file__, "device": torch.cuda.get_device_name(0),
                      "needy_per_trace": [idx.shape[0] for idx, _ in seen], "wave_sweep": rows}))
    return 0


def lanes_differ(a, b) -> int:
    """How many lanes of a and b differ in their bits (two NaNs agree)."""
    if a.is_floating_point():
        same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())
    else:
        same = a == b
    return int((~same.reshape(same.shape[0], -1).all(dim=1)).sum())


@contextlib.contextmanager
def eager_bsdf():
    """Every lobe container call on the eager lobe code (bsdf/lobes.py),
    as autograd's and the CPU's calls run, for a comparison with the
    kernel route."""
    from phosphorus_mk2_tpu_torch.bsdf import bsdf

    real = bsdf._kernel_route
    bsdf._kernel_route = lambda *args: "eager"
    try:
        yield
    finally:
        bsdf._kernel_route = real


def bsdf_timing(bk, pt, scenes, launches):
    """7b: the lobe container's kernels (csrc/bsdf.cu through
    bsdf/kernel.py) on the inputs of the main path's own calls: one
    no-grad pass of the Renderer on multi_bsdf_scene 512x512 and on
    cornell_box 256x256 with the benchmark cells' options (4 spp, MIS,
    the BVH; depth 9: 131,072 hits x 2 slots a chunk, and depth 2: 65,536
    hits x 1 slot),
    each entry's first and last call of the pass kept as it was handed
    over. On each: the kernel bit-equal to the eager code's dense dispatch
    (two NaNs agree), twice bit-equal, counted once a call; ms a call
    (CUDA events, the launch included) beside the bytes bound (each
    slot's type, flags, weight and three parameters, the count, the
    normal, the directions and the uniforms read once, the outputs
    written once, at 3.35 TB/s) and the eager code's ms as plain_ms.
    Returns the kernels line's rows, bsdf_eval and bsdf_sample at
    multi_bsdf_scene's first calls, with the other calls' times beside
    them."""
    from phosphorus_mk2_tpu_torch.bsdf import bsdf

    entries = {"bsdf_f": ("bsdf_eval", bsdf._bsdf_f_eager, 12),
               "bsdf_pdf": ("bsdf_eval", bsdf._bsdf_pdf_eager, 4),
               "bsdf_sample": ("bsdf_sample", bsdf._bsdf_sample_eager, 36)}
    real = {e: getattr(bk, e) for e in entries}
    kept = {}

    def keeper(label, entry):
        def call(*args):
            calls = kept.setdefault((label, entry), [])
            if len(calls) == 2:
                calls.pop()
            calls.append(args)
            return real[entry](*args)
        return call

    fwd = dict(samples_per_pixel=4, samples_per_pass=4)
    for label, scene, kw in (
            ("multi_bsdf_scene 512x512 depth 9", scenes.multi_bsdf_scene(512, 512),
             dict(use_bvh=True, mis=True, path_depth=9, **fwd)),
            ("cornell_box 256x256 depth 2", scenes.cornell_box(256, 256),
             dict(use_bvh=True, mis=True, path_depth=2, **fwd))):
        r = pt.Renderer(scene, pt.Options(**kw), device="cuda")
        for entry in entries:
            setattr(bk, entry, keeper(label, entry))
        try:
            r.render()
        finally:
            for entry in entries:
                setattr(bk, entry, real[entry])
    torch.cuda.synchronize()
    check(len(kept) == 6, f"bsdf: the passes did not call every entry: {sorted(kept)}")
    out = []
    for (label, entry), calls in kept.items():
        kname, eager, out_b = entries[entry]
        for which, args in zip(("first", "last"), calls):
            lobes, lanes = args[0], args[1].shape[0]
            slots = lobes.get("max_lobes", 8)
            k0, n0 = bk.LAUNCHES[kname], dict(bsdf.LAUNCHES)
            a, b = (tuple(x) if isinstance(x, tuple) else (x,)
                    for x in (real[entry](*args), real[entry](*args)))
            torch.cuda.synchronize()
            counted = bk.LAUNCHES[kname] - k0
            check(dict(bsdf.LAUNCHES) == n0, "bsdf: a direct kernel call counted a route")
            want = eager(*args)
            want = tuple(want) if isinstance(want, tuple) else (want,)
            differ = {"twice": sum(map(lanes_differ, a, b)),
                      "dense": sum(map(lanes_differ, a, want))}
            in_b = slots * (8 + 8 + 12 + 12) + 8 + 12 + 12 + (8 if entry == "bsdf_sample" else 12)
            row = {"name": kname, "route": "cuda",
                   "source": "phosphorus_mk2_tpu_torch/csrc/bsdf.cu",
                   "replaces": None, "launches": launches[kname],
                   "max_abs_err": 0.0 if not any(differ.values()) else None,
                   "ms": cuda_ms(lambda: real[entry](*args), 200),
                   "plain_ms": cuda_ms(lambda: eager(*args), 5),
                   "bound_ms": lanes * (in_b + out_b) / H100_BYTES * 1e3, "bound_by": "bytes",
                   "library_ms": None, "parity": not any(differ.values()),
                   "shape": f"{lanes} hits x {slots} slots ({label}, {entry}, {which} call)",
                   "entry": entry, "lanes_differ": differ, "counted": counted}
            print(f"{kname} ({entry}) {row['shape']}: lanes differing {differ}, counted "
                  f"{counted} for 2 calls; {row['ms']:.5f} ms/launch, bound "
                  f"{row['bound_ms']:.5f} ms (bytes), eager {row['plain_ms']:.4f} ms",
                  flush=True)
            check(counted == 2 and row["parity"], f"bsdf: {row}")
            out.append(row)
    rows = []
    for kname, entry in (("bsdf_eval", "bsdf_f"), ("bsdf_sample", "bsdf_sample")):
        head = next(r for r in out if r["entry"] == entry)
        head["other_shapes"] = [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                                for r in out if r["name"] == kname and r is not head]
        rows.append(head)
    print(json.dumps({"bsdf_kernels": out}), flush=True)
    return rows


def bsdf_grad_timing(bk, launches, dev):
    """7c: the kernel_grad route's kernels at multi_bsdf.inverse's shape,
    262,144 hits x 2 slots, the six lobe types of multi_bsdf_scene at
    random, a seeded incoming gradient: ms a call (CUDA events) of each
    SAVE forward beside its no-grad instantiation; bsdf_weight_grad for
    bsdf_f and for bsdf_sample, each from its SAVE forward's values,
    bit-equal to weight_grad_plain of saving_plain's values and to eager
    autograd's weight gradient (the dense dispatch), timed beside the
    bytes bound (the gradient in, the slot values, the scale and the bits
    read once, the gradient out written once, at 3.35 TB/s), the plain
    version and the eager call's forward and backward. Returns the
    kernels line's row."""
    from phosphorus_mk2_tpu_torch.bsdf import bsdf
    from phosphorus_mk2_tpu_torch.core.material import LOBE_FLAGS

    lanes, slots, six = 262144, 2, (1, 2, 3, 4, 5, 7)
    g = torch.Generator().manual_seed(2900)
    types = torch.tensor(six)[torch.randint(0, len(six), (lanes, slots), generator=g)]
    param = torch.rand((lanes, slots, 6), generator=g) * 0.9 + 0.05
    param[..., 2] = 1.0 + torch.rand((lanes, slots), generator=g)

    def unit():
        return torch.nn.functional.normalize(torch.randn((lanes, 3), generator=g), dim=-1)

    lobes = {"type": types,
             "flags": torch.tensor([LOBE_FLAGS.get(k, 0)
                                    for k in range(max(LOBE_FLAGS) + 1)])[types],
             "n": torch.randint(1, slots + 1, (lanes,), generator=g),
             "weight": torch.rand((lanes, slots, 3), generator=g), "param": param}
    lobes = {k: v.to(dev) for k, v in lobes.items()}
    lobes.update(present=six, max_lobes=slots)
    n, wi, wo = unit().to(dev), unit().to(dev), unit().to(dev)
    u2 = torch.rand((lanes, 2), generator=g).to(dev)
    grad = torch.randn((lanes, 3), generator=g).to(dev)
    b_in = 12 + 4 * slots + 4 + 4
    bound = lanes * (b_in + 12 * slots) / H100_BYTES * 1e3
    out = []
    for entry, sample, x in (("bsdf_f", False, wo), ("bsdf_sample", True, u2)):
        no_grad, saving = getattr(bk, entry), getattr(bk, entry + "_saving")
        eager = bsdf._bsdf_sample_eager if sample else bsdf._bsdf_f_eager
        _, saved = saving(lobes, n, wi, x)
        _, saved_p = bk.saving_plain(sample, lobes, n, wi, x)
        k0 = bk.LAUNCHES["bsdf_weight_grad"]
        got = bk.bsdf_weight_grad(grad, *saved, slots, sample)
        torch.cuda.synchronize()
        counted = bk.LAUNCHES["bsdf_weight_grad"] - k0

        def eager_fwd_bwd():
            w = lobes["weight"].clone().requires_grad_()
            res = eager(dict(lobes, weight=w), n, wi, x)
            return torch.autograd.grad(res[0] if sample else res, w, grad)[0]

        differ = {"plain": lanes_differ(got, bk.weight_grad_plain(grad, *saved_p, slots, sample)),
                  "autograd": lanes_differ(got, eager_fwd_bwd()),
                  "saved": sum(lanes_differ(a.reshape(lanes, -1), b.reshape(lanes, -1))
                               for a, b in zip(saved, saved_p))}
        row = {"name": "bsdf_weight_grad", "route": "cuda",
               "source": "phosphorus_mk2_tpu_torch/csrc/bsdf.cu", "replaces": None,
               "launches": launches["bsdf_weight_grad"],
               "max_abs_err": 0.0 if not any(differ.values()) else None,
               "ms": cuda_ms(lambda: bk.bsdf_weight_grad(grad, *saved, slots, sample), 200),
               "plain_ms": cuda_ms(lambda: bk.weight_grad_plain(grad, *saved, slots, sample), 20),
               "eager_fwd_bwd_ms": cuda_ms(eager_fwd_bwd, 5),
               "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
               "parity": not any(differ.values()),
               "shape": f"{lanes} hits x {slots} slots, six types at random ({entry})",
               "entry": entry, "lanes_differ": differ, "counted": counted,
               "forward_ms": {"no_grad": cuda_ms(lambda: no_grad(lobes, n, wi, x), 200),
                              "save": cuda_ms(lambda: saving(lobes, n, wi, x), 200)}}
        print(f"bsdf_weight_grad ({entry}) {row['shape']}: lanes differing {differ}, counted "
              f"{counted}; {row['ms']:.5f} ms/launch, bound {bound:.5f} ms (bytes), plain "
              f"{row['plain_ms']:.4f} ms, eager forward and backward "
              f"{row['eager_fwd_bwd_ms']:.4f} ms; the {entry} forward {row['forward_ms']}",
              flush=True)
        check(counted == 1 and row["parity"], f"bsdf_weight_grad: {row}")
        out.append(row)
    out[0]["other_shapes"] = [{k: out[1][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                      "forward_ms")}]
    print(json.dumps({"bsdf_weight_grad": out}), flush=True)
    return out[:1]


# ---------------------------------------------------------------------------
# phase 8: gradients and inverse rendering
# ---------------------------------------------------------------------------

GRAD_FIELDS = ("emission", "lobe_weight", "vertices")
# inverse rendering on the card (calibrated on the CPU at 64x64)
INV_STEPS = 30
INV_LR = 0.1
INV_SEED = 0


def grad_render(path, data, cam, w, h, spp, depth, tracer, fields, seed=0, mean=False, **kw):
    """One gradient render through render_pass: the loss color.sum()
    (mean=True: tests/test_grad.py's color.mean() / 2) and its gradients
    with respect to ``fields``, each a fresh leaf. Returns (film sums,
    {field: gradient or None})."""
    import dataclasses

    leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in fields}
    out = path.render_pass(dataclasses.replace(data, **leaves), cam, seed, 0, spp, width=w,
                           height=h, max_depth=depth, tracer=tracer, **kw)
    loss = out["color"].mean() / 2.0 if mean else out["color"].sum()
    loss.backward()
    return out["color"].detach(), {f: leaves[f].grad for f in fields}


def grad_err(a, b):
    """max |a - b| over b's max |b| (the absolute difference when b is all
    zero). Gradient tolerances on the card are relative to the field's
    scale: a backward that sums with atomics is not bit-stable from run
    to run (the indexing backward these renders take sorts its indices
    and is: PERF.md, run 8A)."""
    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    return err / scale if scale > 0 else err


def check_grads(label, got, ref, rel):
    errs = {}
    for f in ref:
        check(got[f] is not None and bool(torch.isfinite(got[f]).all()),
              f"{label}: the {f} gradient is missing or not finite")
        errs[f] = grad_err(got[f], ref[f])
        check(errs[f] <= rel, f"{label}: {f} gradients differ by {errs[f]:.3g} of their scale "
              f"(limit {rel})")
    return errs


def grads_kernels_vs_plain(path, scenes, terrain, terrain_data, dev):
    """8.1: gradients with the kernels and with their plain versions, both
    on the card: cornell_box 64x64 (brute) and the full-size terrain
    256x256 (cluster tracer); films at rtol 1e-5, gradients within 1e-4
    of each field's max |g|."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    scene = scenes.cornell_box(64, 64)
    data = scene.build(device=dev)
    cases = [("cornell_box 64x64 4 spp depth 4 brute", data,
              camera_to_params(scene.camera, dev), 64, 64, 4, 4,
              lambda plain: path.make_tracer(data, use_bvh=False, plain=plain)),
             ("terrain_scene 256x256 1 spp depth 2 use_bvh=True", terrain_data,
              camera_to_params(terrain.camera, dev), 256, 256, 1, 2,
              lambda plain: path.make_tracer(terrain_data, use_bvh=True, plain=plain))]
    for label, d, cam, w, h, spp, depth, tracer in cases:
        (f_k, g_k), (f_p, g_p) = (grad_render(path, d, cam, w, h, spp, depth, tracer(plain),
                                              GRAD_FIELDS) for plain in (False, True))
        diff = float((f_k - f_p).abs().max())
        check(torch.allclose(f_k, f_p, rtol=1e-5, atol=0.0),
              f"{label}: the kernels' film differs from the plain film by {diff}")
        errs = check_grads(label + " kernels vs plain", g_k, g_p, 1e-4)
        print(f"{label}, grad of color.sum(): kernels vs plain film max |diff| {diff:.3g}; "
              "gradients, max |diff| over the field's max |g|: "
              + ", ".join(f"{f} {e:.3g}" for f, e in errs.items()), flush=True)


def grads_card_vs_cpu(path, scenes, dev):
    """8.2: tests/test_grad.py's sphere_in_box 16x16 set-up (2 spp, depth
    2, seed 0, loss color.mean() / 2) on the card against the CPU, then
    its finite-difference checks on the card with its eps and tolerances."""
    import dataclasses

    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    scene = scenes.sphere_in_box(width=16, height=16)
    fields = path.SCOPABLE_FIELDS
    runs = {}
    for d in (dev, "cpu"):
        data = scene.build(device=d)
        cam = camera_to_params(scene.camera, d)
        tracer = path.make_tracer(data, use_bvh=False)
        runs[str(d)] = (data, cam, tracer,
                        grad_render(path, data, cam, 16, 16, 2, 2, tracer, fields, mean=True)[1])
    data, cam, tracer, g = runs[str(dev)]
    errs = check_grads("sphere_in_box card vs cpu", g, runs["cpu"][3], 1e-4)

    def mean_at(field, idx, x):
        a = getattr(data, field).clone()
        a[idx] = x
        with torch.no_grad():
            out = path.render_pass(dataclasses.replace(data, **{field: a}), cam, 0, 0, 2,
                                   width=16, height=16, max_depth=2, tracer=tracer)
        return float(out["color"].mean() / 2.0)

    def fd(field, idx, eps):
        x0 = float(getattr(data, field)[idx])
        return (mean_at(field, idx, x0 + eps) - mean_at(field, idx, x0 - eps)) / (2 * eps)

    v_idx = int(data.faces.cpu().numpy()[data.tri_mat.cpu().numpy() == 3][0, 0])
    fds = []
    for field, idx, eps, rtol, atol in (("emission", (3, 1), 1e-2, 5e-3, 1e-6),
                                        ("lobe_weight", (0, 0, 0), 1e-3, 2e-2, 1e-6),
                                        ("vertices", (v_idx, 1), 3e-4, 0.05, 1e-3)):
        gv, fv = float(g[field][idx]), fd(field, idx, eps)
        check(math.isfinite(gv) and abs(gv - fv) <= atol + rtol * abs(fv),
              f"sphere_in_box on the card: d/d {field}{idx} = {gv}, finite difference {fv}")
        if field != "vertices":
            check(gv > 0, f"sphere_in_box: d/d {field}{idx} = {gv} is not positive")
        fds.append(f"{field}{list(idx)} {gv:.6g} vs {fv:.6g} (eps {eps})")
    print("sphere_in_box 16x16 gradients, card vs cpu (max |diff| over max |g|): "
          + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
          + "; finite differences on the card: " + "; ".join(fds), flush=True)


def timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def profile_step(tag, fwd, bwd):
    """--profile: the forward of a gradient render (it builds the graph)
    and its backward, each under torch.profiler: kernels, device busy
    time and idle share, the largest kernels."""
    held = []
    for part, fn in (("forward", lambda: held.append(fwd())), ("backward", lambda: bwd(held[0]))):
        wall, kernels, _ = device_events(fn)
        if not kernels:
            print(f"profile {tag} {part}: no device events traced (wall {wall:.6f} s); "
                  "device time not measured", flush=True)
            continue
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels)) / 1e6
        by_name = {}
        for e in kernels:
            n, s = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, s + e.time_range.elapsed_us() / 1e6)
        print(f"profile {tag} {part}: wall {wall:.6f} s, {len(kernels)} kernels, device busy "
              f"{busy:.6f} s over a span of {span:.6f} s (idle share {1 - busy / span:.4f} of "
              f"the span, {1 - busy / wall:.4f} of the wall)", flush=True)
        for kname, (n, s) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"  {s:.6f} s {100 * s / busy:6.2f}% {n:6d}x  {kname[:110]}", flush=True)


def full_width_grads(path, scenes, dev, profile, count):
    """8.3: bench.py:73-132's headline shape, cornell_box 256x256, 16 spp,
    depth 4, the brute kernels: the forward, the gradient of color.sum()
    with respect to emission, lobe_weight and vertices, and the scoped
    gradient (trainable=emission, lobe_weight). The three timed calls are
    counted, the warm-ups before them and the profiled step after not."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    w = h = 256
    spp, depth = 16, 4
    scene = scenes.cornell_box(w, h)
    data = scene.build(device=dev)
    cam = camera_to_params(scene.camera, dev)
    tracer = path.make_tracer(data, use_bvh=False)
    rays = w * h * spp * depth * 2
    pair = ("emission", "lobe_weight")

    def fwd():
        with torch.no_grad():
            return path.render_pass(data, cam, 0, 0, spp, width=w, height=h, max_depth=depth,
                                    tracer=tracer)["color"]

    fwd()
    grad_render(path, data, cam, w, h, 1, depth, tracer, GRAD_FIELDS)  # warm-up
    (film, t_f, mem_f), n_f = count(lambda: timed(fwd))
    ((film_g, g), t_fb, mem_fb), n_fb = count(lambda: timed(
        lambda: grad_render(path, data, cam, w, h, spp, depth, tracer, GRAD_FIELDS)))
    ((_, gs), t_s, mem_s), n_s = count(lambda: timed(
        lambda: grad_render(path, data, cam, w, h, spp, depth, tracer, pair, trainable=pair)))
    check(torch.equal(film, film_g), "cornell_box: the gradient render's film is not the forward's")
    for f in GRAD_FIELDS:
        check(bool(torch.isfinite(g[f]).all()) and float(g[f].abs().max()) > 0,
              f"cornell_box 256x256: the {f} gradient is not finite or all zero")
    errs = check_grads("cornell_box 256x256 scoped vs unscoped", gs, {f: g[f] for f in pair}, 1e-4)
    res = {"rays": rays, "fwd_s": t_f, "fwd_rays_per_s": rays / t_f, "fwd_peak_bytes": mem_f,
           "fwd_bwd_s": t_fb, "fwd_bwd_rays_per_s": rays / t_fb, "fwd_bwd_peak_bytes": mem_fb,
           "scoped_s": t_s, "scoped_rays_per_s": rays / t_s, "scoped_peak_bytes": mem_s,
           "scoped_vs_full": errs, "launches": {"fwd": n_f, "fwd_bwd": n_fb, "scoped": n_s}}
    print(f"cornell_box {w}x{h} {spp} spp depth {depth} brute: forward {t_f:.6f} s "
          f"{rays / t_f / 1e6:.4f} Mrays/s (peak {mem_f} bytes); forward+backward "
          f"(emission, lobe_weight, vertices) {t_fb:.6f} s {rays / t_fb / 1e6:.4f} Mrays/s "
          f"(peak {mem_fb} bytes); scoped (emission, lobe_weight) {t_s:.6f} s "
          f"{rays / t_s / 1e6:.4f} Mrays/s (peak {mem_s} bytes); scoped vs unscoped "
          + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
          + f"; launches forward {n_f}, forward+backward {n_fb}, scoped {n_s}", flush=True)
    if profile:
        import dataclasses

        def graph():
            leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in GRAD_FIELDS}
            return path.render_pass(dataclasses.replace(data, **leaves), cam, 0, 0, 4, width=w,
                                    height=h, max_depth=depth, tracer=tracer)["color"].sum()

        profile_step(f"cornell_box {w}x{h} 4 spp depth {depth} gradient step", graph,
                     lambda loss: loss.backward())
    return res


def bvh_grads(path, ct, terrain, terrain_data, dev, count):
    """8.4: bench.py's bmw_fwd_bwd shape (a 1 << 16-pixel wavefront, 2 spp,
    depth 3, trainable=None) on the full-size
    terrain_scene 256x256 through the cluster tracer; the timed call is
    counted, the warm-up before it not."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    w, h, spp, depth = 256, 256, 2, 3
    check(w * h == 1 << 16, "the terrain's frame is not a 1 << 16-pixel wavefront")
    cam = camera_to_params(terrain.camera, dev)
    tracer = path.make_tracer(terrain_data, use_bvh=True)
    check(tracer[0].func is ct.intersect_clusters, "the terrain does not take the cluster tracer")
    grad_render(path, terrain_data, cam, w, h, 1, 1, tracer, GRAD_FIELDS)  # warm-up
    for k in ct.STATS:
        ct.STATS[k] = 0
    ((_, g), secs, mem), counts = count(lambda: timed(lambda: grad_render(
        path, terrain_data, cam, w, h, spp, depth, tracer, GRAD_FIELDS)))
    for f in GRAD_FIELDS:
        check(bool(torch.isfinite(g[f]).all()), f"terrain: the {f} gradient is not finite")
    check(float(g["emission"].abs().max()) > 0, "terrain: the emission gradient is all zero")
    check(counts["front_full"] > 0 and counts["wave_mt"] > 0,
          f"terrain gradient render: front or wave kernels not launched ({counts})")
    rays = w * h * spp * depth * 2
    s = dict(ct.STATS)
    print(f"terrain_scene {w}x{h} ({terrain_data.num_tris} triangles) {spp} spp depth {depth} "
          f"use_bvh=True, grad of color.sum() (emission, lobe_weight, vertices): {secs:.6f} s, "
          f"{rays / secs / 1e6:.4f} Mrays/s, peak {mem} bytes; launches {counts}; "
          f"{s['traces']} traces, {s['waves']} waves, {s['syncs']} host syncs, "
          f"{s['fallback_rays']} exact-fallback rays", flush=True)
    return {"rays": rays, "s": secs, "rays_per_s": rays / secs, "peak_bytes": mem,
            "launches": counts, "traced": s}


def lobe_routes_card(path, scenes, dev, count):
    """8.5: multi_bsdf_scene 512x512, depth 9, 2 spp, brute, no-grad
    forward on the eager lobe code and on the kernel route (csrc/bsdf.cu):
    the two films bit-equal; timed in turns (eager, kernel, kernel,
    eager). Then gradients (the eager code: the lobe parameters require
    grad) at 256x256, depth 2: finite and not all zero. The four timed forwards
    are counted; the warm-ups and the gradient render not."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    out = {}
    for w, h in ((512, 512), (256, 256)):
        scene = scenes.multi_bsdf_scene(w, h)
        data = scene.build(device=dev)
        check(len(data.lobe_types_present) > 2, "multi_bsdf_scene: two lobe types or fewer")
        cam = camera_to_params(scene.camera, dev)
        tracer = path.make_tracer(data, use_bvh=False)
        if w == 512:
            def fwd():
                with torch.no_grad():
                    return path.render_pass(data, cam, 0, 0, 2, width=w, height=h, max_depth=9,
                                            tracer=tracer)["color"]

            def eager():
                with eager_bsdf():
                    return fwd()

            routes = {"eager": eager, "kernel": fwd}
            for fn in routes.values():
                fn()  # warm-up
            films, secs, runs = {}, {k: [] for k in routes}, []
            for route in ("eager", "kernel", "kernel", "eager"):
                (films[route], t, _), n = count(lambda: timed(routes[route]))
                secs[route].append(t)
                runs.append({"route": route, "launches": n})
                k = n.get("bsdf_eval", 0) + n.get("bsdf_sample", 0)
                check((k > 0) == (route == "kernel"),
                      f"multi_bsdf_scene: the {route} forward launched {k} bsdf kernels")
            check(torch.equal(films["kernel"], films["eager"]),
                  f"multi_bsdf_scene: the kernel and eager films differ by "
                  f"{float((films['kernel'] - films['eager']).abs().max())}")
            rays = w * h * 2 * 9 * 2
            out = {"rays": rays, **{f"{k}_s": v for k, v in secs.items()},
                   **{f"{k}_rays_per_s": [rays / t for t in v] for k, v in secs.items()},
                   "launches": runs}
            print(f"multi_bsdf_scene {w}x{h} 2 spp depth 9 brute no-grad forward, Mrays/s in "
                  "turns: " + "; ".join(f"{k} " + ", ".join(f"{rays / t / 1e6:.4f}" for t in v)
                                        for k, v in secs.items())
                  + "; the two films bit-equal", flush=True)
        else:
            names = ("emission", "lobe_weight", "lobe_param")
            _, g = grad_render(path, data, cam, w, h, 2, 2, tracer, names)
            for f in names:
                check(bool(torch.isfinite(g[f]).all()), f"multi_bsdf_scene: the {f} gradient "
                      "is not finite")
                check(float(g[f].abs().max()) > 0, f"multi_bsdf_scene: the {f} gradient is zero")
            out["grad_max_abs"] = {f: float(g[f].abs().max()) for f in names}
            print(f"multi_bsdf_scene {w}x{h} 2 spp depth 2, grad of color.sum(): max |g| "
                  + ", ".join(f"{f} {v:.6g}" for f, v in out["grad_max_abs"].items()),
                  flush=True)
    return out


def inverse_rendering(pt, scenes, dev, count):
    """8.6: recover cornell_box's lamp from 0.3x its emission with
    InverseRenderer at 256x256 (emission and lobe_weight trainable, log
    emission, the unbiased loss, 8 spp, depth 3) against a target
    rendered on the card; tests/test_optim.py's criteria. Then the
    optimizer checkpoint: saved, resumed in a new InverseRenderer, 2 more
    steps equal to the uninterrupted run's within 1e-6. The timed steps
    are counted; the target render and the steps around the checkpoint
    not."""
    from pathlib import Path

    w = h = 256
    scene = scenes.cornell_box(w, h)
    lamp = [i for i, m in enumerate(scene.materials) if m.is_emitter][0]
    true_e = np.asarray(scene.materials[lamp].emission, np.float32)
    target = pt.Renderer(scene, pt.Options(use_bvh=False, samples_per_pixel=16,
                                           samples_per_pass=16, path_depth=3),
                         device="cuda").render()["color"]

    def make():
        s = scenes.cornell_box(w, h)
        s.materials[lamp].emission = tuple(0.3 * float(x) for x in true_e)
        return pt.InverseRenderer(s, target, trainable=("emission", "lobe_weight"),
                                  learning_rate=INV_LR, spp=8, max_depth=3, use_bvh=False,
                                  seed=INV_SEED, log_emission=True, unbiased_loss=True,
                                  device="cuda")

    inv = make()
    (losses, secs, mem), launches = count(lambda: timed(lambda: inv.run(INV_STEPS)))
    rec = inv.current_scene().emission[lamp].cpu().numpy()
    late = float(np.mean(losses[-10:]))
    rel = float(np.abs(rec / true_e - 1.0).max())
    check(late < 0.6 * losses[0], f"inverse rendering: late loss {late} is not below 0.6 x "
          f"the first {losses[0]}")
    check(rel <= 0.25, f"inverse rendering: lamp {rec} is {rel:.3g} from {true_e}")
    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_optimizer.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    inv.save_checkpoint(str(ck))
    inv.run(2)
    resumed = make()
    resumed.load_checkpoint(str(ck))
    resumed.run(2)
    diff = max(float((resumed.params[k] - inv.params[k]).detach().abs().max())
               for k in inv.params)
    check(diff <= 1e-6, f"the resumed run's parameters differ from the uninterrupted run's by "
          f"{diff}")
    ck.unlink()
    rays = w * h * 8 * 3 * 2
    per = secs / INV_STEPS
    print(f"inverse rendering cornell_box {w}x{h} 8 spp depth 3 (emission, lobe_weight; log "
          f"emission, unbiased loss, lr {INV_LR}): {INV_STEPS} steps {per:.6f} s a step, "
          f"{rays / per / 1e6:.4f} Mrays/s a step, peak {mem} bytes; loss {losses[0]:.6g} -> "
          f"mean of the last 10 {late:.6g}; lamp {rec.tolist()} against {true_e.tolist()} "
          f"(max rel err {rel:.4f}); resumed after a checkpoint, 2 steps: parameters within "
          f"{diff:.3g} of the uninterrupted run; launches of the {INV_STEPS} steps {launches}",
          flush=True)
    return {"steps": INV_STEPS, "s_per_step": per, "rays_per_s_per_step": rays / per,
            "peak_bytes": mem, "first_loss": losses[0], "late_loss": late,
            "lamp": rec.tolist(), "true_lamp": true_e.tolist(), "lamp_rel_err": rel,
            "resume_diff": diff, "launches": launches}


def launch_counter(mods, total):
    """count(fn) -> (fn(), launches): the launch counts of ``mods`` set to
    0 just before fn() and read just after it, and added to ``total``."""
    def count(fn):
        zero_counts(*mods)
        out = fn()
        got = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        for k, v in got.items():
            total[k] += v
        return out, got
    return count


def gradients_phase(pt, scenes, ct, mt, front, wave, terrain, terrain_data, dev, profile):
    """Phase 8. Its main path is the timed calls of 8.3-8.6, each counted
    from 0 just before and read just after; the comparisons with the
    plain versions (8.1) and with the CPU (8.2), the warm-ups, the
    references and the checkpoint's resume launch kernels that are not
    counted."""
    from phosphorus_mk2_tpu_torch.integrator import path

    grads_kernels_vs_plain(path, scenes, terrain, terrain_data, dev)
    grads_card_vs_cpu(path, scenes, dev)
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    summary = {
        "full_width": full_width_grads(path, scenes, dev, profile, count),
        "bvh": bvh_grads(path, ct, terrain, terrain_data, dev, count),
        "lobe_routes": lobe_routes_card(path, scenes, dev, count),
        "inverse_rendering": inverse_rendering(pt, scenes, dev, count),
    }
    for k in ("mt_closest", "mt_anyhit", "front_full", "wave_mt"):
        check(totals[k] > 0, f"phase 8: {k} was not launched")
    summary["launches_counted"] = totals
    print(json.dumps({"gradients": summary}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 9: scene I/O and the sharded render
# ---------------------------------------------------------------------------

BMW_TRIS = 887604          # tools/bmw_asset.py at scale 1.0
RANK_TIMEOUT = 600         # seconds for each spawned group of ranks


class BvhLog(logging.Handler):
    """Collects attach_bvh's (builder, seconds) log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.builds = []

    def emit(self, record):
        if record.msg.startswith("BVH:"):
            self.builds.append((record.args[0], record.args[3]))


def bmw_on_card(pt, dev, smi, count):
    """9a: the BMW asset written by the port's Alembic writer, imported by
    its reader, and rendered through Renderer(use_bvh=True) at bench.py's
    512x512 (4 spp, depth 4); then at 256x256, 1 spp, depth 2 the BVH film
    against the brute kernels' on >= 99.9% of the pixels (phase 5's limit
    for multi_bsdf_scene). The timed render and both 256x256 renders are
    counted."""
    import tempfile

    from phosphorus_mk2_tpu_torch.accel import bvh_builder
    from phosphorus_mk2_tpu_torch.tools import bmw_asset

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bmw.abc")
        t0 = time.perf_counter()
        bmw_asset.write_asset(path, scale=1.0)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        scene = bmw_asset.load_scene(path, 512, 512)
        t_import = time.perf_counter() - t0
    tris = sum(m.faces.shape[0] for m in scene.meshes)
    check(tris == BMW_TRIS, f"BMW: {tris} triangles imported, not {BMW_TRIS}")
    opts = pt.Options(use_bvh=True, samples_per_pixel=4, samples_per_pass=4, path_depth=4)
    bvh_log = BvhLog()
    bvh_builder.log.addHandler(bvh_log)
    bvh_builder.log.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        r = pt.Renderer(scene, opts, device=dev)
        t_setup = time.perf_counter() - t0
    finally:
        bvh_builder.log.removeHandler(bvh_log)
    check([b for b, _ in bvh_log.builds] == ["native"],
          f"BMW: the BVH builds were {bvh_log.builds}, not one native build")
    bvh = r.data.bvh
    k, k2 = bvh["cluster_bmin"].shape[0], bvh["sc_bmin"].shape[0]
    r.render()  # warm-up, not timed
    torch.cuda.synchronize()
    (film, secs), launches = count(lambda: timed_render(r))
    c = film["color"]
    check(np.isfinite(c).all() and c.mean() > 0, "BMW: film not finite or black")
    check((film["alpha"] > 0).any(), "BMW: nothing hit")
    rays = 512 * 512 * 4 * 4 * 2
    for kern in ("front_full", "wave_mt"):
        check(launches[kern] > 0, f"BMW: {kern} was not launched")

    cam = bmw_asset.make_camera(256, 256)
    small = {}
    for bvh_on in (True, False):
        o = pt.Options(use_bvh=bvh_on, samples_per_pixel=1, samples_per_pass=1, path_depth=2)
        out, got = count(lambda: pt.render_aovs(r.data, cam, options=o)["color"].cpu().numpy())
        small[bvh_on] = out
        for kern, n in got.items():
            launches[kern] += n
    for kern in ("mt_closest", "mt_anyhit"):
        check(launches[kern] > 0, f"BMW: {kern} was not launched by the brute render")
    a, b = small[True], small[False]
    close = float(np.isclose(a, b, rtol=1e-5, atol=1e-7).all(axis=-1).mean())
    check(close >= 0.999, f"BMW: only {close} of the BVH film's pixels match the brute film")
    print(f"BMW asset {tris} triangles, {len(scene.meshes)} meshes, {size} bytes; K {k} clusters, "
          f"K2 {k2} superclusters; write {t_write:.3f} s, import {t_import:.3f} s, BVH "
          f"(native) {bvh_log.builds[0][1]:.3f} s, Renderer set-up {t_setup:.3f} s; 512x512 4 spp "
          f"depth 4 use_bvh=True: {secs:.6f} s, {rays / secs:.1f} rays/s "
          f"({rays / secs / 1e6:.4f} Mrays/s), film mean {c.mean():.6f}; 256x256 1 spp depth 2 "
          f"BVH vs brute: pixels within rtol 1e-5 {close:.6f}, max |diff| "
          f"{np.abs(a - b).max():.3g}; launches {launches}; {smi}", flush=True)
    return {"triangles": tris, "meshes": len(scene.meshes), "bytes": size, "clusters": k,
            "superclusters": k2, "write_s": t_write, "import_s": t_import,
            "bvh_s": bvh_log.builds[0][1], "setup_s": t_setup, "render_s": secs,
            "rays_per_s": rays / secs, "bvh_vs_brute_pixels": close, "launches": launches}


def timed_render(r):
    t0 = time.perf_counter()
    film = r.render()  # returns host arrays: the device work is done
    return film, time.perf_counter() - t0


def yaml_exr_on_card(pt, dev, count):
    """9b: examples/cornell.yaml (with cornell.obj) through the port's
    importer, rendered at 64x64 on the card and on the CPU (the plain
    versions) at phase 5's card-against-CPU limits (depth 1: every pixel
    within rtol 1e-4, atol 1e-6; depth 4: >= 99% of the pixels within rtol
    1e-3 and the means within 1e-3); the card's film written with
    io/exr.write_film (float) and read back bit for bit. The card renders
    are counted."""
    import tempfile
    from pathlib import Path

    from phosphorus_mk2_tpu_torch.io.exr import read_exr, write_film
    from phosphorus_mk2_tpu_torch.io.yaml_scene import import_scene

    yaml_path = Path(__file__).resolve().parent / "examples" / "cornell.yaml"
    launches, out = None, []
    for depth in (1, 4):
        scene = import_scene(str(yaml_path))
        scene.camera.width = scene.camera.height = 64
        opts = pt.Options(use_bvh=False, samples_per_pixel=8, samples_per_pass=4, path_depth=depth)
        card, got = count(lambda: pt.Renderer(scene, opts, device=dev).render())
        launches = got if launches is None else {k: launches[k] + got[k] for k in got}
        cpu = pt.Renderer(scene, opts, device="cpu").render()
        g, w = card["color"], cpu["color"]
        check(np.isfinite(g).all() and g.mean() > 0, f"cornell.yaml depth {depth}: black film")
        diff = float(np.abs(g - w).max())
        if depth == 1:
            check(np.allclose(g, w, rtol=1e-4, atol=1e-6)
                  and np.allclose(card["alpha"], cpu["alpha"], rtol=1e-4, atol=1e-6),
                  f"cornell.yaml depth 1: the card's film differs from the CPU's by {diff}")
            out.append(f"depth 1 max |diff| {diff:.3g}")
        else:
            within = float(np.isclose(g, w, rtol=1e-3, atol=1e-6).all(axis=-1).mean())
            check(within >= 0.99 and np.isclose(g.mean(), w.mean(), rtol=1e-3),
                  f"cornell.yaml depth 4: {within} of the pixels within rtol 1e-3, means "
                  f"{g.mean()} {w.mean()}")
            out.append(f"depth 4 pixels within rtol 1e-3 {within:.6f}, max |diff| {diff:.3g}, "
                       f"means {g.mean():.6f} {w.mean():.6f}")
    check(launches["mt_closest"] > 0, "cornell.yaml: mt_closest was not launched")
    with tempfile.TemporaryDirectory() as tmp:
        exr = os.path.join(tmp, "film.exr")
        write_film(exr, card, pixel_type="float")
        back = read_exr(exr)
    same = all(np.array_equal(back[ch], card["color"][..., i]) for i, ch in enumerate("RGB"))
    same = same and np.array_equal(back["A"], card["alpha"])
    same = same and all(np.array_equal(back[f"normal.{ch}"], card["normal"][..., i])
                        for i, ch in enumerate("XYZ"))
    check(same, "cornell.yaml: the EXR read back differs from the film")
    print(f"examples/cornell.yaml 64x64 8 spp: {len(scene.meshes)} meshes, "
          f"{len(scene.materials)} materials; card vs CPU: " + "; ".join(out)
          + f"; EXR (float) read back bit for bit; launches {launches}", flush=True)
    return {"card_vs_cpu": out, "launches": launches}


def sharded_on_card(pt, scenes, dev, card, phase5_film, count):
    """9c: Renderer(n_devices=1) gives phase 5's cornell_box film bit for
    bit (counted); a world-size-1 NCCL group through parallel.initialize
    renders cornell_box 64x64 and runs an all-reduce and an all-gather on
    the card; two gloo ranks, both on cuda:0 (NCCL refuses two ranks on
    one card), render cornell_box 256x256 (brute) and terrain_scene
    256x256 (use_bvh=True): the all-gathered films bit-equal to one
    process's; and the gradient of color.sum() with respect to (emission,
    lobe_weight) on cornell_box 64x64 (4 spp, depth 4), all-reduced,
    within 1e-4 of each field's max |g| of one process's (phase 8's
    bound). A rank that fails fails the phase."""
    import tempfile

    from phosphorus_mk2_tpu_torch.parallel import make_wave_mesh
    from phosphorus_mk2_tpu_torch.tools import rank_parity

    five = dict(use_bvh=False, use_pallas=True, path_depth=4, samples_per_pixel=16,
                samples_per_pass=4)
    r = pt.Renderer(scenes.cornell_box(256, 256), pt.Options(**five), n_devices=1, device=dev)
    check(r.mesh.size == 1, f"n_devices=1 made a mesh of {r.mesh.size}")
    film, launches = count(r.render)
    check(np.array_equal(film["color"], phase5_film),
          "Renderer(n_devices=1) differs from phase 5's cornell_box film")

    box = {"scene": "cornell_box", "scene_kw": {"width": 64, "height": 64},
           "options": {"use_bvh": False, "samples_per_pixel": 4, "path_depth": 4}}
    nccl_job = {"device": card, "renders": [box]}
    gloo_job = {"device": card, "renders": [
        {"scene": "cornell_box", "scene_kw": {"width": 256, "height": 256},
         "options": {"use_bvh": False, "samples_per_pixel": 4, "path_depth": 4}},
        {"scene": "terrain_scene", "scene_kw": {"width": 256, "height": 256},
         "options": {"use_bvh": True, "samples_per_pixel": 2, "path_depth": 4}}],
        "grad": {"scene": "cornell_box", "scene_kw": {"width": 64, "height": 64},
                 "fields": ["emission", "lobe_weight"], "spp": 4, "depth": 4}}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        nccl = pool.submit(rank_parity.spawn, nccl_job, os.path.join(tmp, "nccl"), 1, "nccl",
                           RANK_TIMEOUT)
        gloo = pool.submit(rank_parity.spawn, gloo_job, os.path.join(tmp, "gloo"), 2, "gloo",
                           RANK_TIMEOUT)
        # the one-process references, meanwhile
        mesh = make_wave_mesh(1, card)
        refs = [rank_parity.render(spec, mesh) for spec in [box] + gloo_job["renders"]]
        ref_grad = rank_parity.grad(gloo_job["grad"], mesh)
        try:
            (one,), two = nccl.result(), gloo.result()
        except RuntimeError as e:
            raise PhaseError(f"sharded render: {e}") from e
    secs = time.perf_counter() - t0
    for k in ("color", "normal", "alpha"):
        check(np.array_equal(one[f"film0_{k}"], refs[0][k]),
              f"the world-size-1 NCCL group's {k} differs from one process's")
    x = np.arange(8, dtype=np.float32)
    check(np.array_equal(one["nccl_sum"], x) and np.array_equal(one["nccl_gather"], x),
          "NCCL all-reduce / all-gather on one rank changed the data")
    errs = {}
    for rank, res in enumerate(two):
        for i, ref in enumerate(refs[1:]):
            for k in ("color", "normal", "alpha"):
                check(np.array_equal(res[f"film{i}_{k}"], ref[k]),
                      f"rank {rank}: {gloo_job['renders'][i]['scene']} {k} differs from one "
                      f"process's (max |diff| {np.abs(res[f'film{i}_{k}'] - ref[k]).max()})")
        for f, g in ref_grad.items():
            scale = float(np.abs(g).max())
            err = float(np.abs(res[f"grad_{f}"] - g).max()) / max(scale, 1e-30)
            errs[f] = max(errs.get(f, 0.0), err)
            check(scale > 0 and err <= 1e-4, f"rank {rank}: the {f} gradient is {err:.3g} of "
                  f"its max |g| {scale} from one process's")
    print(f"sharded: Renderer(n_devices=1) cornell_box 256x256 16 spp equal to phase 5's film "
          f"bit for bit, launches {launches}; world-size-1 NCCL group: cornell_box 64x64 film "
          f"bit-equal, all-reduce and all-gather on the card exact; two gloo ranks on {card}: "
          f"cornell_box 256x256 4 spp (brute) and terrain_scene 256x256 2 spp (use_bvh=True) "
          f"all-gathered films bit-equal to one process's, gradient (emission, lobe_weight) "
          f"max err / max |g| " + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
          + f"; ranks and references {secs:.2f} s", flush=True)
    return {"grad_rel_err": errs, "ranks_s": secs, "launches": launches}


def scene_io_phase(pt, scenes, mt, front, wave, dev, smi, phase5_films):
    """Phase 9. Its main path is the counted calls of 9a-9c."""
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    summary = {
        "bmw": bmw_on_card(pt, dev, smi, count),
        "yaml_exr": yaml_exr_on_card(pt, dev, count),
        "sharded": sharded_on_card(pt, scenes, dev, f"cuda:{torch.cuda.current_device()}",
                                   phase5_films["cornell_box brute"], count),
    }
    for k in ("mt_closest", "mt_anyhit", "front_full", "wave_mt"):
        check(totals[k] > 0, f"phase 9: {k} was not launched")
    summary["launches_counted"] = totals
    print(json.dumps({"scene_io": summary}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 10: the CLI, the bench and the entry points
# ---------------------------------------------------------------------------

BENCH_METRICS = ("cornell_fwd_bwd_rays_per_sec", "cornell_bvh_renderer_fwd_rays_per_sec",
                 "bmw_live_fwd_rays_per_sec", "bmw_fwd_rays_per_sec",
                 "bmw_fwd_bwd_rays_per_sec", "bmw_fwd_bwd_scoped_emlw_rays_per_sec")
BENCH_TIMEOUT = 900        # seconds for the bench's process


def half(a):
    """A film as a half-float EXR holds it (io/exr.write_film's default)."""
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def exr_film(read_exr, path):
    ch = read_exr(path)
    return np.stack([ch["R"], ch["G"], ch["B"]], axis=-1), ch["A"]


def run_cli(cli, argv):
    """cli.main(argv) with its standard output captured and echoed:
    (return code, the output)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    print("\n".join("  cli: " + ln for ln in text.splitlines()), flush=True)
    return rc, text


def cli_on_card(pt, scenes, dev, phase5_film, count):
    """10a-c: the port's CLI on the card. (a) builtin:cornell_box 256x256
    -s 16 -d 4 --no-bvh -1: the EXR (half, zip) equal to phase 5's
    cornell_box film cast to float16, bit for bit; (b) examples/cornell.yaml
    128x128 -s 8 -d 4 --mis -1 against the same render through Renderer on
    the card, bit for bit; (c) --optimize against an EXR target rendered
    on the card: 4 steps with a checkpoint every 2, finite losses, the
    recovered npz with the JAX package's keys (the trainable fields), and
    a second call resuming at step 4. The CLI calls are counted."""
    import tempfile
    from pathlib import Path

    from phosphorus_mk2_tpu_torch import cli
    from phosphorus_mk2_tpu_torch.io.exr import read_exr, write_film
    from phosphorus_mk2_tpu_torch.io.yaml_scene import import_scene

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        exr = os.path.join(tmp, "box.exr")
        (rc, _), launches = count(lambda: run_cli(cli, [
            "builtin:cornell_box", "-o", exr, "--width", "256", "--height", "256",
            "-s", "16", "-d", "4", "--no-bvh", "-1", "-v"]))
        check(rc == 0, f"cli cornell_box returned {rc}")
        rgb, _ = exr_film(read_exr, exr)
        check(np.array_equal(rgb, half(phase5_film)),
              "the CLI's cornell_box EXR differs from phase 5's film cast to half "
              f"(max |diff| {np.abs(rgb - half(phase5_film)).max()})")
        out["a"] = launches

        yaml_path = Path(__file__).resolve().parent / "examples" / "cornell.yaml"
        exr = os.path.join(tmp, "yaml.exr")
        (rc, _), got = count(lambda: run_cli(cli, [
            str(yaml_path), "-o", exr, "--width", "128", "--height", "128", "-s", "8",
            "-d", "4", "--mis", "-1"]))
        check(rc == 0, f"cli cornell.yaml returned {rc}")
        scene = import_scene(str(yaml_path))
        scene.camera.width = scene.camera.height = 128
        ref = pt.Renderer(scene, pt.Options(samples_per_pixel=8, path_depth=4, mis=True),
                          n_devices=1, device=dev).render()
        rgb, alpha = exr_film(read_exr, exr)
        check(np.array_equal(rgb, half(ref["color"])) and np.array_equal(alpha, half(ref["alpha"])),
              "the CLI's cornell.yaml --mis EXR differs from Renderer's film cast to half "
              f"(max |diff| {np.abs(rgb - half(ref['color'])).max()})")
        check(ref["color"].mean() > 0, "cornell.yaml --mis: black film")
        out["b"] = got
        launches = {k: launches[k] + got[k] for k in launches}

        target = pt.Renderer(scenes.cornell_box(64, 64),
                             pt.Options(use_bvh=False, samples_per_pixel=16, path_depth=3),
                             device=dev).render()
        tgt = os.path.join(tmp, "target.exr")
        write_film(tgt, target)
        rec, ck = os.path.join(tmp, "rec.exr"), os.path.join(tmp, "ck")
        argv = ["builtin:cornell_box", "-o", rec, "-d", "3", "--spp-per-pass", "4", "--no-bvh",
                "--width", "64", "--height", "64", "--optimize", tgt, "--steps", "4",
                "--lr", "0.05", "--checkpoint-dir", ck, "--checkpoint-every", "2", "-v", "-1"]
        (rc, text), got = count(lambda: run_cli(cli, argv))
        check(rc == 0, f"cli --optimize returned {rc}")
        losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
        check(len(losses) == 4 and all(math.isfinite(x) for x in losses),
              f"cli --optimize losses {losses}")
        params = np.load(rec + ".params.npz")
        check(sorted(params.files) == ["emission", "lobe_weight"]
              and all(np.isfinite(params[k]).all() for k in params.files),
              f"cli --optimize wrote {params.files}")
        check(os.path.exists(os.path.join(ck, "optimizer.npz")), "no optimizer checkpoint")
        launches = {k: launches[k] + got[k] for k in launches}
        (rc, text), got = count(lambda: run_cli(cli, argv))
        check(rc == 0 and "resumed optimizer checkpoint at step 4" in text
              and "(0 steps)" in text, "the second --optimize call did not resume at step 4")
        launches = {k: launches[k] + got[k] for k in launches}
    print(f"cli: cornell_box 256x256 16 spp depth 4 EXR equal to phase 5's film as half, "
          f"launches {out['a']}; cornell.yaml 128x128 8 spp --mis EXR equal to Renderer's, "
          f"launches {out['b']}; --optimize 4 steps losses {losses}, npz keys "
          f"{sorted(params.files)}, resumed at step 4", flush=True)
    return {"losses": losses, "launches": launches}


def bench_on_card():
    """10d: ``python -m phosphorus_mk2_tpu_torch.bench --bmw`` in a child
    process: each line echoed as it comes; rc 0 and the six metrics in
    order, each with a value > 0, a device and no error. The child is
    killed at BENCH_TIMEOUT."""
    import threading
    from pathlib import Path

    import phosphorus_mk2_tpu_torch

    root = str(Path(phosphorus_mk2_tpu_torch.__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "phosphorus_mk2_tpu_torch.bench", "--bmw"],
                            cwd=root, env=env, stdout=subprocess.PIPE, text=True)
    killer = threading.Timer(BENCH_TIMEOUT, proc.kill)
    killer.start()
    lines = []
    try:
        for ln in proc.stdout:
            print(ln, end="", flush=True)
            if ln.startswith("{"):
                lines.append(json.loads(ln))
        rc = proc.wait()
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    check(rc == 0, f"the bench exited {rc} after {secs:.1f} s")
    check([ln.get("metric") for ln in lines] == list(BENCH_METRICS),
          f"the bench printed {[ln.get('metric') for ln in lines]}")
    for ln in lines:
        check("error" not in ln and ln.get("value", 0) > 0 and ln.get("device"),
              f"bench line {ln}")
    print(f"bench: six lines in {secs:.1f} s, rc 0", flush=True)
    return {"seconds": secs, "lines": lines}


def entries_on_card(dev, count):
    """10e: entry()'s forward step on the card (counted) against the same
    step on the CPU (the plain versions; 1 spp at depth 3: at least 99%
    of the pixels within rtol 1e-3, atol 1e-6, as the depth-4 limit of
    tests/test_torch_render.py; a flipped path moves the mean of 1,024
    one-sample pixels by ~1e-3, so the means within 1e-2), then
    dryrun_multichip(1) on the card (counted)."""
    from phosphorus_mk2_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry()
    got, launches = count(lambda: fn(*args).cpu().numpy())
    fn_c, args_c = entry("cpu")
    want = fn_c(*args_c).numpy()
    check(got.shape == (1024, 3) and np.isfinite(got).all() and got.mean() > 0,
          f"entry(): shape {got.shape}, mean {got.mean()}")
    within = float(np.isclose(got, want, rtol=1e-3, atol=1e-6).all(axis=-1).mean())
    check(within >= 0.99 and np.isclose(got.mean(), want.mean(), rtol=1e-2),
          f"entry(): card against CPU {within} of the pixels, means {got.mean()} {want.mean()}")
    t0 = time.perf_counter()
    res, got_d = count(lambda: dryrun_multichip(1))
    secs = time.perf_counter() - t0
    check(res["resumed_at"] == 1 and math.isfinite(res["loss"]), f"dryrun_multichip(1): {res}")
    print(f"entry(): cornell_box 32x32 depth 3 on the card, {within:.6f} of the pixels equal "
          f"to the CPU's within rtol 1e-3, launches {launches}; dryrun_multichip(1): "
          f"{res['tris']} triangles, loss {res['loss']:.6f}, {secs:.2f} s, launches {got_d}",
          flush=True)
    return {k: launches[k] + got_d[k] for k in launches}


def profile_on_card(pt, scenes, dev, count):
    """10f: utils.profiling.trace around one 4-spp pass of cornell_box
    64x64 (counted): the Chrome trace written, non-empty, with kernel
    events."""
    import tempfile

    from phosphorus_mk2_tpu_torch.utils.profiling import trace

    r = pt.Renderer(scenes.cornell_box(64, 64),
                    pt.Options(use_bvh=False, samples_per_pixel=4, path_depth=4), device=dev)
    r.render()  # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        def traced():
            with trace(tmp):
                r.render()
        _, launches = count(traced)
        files = [os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith(".json")]
        check(len(files) == 1 and os.path.getsize(files[0]) > 0, f"trace files {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "the trace holds no kernel events")
    print(f"profiling.trace: one cornell_box 64x64 pass, {size} bytes, {len(events)} events, "
          f"{kernels} kernels; launches {launches}", flush=True)
    return launches


def entry_points_phase(pt, scenes, mt, front, wave, dev, phase5_films):
    """Phase 10. Its main path is the counted calls of 10a-c, e and f; the
    bench (10d) runs in its own process and prints its own lines."""
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    summary = {
        "cli": cli_on_card(pt, scenes, dev, phase5_films["cornell_box brute"], count),
        "bench": bench_on_card(),
        "entries": entries_on_card(dev, count),
        "profiling": profile_on_card(pt, scenes, dev, count),
    }
    for k in ("mt_closest", "mt_anyhit", "front_full", "wave_mt"):
        check(totals[k] > 0, f"phase 10: {k} was not launched")
    summary["launches_counted"] = totals
    print(json.dumps({"entry_points": summary}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 11: the oracle tracers and the segment-sum row gather
# ---------------------------------------------------------------------------

ORACLE_TERRAIN_RAYS = N_RAYS  # the terrain's 256x256 camera rays
GATHER_REPS = 20


def pair_t(data, p, d, tri):
    """(t, valid) of each ray against its own triangle tri (N,), by the
    arithmetic of the MT kernels (intersect.mt_intersect_soa: one rounding
    an operation, in the kernels' order)."""
    from phosphorus_mk2_tpu_torch.accel.intersect import mt_intersect_soa

    f = data.faces[tri.clamp(min=0).long()].long()
    v = data.vertices
    a = v[f[:, 0]]
    e0, e1 = v[f[:, 1]] - a, v[f[:, 2]] - a
    col = lambda x: tuple(x[:, k : k + 1] for k in range(3))  # noqa: E731
    t, _, _, valid = mt_intersect_soa(col(p), col(d), col(a), col(e0), col(e1))
    return t[:, 0], valid[:, 0]


def oracles(data):
    """(name, closest(p, d), occluded(p, d, tmax), STATS or None, lane mask
    of a packed-key tie) of each scene-level oracle tracer."""
    from phosphorus_mk2_tpu_torch.accel import block_traverse, intersect, sort, traverse

    chunk = intersect._chunk_of(data.num_tris, None)
    return [
        ("per_ray", lambda p, d: traverse.intersect_bvh(data, p, d),
         lambda p, d, t: traverse.occluded_bvh(data, p, d, t), traverse.STATS, 0),
        ("block (sorted)", lambda p, d: sort.sorted_trace(block_traverse.intersect_blocks,
                                                          data, p, d, None),
         lambda p, d, t: sort.sorted_trace(block_traverse.occluded_blocks, data, p, d, t),
         block_traverse.STATS, 0),
        ("brute", lambda p, d: intersect.intersect_brute(data, p, d),
         lambda p, d, t: intersect.occluded_brute(data, p, d, t), None,
         (1 << max(1, (chunk - 1).bit_length())) - 1),
    ]


def wall(fn, stats=None):
    """fn() timed on the host clock (the lockstep loops sync every step),
    and the steps and syncs it took."""
    if stats is not None:
        for k in stats:
            stats[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, dict(stats) if stats is not None else {"steps": 0, "syncs": 0}


def oracles_vs_kernels(mt, label, data, p, d, tmax, count):
    """11a on one scene: each oracle tracer against mt_closest / mt_anyhit
    over all the scene's triangles. hit and occlusion equal; tri equal
    but for ties, counted: exact ties (both triangles' t bit-equal under
    the kernels' arithmetic, or for the brute oracle in one packed-key
    bucket) and edge ties (a ray through an edge that two triangles share:
    both hit, their t within 1e-6 relative, and a slab test or the sum
    order takes the other); t within 1e-5 (|t| + 0.01) where tri is equal
    (rtol 1e-5, and atol 1e-7 for a t near 0, which comes out of a
    cancelling dot product). The timed kernel calls are counted."""
    n = p.shape[0]
    table = mt.tri_table(data)
    cols = mt.live_columns(table)
    mt.mt_closest(table, p, d, cols=cols)  # warm-up
    ((t, tri, _, _), ms_c, _), _ = count(lambda: wall(lambda: mt.mt_closest(table, p, d,
                                                                            cols=cols)))
    (oref, ms_o, _), _ = count(lambda: wall(lambda: mt.mt_anyhit(table, p, d, tmax, cols=cols)))
    rows = {"kernels": {"closest_ms": ms_c * 1e3, "anyhit_ms": ms_o * 1e3,
                        "hits": int((tri >= 0).sum()), "occluded": int(oref.sum())}}
    print(f"{label}: {data.num_tris} tris, {n} rays: mt_closest {ms_c * 1e3:.4f} ms, mt_anyhit "
          f"{ms_o * 1e3:.4f} ms; {int((tri >= 0).sum())} hits, {int(oref.sum())} occluded",
          flush=True)
    for name, closest, occluded, stats, lane_mask in oracles(data):
        closest(p[:256], d[:256])  # warm-up: the first call of each eager kernel
        occluded(p[:256], d[:256], tmax[:256])
        got, sc, st_c = wall(lambda: closest(p, d), stats)
        occ, so, st_o = wall(lambda: occluded(p, d, tmax), stats)
        bad_hit = int((got["hit"] != (tri >= 0)).sum())
        bad_occ = int((occ != oref).sum())
        diff = (got["tri"] != tri) & (got["tri"] >= 0) & (tri >= 0)
        (ta, va), (tb, _) = pair_t(data, p, d, got["tri"]), pair_t(data, p, d, tri)
        bits = lambda x: x.view(torch.int32) & ~lane_mask  # noqa: E731
        exact = diff & (bits(ta) == bits(tb))
        edge = diff & ~exact & va & ((ta - tb).abs() <= 1e-6 * tb.abs())
        ties = exact | edge
        same = (got["tri"] == tri) & (tri >= 0)
        # |dt| over 1e-5 |t| + 1e-7: t near 0 (an origin on a face) comes out of a
        # cancelling dot product, with an absolute error of ~1e-8 whatever t is
        rel = lambda a, b: float(((a - b).abs() / (b.abs() + 1e-2)).max())  # noqa: E731
        t_err = rel(got["t"][same], t[same]) if bool(same.any()) else 0.0
        tie_err = rel(got["t"][ties], ta[ties]) if bool(ties.any()) else 0.0
        other = int((got["tri"] != tri).sum()) - int(ties.sum())
        rows[name] = {"closest_ms": sc * 1e3, "anyhit_ms": so * 1e3,
                      "closest_rays_per_s": n / sc, "anyhit_rays_per_s": n / so,
                      "steps": [st_c["steps"], st_o["steps"]],
                      "syncs": [st_c["syncs"], st_o["syncs"]],
                      "exact_ties": int(exact.sum()), "edge_ties": int(edge.sum()),
                      "t_err": t_err}
        print(f"  {name}: closest {sc * 1e3:.3f} ms ({n / sc:.1f} rays/s, {st_c['steps']} steps, "
              f"{st_c['syncs']} syncs), any-hit {so * 1e3:.3f} ms ({n / so:.1f} rays/s, "
              f"{st_o['steps']} steps, {st_o['syncs']} syncs); hit differs on {bad_hit}, "
              f"occlusion on {bad_occ}; tri differs on {int((got['tri'] != tri).sum())} rays: "
              f"exact ties {int(exact.sum())}, edge ties {int(edge.sum())}, other {other}; max "
              f"|dt| / (|t| + 0.01) {t_err:.3g} (ties: against their own triangle {tie_err:.3g})",
              flush=True)
        check(bad_hit == 0, f"{label} {name}: hit differs from mt_closest on {bad_hit} rays")
        check(bad_occ == 0, f"{label} {name}: occlusion differs from mt_anyhit on {bad_occ} rays")
        check(other == 0, f"{label} {name}: another triangle than mt_closest on {other} rays")
        # cornell_box's blocks stand on its floor: coplanar triangles, tied
        # wherever they overlap
        check(int(ties.sum()) <= n // 20, f"{label} {name}: {int(ties.sum())} ties: too many")
        check(max(t_err, tie_err) <= 1e-5, f"{label} {name}: t differs from the kernels' by "
              f"{max(t_err, tie_err)} of (|t| + 0.01)")
    return rows


def oracle_films(pt, scenes, dev, count):
    """11b: cornell_box 256x256, 4 spp, depth 4, with a BVH, through
    render_pass and make_tracer(kind="block") and kind="per_ray", each
    film against the brute kernels' (kind="brute", counted) on >= 99.9%
    of the pixels."""
    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import make_tracer, render_pass

    w = h = 256
    spp, depth = 4, 4
    scene = scenes.cornell_box(w, h)
    data = attach_bvh(scene.build(device=dev), builder="native")
    cam = camera_to_params(scene.camera, dev)

    def film(kind):
        with torch.no_grad():
            out = render_pass(data, cam, 0, 0, spp, width=w, height=h, max_depth=depth,
                              tracer=make_tracer(data, kind=kind))
        return out["color"].reshape(h, w, 3).cpu().numpy() / spp

    film("brute")  # warm-up
    (ref, secs, _), launches = count(lambda: wall(lambda: film("brute")))
    check(np.isfinite(ref).all() and ref.mean() > 0, "cornell_box brute film not finite or black")
    rays = w * h * spp * depth * 2
    out = {"brute": {"s": secs, "rays_per_s": rays / secs}}
    for kind in ("block", "per_ray"):
        img, secs, _ = wall(lambda: film(kind))
        close = float(np.isclose(img, ref, rtol=1e-5, atol=1e-7).all(axis=-1).mean())
        mx = float(np.abs(img - ref).max())
        out[kind] = {"s": secs, "rays_per_s": rays / secs, "pixels_equal": close,
                     "max_abs_diff": mx}
        print(f"cornell_box 256x256 4 spp depth 4 kind={kind}: {secs:.3f} s, "
              f"{rays / secs:.1f} rays/s; pixels within rtol 1e-5 of the brute film {close:.6f}, "
              f"max |diff| {mx:.3g}", flush=True)
        check(close >= 0.999, f"kind={kind}: only {close} of the pixels match the brute film")
    print(f"cornell_box 256x256 4 spp depth 4 kind=brute: {out['brute']['s']:.3f} s, "
          f"{out['brute']['rays_per_s']:.1f} rays/s; launches {launches}", flush=True)
    out["launches"] = launches
    return out


def cuda_ms(fn, reps=GATHER_REPS):
    """The median of reps timings of fn() with CUDA events, in ms."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def gather_rows_on_card(dev, width, hit_ids):
    """11c: gather_rows at cornell_box's shape, 65,536 indices into 36
    rows of the hit rows' width: the hit triangles of its 256x256 pixel
    rays (``hit_ids``, misses at row 0 as the integrator clamps them: a
    few rows take most indices) and uniform indices; and at the BMW's,
    262,144 uniform indices into 887,604 rows. The primal bit-equal to
    table[idx], both backwards within the CPU tests' rtol 1e-5 / atol
    1e-6 of table[idx]'s, two segsum backwards bit-equal; then each
    backward timed with CUDA events beside PyTorch's index backward.
    Nothing is wired, and nothing is claimed."""
    from phosphorus_mk2_tpu_torch.math.grad_gather import gather_rows

    out = {}
    cases = (("cornell_box hit ids", 36, hit_ids), ("cornell_box uniform", 36, N_RAYS),
             ("bmw uniform", BMW_TRIS, 4 * N_RAYS))
    for label, rows, idx in cases:
        g = torch.Generator(device=dev).manual_seed(rows)
        table = torch.rand((rows, width), device=dev, generator=g).requires_grad_()
        if isinstance(idx, int):
            idx = torch.randint(0, rows, (idx,), device=dev, generator=g)
        n = idx.shape[0]
        ct = torch.rand((n, width), device=dev, generator=g)
        fwd = {"segsum": gather_rows(table, idx, "segsum"),
               "scatter": gather_rows(table, idx, "scatter"), "index": table[idx]}
        check(torch.equal(fwd["segsum"], fwd["index"]) and torch.equal(fwd["scatter"],
                                                                         fwd["index"]),
              f"gather_rows {label}: the primal differs from table[idx]")
        grad = {k: torch.autograd.grad(v, table, ct, retain_graph=True)[0] for k, v in fwd.items()}
        again = torch.autograd.grad(fwd["segsum"], table, ct, retain_graph=True)[0]
        check(torch.equal(grad["segsum"], again), f"gather_rows {label}: two segsum backwards "
              "differ")
        for k in ("segsum", "scatter"):
            check(torch.allclose(grad[k], grad["index"], rtol=1e-5, atol=1e-6),
                  f"gather_rows {label}: the {k} gradient is off by "
                  f"{float((grad[k] - grad['index']).abs().max())}")
        ms = {k: cuda_ms(lambda v=v: torch.autograd.grad(v, table, ct, retain_graph=True))
              for k, v in fwd.items()}
        counts = torch.bincount(idx, minlength=rows)
        dup = 1.0 - int((counts > 0).sum()) / n
        out[label] = {"rows": rows, "indices": n, "width": width, "duplicate_share": dup,
                      "largest_run": int(counts.max()), "backward_ms": ms}
        print(f"gather_rows {label}: {n} indices into {rows} rows of {width} floats "
              f"(duplicate share {dup:.4f}, most on one row {int(counts.max())}); primal "
              f"bit-equal, segsum bit-stable; backward ms (median of {GATHER_REPS}): segsum "
              f"{ms['segsum']:.5f}, scatter {ms['scatter']:.5f}, table[idx] {ms['index']:.5f}",
              flush=True)
    return out


def oracle_phase(pt, scenes, mt, front, wave, terrain, terrain_data, dev, smi):
    """Phase 11. Its main path is the timed brute-kernel calls of 11a and
    the brute film of 11b, each counted from 0 just before and read just
    after; the oracle tracers run no hand kernel."""
    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
    from phosphorus_mk2_tpu_torch.integrator.path import make_scene_tables

    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    summary = {"tracers": {}}
    for i, name in enumerate(("cornell_box", "sphere_in_box")):
        data = attach_bvh(getattr(scenes, name)(64, 64).build(device=dev), builder="native")
        p, d, _ = random_rays(40 + i, N_RAYS, dev)
        summary["tracers"][name] = oracles_vs_kernels(mt, name, data, p, d,
                                                      mixed_limits(50 + i, N_RAYS, dev), count)
    p, d = pixel_rays(terrain, dev)
    p, d = p[:ORACLE_TERRAIN_RAYS].contiguous(), d[:ORACLE_TERRAIN_RAYS].contiguous()
    summary["tracers"]["terrain_scene"] = oracles_vs_kernels(
        mt, "terrain_scene", terrain_data, p, d, mixed_limits(52, p.shape[0], dev), count)
    summary["films"] = oracle_films(pt, scenes, dev, count)
    box = scenes.cornell_box(256, 256)
    box_data = box.build(device=dev)
    width = make_scene_tables(box_data)["hit_f"].shape[1]
    hit_ids = mt.mt_closest(mt.tri_table(box_data), *pixel_rays(box, dev))[1].clamp(min=0).long()
    summary["gather_rows"] = gather_rows_on_card(dev, width, hit_ids)
    for k in ("mt_closest", "mt_anyhit"):
        check(totals[k] > 0, f"phase 11: {k} was not launched")
    summary["launches_counted"] = totals
    summary["device"] = smi
    print(json.dumps({"oracles": summary}), flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 12: the cluster tracer's four tunables
# ---------------------------------------------------------------------------

BMW_LIVE_RAYS = 1 << 17  # bench.py's bmw_live: the first 256 rows of 512x512 pixel centres
TUNE_TURNS = 3           # timed turns of a tunable against the default, in one run
# tracer_tune -> exact: the same winners as the default but for exact-t ties
EXACT_TUNES = {
    "slab_bf16 (sc_topk auto)": {"slab_bf16": True},
    "slab_bf16 sc_topk extract": {"slab_bf16": True, "sc_topk": "extract"},
    "front_levels 3": {"front_levels": 3},
    "wave_dedup gather": {"wave_dedup": "gather"},
    "wave_dedup onehot": {"wave_dedup": "onehot"},
    "all exact": {"slab_bf16": True, "front_levels": 3, "wave_dedup": "gather"},
}
BF16_TUNES = {
    "rows_bf16": {"rows_bf16": True},
    "rows_bf16 wave_dedup gather": {"rows_bf16": True, "wave_dedup": "gather"},
}
NEW_KERNELS = ("wave_mt_bf16", "wave_mt_ordered", "wave_mt_bf16_ordered", "wave_sweep_bf16")


def state_at(wave, data, p, d, ttbl, ctbl, w):
    """The state a closest-hit trace's wave w meets (the waves before it
    run by the float32 kernel), with the columns of wave w."""
    state = fresh_state(torch.full((p.shape[0],), T_MAX, dtype=torch.float32, device=p.device))
    for j in range(w):
        wave.wave_mt(p, d, data.bvh["cluster_rows"], ttbl[:, j : j + 1], ctbl[:, j : j + 1],
                     False, *state)
    return state, ttbl[:, w : w + 1], ctbl[:, w : w + 1]


def tunables_parity(wave, ct, waves, sweep_case, dev):
    """12a: the new kernel instances against their plain versions on the
    card, bit for bit (t, cluster and lane bits). waves: (label, data, p,
    d, wave indices): wave_mt on the bf16 rows at the plan's gate and at
    every gate forced, beside wave_mt_plain on the bf16 rows and its
    gate= walk; then wave_mt over dedup_order's rays against no order,
    with both row types. sweep_case: (label, data, p, d, best t): the
    bf16 wave_sweep at 8 and 16 rays (a warp a tile) and 448 and 2,048
    (rows staged) against wave_sweep_plain and its plan= walk. Returns
    the largest absolute t difference of each instance, and the rows
    wave_mt fetched with and without the order."""
    err = {k: 0.0 for k in NEW_KERNELS}
    fetched = []

    def agree(kname, label, got, want):
        bad = [int((bits(g) != bits(w)).sum()) if g.dtype == torch.float32
               else int((g != w).sum()) for g, w in zip(got, want)]
        hits = int((want[1] >= 0).sum())
        print(f"{kname} {label}: {hits} rays hold a hit; mismatches t {bad[0]} cluster "
              f"{bad[1]} lane {bad[2]}", flush=True)
        check(sum(bad) == 0, f"{kname} disagrees with its plain version on {label}")
        err[kname] = max(err[kname], float((got[0] - want[0]).abs().max()))
        return hits

    lib = wave.build()
    for label, data, p, d, at in waves:
        n = p.shape[0]
        hits = 0  # rays holding a hit after the tested waves: no test without
        f32, bf = data.bvh["cluster_rows"], data.bvh["cluster_rows_bf16"]
        k = f32.shape[0]
        tlim = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
        ttbl, ctbl = front_table(ct, data, p, d, tlim)
        for w in at:
            start, col_t, col_c = state_at(wave, data, p, d, ttbl, ctbl, w)
            tag = f"on {label}, wave {w + 1} of {n} rays"
            want = [x.clone() for x in start]
            wave.wave_mt_plain(p, d, bf, col_t, col_c, False, *want)
            for gate in (None, *wave.GATES):
                got = [x.clone() for x in start]
                wave.wave_mt(p, d, bf, col_t, col_c, False, *got, gate=gate)
                g = gate or wave.gate_plan(n, *wave.resident(lib, dev, bf.dtype))["g"]
                walked = [x.clone() for x in start]
                wave.wave_mt_plain(p, d, bf, col_t, col_c, False, *walked, gate=g)
                torch.cuda.synchronize()
                hits += agree("wave_mt_bf16", f"{tag}, gate {g}{'' if gate else ' (plan)'}", got,
                              want)
                check(all(torch.equal(a, b) for a, b in zip(walked, want)),
                      f"wave_mt_plain(gate={g}) on the bf16 rows differs from the uncut walk "
                      f"{tag}")
            live = wave.live_columns(col_t[:, 0], start[0], start[1], False)
            order = wave.dedup_order(col_c[:, 0], live)
            for key, tbl in (("wave_mt_ordered", f32), ("wave_mt_bf16_ordered", bf)):
                plain = [x.clone() for x in start]
                wave.wave_mt_plain(p, d, tbl, col_t, col_c, False, *plain)
                unordered = [x.clone() for x in start]
                wave.wave_mt(p, d, tbl, col_t, col_c, False, *unordered)
                got = [x.clone() for x in start]
                wave.wave_mt(p, d, tbl, col_t, col_c, False, *got, order=order)
                torch.cuda.synchronize()
                hits += agree(key, f"{tag}, {tbl.dtype} rows, in dedup_order", got, plain)
                check(all(torch.equal(a, b) for a, b in zip(got, unordered)),
                      f"{key} {tag}: the ordered launch differs from the unordered one")
            g = wave.gate_plan(n, *wave.resident(lib, dev))["g"]
            rows = {od is not None: wave.wave_groups(col_t, col_c, start[0], start[1], False, k,
                                                     g, order=od) for od in (None, order)}
            pairs = int(live.sum())
            distinct = int(torch.unique(col_c[:, 0][live]).numel())
            fetched.append({"wave": f"{label}, wave {w + 1}", "rays": n, "live_pairs": pairs,
                            "distinct": distinct, "gate": g, "rows_unordered": rows[False],
                            "rows_ordered": rows[True]})
            print(f"wave_mt rows fetched {tag} at gate {g}: {rows[False]} in ray order, "
                  f"{rows[True]} in dedup_order ({rows[False] / max(rows[True], 1):.3f}x fewer); "
                  f"{pairs} live rays on {distinct} distinct clusters", flush=True)
        check(hits > 0, f"wave_mt parity on {label}: no ray holds a hit, no test")
    label, data, p, d, lim = sweep_case
    bf = data.bvh["cluster_rows_bf16"]
    k = bf.shape[0]
    every = torch.from_numpy(np.random.RandomState(31).permutation(p.shape[0])[:2048]
                             .astype(np.int32)).to(dev)
    for m in (8, 16, 448, 2048):
        idx = every[:m].contiguous()
        want = fresh_state(lim)
        wave.wave_sweep_plain(p, d, bf, idx, *want)
        got = fresh_state(lim)
        wave.wave_sweep(p, d, bf, idx, *got)
        plan = wave.sweep_plan(m, k, *wave.sweep_resident(lib, dev, wave.sweep_tile(m), bf.dtype))
        walked = fresh_state(lim)
        wave.wave_sweep_plain(p, d, bf, idx, *walked, plan=plan)
        torch.cuda.synchronize()
        hits = agree("wave_sweep_bf16", f"{m} rays x {k} clusters of {label}, tile "
                     f"{plan['tile']}, {plan['splits']} ranges", got, want)
        check(hits > 0, f"wave_sweep_bf16 at {m} rays: no ray hits, no test")
        check(all(torch.equal(a, b) for a, b in zip(walked, want)),
              f"wave_sweep_plain(plan=) on the bf16 rows differs from the uncut walk at {m}")
    return err, fetched


@contextlib.contextmanager
def rows_fetched(wave):
    """Counts, over the wave_mt calls made inside, the live (ray, column)
    pairs, the distinct clusters a call's rays want (summed over the
    calls) and the rows the kernel fetches (``wave_groups`` at the call's
    gate and order). Yields the dict of counts."""
    counts = {"calls": 0, "live_pairs": 0, "distinct": 0, "rows": 0}
    launch = wave.wave_mt

    def counted(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, gate=None,
                order=None):
        live = wave._gated_columns(col_t, col_c, best_t, best_c, any_hit, table.shape[0])
        g = gate or wave.gate_plan(p.shape[0] if order is None else order.shape[0],
                                   *wave.resident(wave.build(), p.device, table.dtype))["g"]
        counts["calls"] += 1
        counts["live_pairs"] += int(live.sum())
        counts["distinct"] += sum(int(torch.unique(col_c[:, j][live[:, j]]).numel())
                                  for j in range(col_c.shape[1]))
        counts["rows"] += wave.wave_groups(col_t, col_c, best_t, best_c, any_hit,
                                           table.shape[0], g, order=order)
        return launch(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, gate=gate,
                      order=order)

    wave.wave_mt = counted
    try:
        yield counts
    finally:
        wave.wave_mt = launch


def synced(fn):
    """fn() and its wall seconds, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bf16_quality(got, ref, occ, occ_ref):
    """How far a rows_bf16 trace is from the exact one (JAX's
    tests/test_front_table.py:118-147 measures): the share of rays whose
    hit agrees; where both hit, the share on the same triangle and the
    median relative t error there; the share within 2% of t; the share
    whose occlusion agrees."""
    both = got["hit"] & ref["hit"]
    same = got["tri"][both] == ref["tri"][both]
    t_g, t_r = got["t"][both][same], ref["t"][both][same]
    rel = (t_g - t_r).abs() / t_r.abs().clamp(min=1e-6)
    return {"hit_agreement": (got["hit"] == ref["hit"]).float().mean().item(),
            "both_hit": int(both.sum()), "same_tri_share": same.float().mean().item(),
            "median_rel_t_err": rel.median().item(),
            "within_2pct_share": (rel < 2e-2).float().mean().item(),
            "occlusion_agreement": (occ == occ_ref).float().mean().item()}


def shadow_limits(t, hit, seed):
    """Any-hit limits of shadow rays, mixed by thirds: short of the exact
    closest hit (0.5-0.95 of its t: not occluded), past it (1.05-2 of
    it: occluded), and 0 (masked); a ray that misses gets 0.05-3. Bounded
    as a shadow ray is: rows_bf16's margins scale with tmax (the origin
    is lifted by 0.005 tmax), so an unbounded tmax is no shadow ray."""
    rs = np.random.RandomState(seed)
    n = t.shape[0]
    f = rs.uniform(0.5, 0.95, size=n).astype(np.float32)
    f[1::3] = rs.uniform(1.05, 2.0, size=n).astype(np.float32)[1::3]
    free = torch.from_numpy(rs.uniform(0.05, 3.0, size=n).astype(np.float32)).to(t.device)
    tmax = torch.where(hit, t * torch.from_numpy(f).to(t.device), free)
    tmax[2::3] = 0.0
    return tmax.contiguous()


def bmw_tunables(ct, wave, data, p, d, dev, count):
    """12b: the BMW's pixel-centre rays (bmw_live's shape), closest hit and
    any hit (``shadow_limits``), under each tunable: the exact ones equal to the
    default trace (hit, occlusion, and t bit for bit where tri is equal)
    but for ties, counted: exact-t ties (tri differs, t bit-equal:
    recompact's ties) and edge ties (t within 1e-6 relative: a ray
    through a shared edge, where a box's rounded tnear lets one front
    table test the other triangle); rows_bf16's hit agreement > 0.99, its
    other ``bf16_quality`` readings printed beside JAX's bounds, and its
    trace with the kernels equal to its trace with plain=True (t and
    occlusion bit for bit, tri but for exact-t ties). Each is timed in turns with the default (ms a
    closest-hit trace, TUNE_TURNS turns, the median), with its waves and
    host syncs a trace; the rows wave_mt fetched in a default and in a
    wave_dedup trace (the dedup factor on this card) and the front
    table's ms at front_levels 2 and 3. The timed traces are counted."""
    n = p.shape[0]
    closest0 = ct.intersect_clusters(data, p, d)
    tmax = shadow_limits(closest0["t"], closest0["hit"], 33)
    occ0 = ct.occluded_clusters(data, p, d, tmax)
    hits0 = int(closest0["hit"].sum())
    check(0 < hits0 < n and bool(occ0.any()), "BMW rays: no test (all or no rays hit)")
    out = {"rays": n, "hits": hits0, "occluded": int(occ0.sum()), "tunes": {}}
    for label, tune in {**EXACT_TUNES, **BF16_TUNES}.items():
        for k in ct.STATS:
            ct.STATS[k] = 0
        got = ct.intersect_clusters(data, p, d, **tune)
        occ = ct.occluded_clusters(data, p, d, tmax, **tune)
        torch.cuda.synchronize()
        stats = {k: v / 2 for k, v in ct.STATS.items()}  # a trace
        ms = {"default": [], "tune": []}
        for _ in range(TUNE_TURNS):  # in turns with the default
            (_, s0), _ = count(lambda: synced(lambda: ct.intersect_clusters(data, p, d)))
            (_, s1), _ = count(lambda: synced(lambda: ct.intersect_clusters(data, p, d, **tune)))
            ms["default"].append(s0 * 1e3)
            ms["tune"].append(s1 * 1e3)
        row = {"tracer_tune": tune, "ms": float(np.median(ms["tune"])),
               "default_ms": float(np.median(ms["default"])), "ms_turns": ms,
               "waves_a_trace": stats["waves"], "syncs_a_trace": stats["syncs"],
               "fallback_rays_a_trace": stats["fallback_rays"]}
        if label in EXACT_TUNES:
            diff = got["tri"] != closest0["tri"]
            t_same = bits(got["t"]) == bits(closest0["t"])
            exact = int((diff & t_same).sum())
            # an edge tie: a ray through an edge two triangles share, both
            # hit within 1e-6 relative, and a box's rounded tnear lets one
            # table test the other triangle (phase 11's term)
            edge_m = diff & ~t_same & ((got["t"] - closest0["t"]).abs()
                                       <= 1e-6 * closest0["t"].abs())
            edge = int(edge_m.sum())
            bad = int((~t_same & ~edge_m).sum())  # the same triangle: t bit-equal
            bad_hit = int((got["hit"] != closest0["hit"]).sum())
            bad_occ = int((occ != occ0).sum())
            row.update(exact_t_ties=exact, edge_ties=edge, other_differences=bad,
                       hit_differs=bad_hit, occlusion_differs=bad_occ)
            summary = (f"hit differs on {bad_hit}, occlusion on {bad_occ}, tri on "
                       f"{int(diff.sum())} (exact-t ties {exact}, edge ties {edge}), other {bad}")
            check(bad_hit == 0 and bad_occ == 0 and bad == 0,
                  f"BMW {label}: {summary}: not the default trace's winners")
            check(exact + edge <= n // 100,
                  f"BMW {label}: {exact + edge} ties: too many to be ties")
        else:
            q = bf16_quality(got, closest0, occ, occ0)
            row.update(q)
            # JAX's bounds (tests/test_front_table.py:118-147) beside each
            # reading; the hit agreement is held, the rest is what this
            # tunable does on this asset (the port's rows_bf16 trace is the
            # JAX package's to the bit on the CPU, tests/test_torch_tracer_tune.py)
            bounds = {"hit_agreement": 0.99, "same_tri_share": 0.98,
                      "within_2pct_share": 0.97, "occlusion_agreement": 0.99}
            held = {k: q[k] > v for k, v in bounds.items()}
            held["median_rel_t_err"] = q["median_rel_t_err"] < 1e-3
            row["jax_bounds_held"] = held
            summary = ", ".join(
                f"{k} {q[k]:.6g} ({'held' if held[k] else 'missed'} JAX's "
                f"{'< 1e-3' if k == 'median_rel_t_err' else '> ' + str(bounds[k])})"
                for k in held) + f" over {q['both_hit']} both-hit rays"
            check(held["hit_agreement"], f"BMW {label}: {summary}")
            # the kernels against their plain versions, whole traces
            plain = ct.intersect_clusters(data, p, d, plain=True, **tune)
            plain_occ = ct.occluded_clusters(data, p, d, tmax, plain=True, **tune)
            t_same = bits(plain["t"]) == bits(got["t"])
            ties = int(((plain["tri"] != got["tri"]) & t_same).sum())
            bad = int((~t_same).sum()) + int((plain_occ != occ).sum())
            row.update(plain_exact_t_ties=ties, plain_other_differences=bad)
            summary += f"; against plain=True: exact-t ties {ties}, other {bad}"
            check(bad == 0 and ties <= n // 1000,
                  f"BMW {label}: the kernels' trace differs from plain=True's: {summary}")
        out["tunes"][label] = row
        print(f"BMW {n} rays, {label} {tune}: {summary}; {row['ms']:.4f} ms a closest-hit trace "
              f"against the default's {row['default_ms']:.4f} (medians of {TUNE_TURNS} turns); "
              f"{stats['waves']:.1f} waves, {stats['syncs']:.1f} host syncs, "
              f"{stats['fallback_rays']:.1f} fallback rays a trace", flush=True)
    # the rows wave_mt fetches in a trace, with and without dedup_order
    fetched = {}
    for label, tune in (("default", {}), ("wave_dedup gather", {"wave_dedup": "gather"})):
        with rows_fetched(wave) as c:
            ct.intersect_clusters(data, p, d, **tune)
        fetched[label] = dict(c)
    f0, f1 = fetched["default"], fetched["wave_dedup gather"]
    check(f0["calls"] > 0 and f1["rows"] > 0, f"BMW: no wave_mt call was counted: {fetched}")
    out["rows_fetched"] = {**fetched, "reference_over_distinct": f0["live_pairs"] / f0["distinct"],
                           "card_dedup_factor": f0["rows"] / f1["rows"]}
    print(f"BMW closest-hit trace, rows wave_mt fetches: {f0['rows']} in ray order, {f1['rows']} "
          f"in dedup_order (the card's dedup factor {f0['rows'] / f1['rows']:.4f}); "
          f"{f0['live_pairs']} live (ray, column) pairs on {f0['distinct']} distinct clusters a "
          f"wave, summed over {f0['calls']} waves (reference / distinct "
          f"{f0['live_pairs'] / f0['distinct']:.4f})", flush=True)
    # the front table alone at two and three levels
    bvh = data.bvh
    kk = min(ct.MAX_FRONT, bvh["cluster_bmin"].shape[0])
    tl = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    front_ms = {}
    for levels in (2, 3):
        fn = lambda levels=levels: ct._front_table_hierarchical(p, d, bvh, tl, kk, levels=levels)  # noqa: E731
        fn()
        front_ms[levels] = cuda_ms(fn)
    out["front_table_ms"] = front_ms
    print(f"BMW front table of {n} rays: {front_ms[2]:.5f} ms at front_levels 2 (front_full), "
          f"{front_ms[3]:.5f} ms at front_levels 3 (K3 {bvh['ssc_bmin'].shape[0]}; medians of "
          f"{GATHER_REPS})", flush=True)
    return out


def bmw_tuned_films(ct, scene, data, dev, count):
    """12c: the BMW at bmw_fwd's shape (512x512, 4 spp, depth 4, one
    render_pass): the exact tunables together against the default film
    on >= 99.9% of the pixels (ties only); rows_bf16 with the kernels
    against rows_bf16 with plain=True at phase 6's rtol 1e-5; rays/s of
    each (the films with the kernels counted), and the rows_bf16 film's
    mean against the exact film's."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import make_tracer, render_pass

    w = h = 512
    spp, depth = 4, 4
    cam = camera_to_params(scene.camera, dev)

    def film(tune):
        with torch.no_grad():
            out = render_pass(data, cam, 0, 0, spp, width=w, height=h, max_depth=depth,
                              tracer=make_tracer(data, use_bvh=True, tracer_tune=tune))
        return out["color"].reshape(h, w, 3).cpu().numpy() / spp

    rays = w * h * spp * depth * 2
    film({})  # warm-up
    out, films = {}, {}
    for label, tune in (("default", {}),
                        ("exact tunables", {"front_levels": 3, "slab_bf16": True,
                                            "wave_dedup": "gather"}),
                        ("rows_bf16", {"rows_bf16": True})):
        (img, secs), launches = count(lambda tune=tune: synced(lambda: film(tune)))
        films[label] = img
        check(np.isfinite(img).all() and img.mean() > 0, f"BMW film {label}: not finite or black")
        out[label] = {"s": secs, "rays_per_s": rays / secs, "mean": float(img.mean()),
                      "launches": launches}
    close = float(np.isclose(films["exact tunables"], films["default"], rtol=1e-5,
                             atol=1e-7).all(axis=-1).mean())
    plain, _ = synced(lambda: film({"rows_bf16": True, "plain": True}))
    diff = float(np.abs(films["rows_bf16"] - plain).max())
    out["exact_vs_default_pixels"] = close
    out["rows_bf16_vs_plain_max_abs_diff"] = diff
    mean_ratio = out["rows_bf16"]["mean"] / out["default"]["mean"]
    out["rows_bf16_mean_over_exact"] = mean_ratio
    print(f"BMW {w}x{h} {spp} spp depth {depth} render_pass: " + "; ".join(
        f"{k} {v['s']:.4f} s, {v['rays_per_s']:.1f} rays/s, mean {v['mean']:.6f}"
        for k, v in out.items() if isinstance(v, dict)) + f"; exact tunables vs default: pixels "
        f"within rtol 1e-5 {close:.6f}; rows_bf16 kernels vs plain=True max |diff| {diff:.3g}; "
        f"rows_bf16 mean / exact mean {mean_ratio:.6f}", flush=True)
    check(close >= 0.999, f"BMW: only {close} of the exact tunables' pixels match the default")
    check(np.allclose(films["rows_bf16"], plain, rtol=1e-5, atol=0.0),
          f"BMW rows_bf16: the kernels' film differs from the plain=True film by {diff}")
    return out


def tunables_phase(ct, mt, front, wave, bench, scenes, terrain_data, tp, td, dev, smi):
    """Phase 12. Its main path is the timed traces of 12b and the three
    kernel films of 12c, each counted from 0 just before and read just
    after; the parity of 12a, the checking traces, the rows-fetched
    count and the plain=True film are not counted. Returns (launches,
    the parity's largest t difference of each new kernel instance)."""
    t0 = time.perf_counter()
    scene, data = bench.load_bmw(dev)
    bvh = data.bvh
    print(f"BMW: {data.num_tris} triangles, K {bvh['cluster_bmin'].shape[0]}, K2 "
          f"{bvh['sc_bmin'].shape[0]}, K3 {bvh['ssc_bmin'].shape[0]}; loaded in "
          f"{time.perf_counter() - t0:.2f} s; cluster_rows_bf16 "
          f"{bvh['cluster_rows_bf16'].numel() * 2} B", flush=True)
    check(data.num_tris == BMW_TRIS, f"BMW: {data.num_tris} triangles, not {BMW_TRIS}")
    bp, bd = (x[:BMW_LIVE_RAYS].contiguous() for x in pixel_rays(scene, dev))
    errs, fetched = tunables_parity(
        # the BMW's first wave meets no triangle (every ray's nearest box
        # is a cluster it does not hit): its second wave holds the winners
        wave, ct, [("terrain_scene", terrain_data, tp, td, (0, 7)), ("BMW", data, bp, bd, (0, 1))],
        ("terrain_scene", terrain_data, tp, td, mixed_limits(32, tp.shape[0], dev)), dev)
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    summary = {"parity_rows_fetched": fetched,
               "traces": bmw_tunables(ct, wave, data, bp, bd, dev, count),
               "films": bmw_tuned_films(ct, scene, data, dev, count)}
    for k in ("front_full", "wave_mt", *NEW_KERNELS):
        check(totals[k] > 0, f"phase 12: {k} was not launched")
    summary["launches_counted"] = totals
    summary["device"] = smi
    print(json.dumps({"tunables": summary}), flush=True)
    return totals, errs



# ---------------------------------------------------------------------------
# phase 13: the integrator's options (pipeline_shadow, spp_batch, remat)
# ---------------------------------------------------------------------------

OPTION_TURNS = 3         # timed turns of each setting of (a) and (b), in one run
REMAT_TURNS = 2          # of each setting of (c): a gradient step takes seconds
OPTION_KERNELS = ("mt_closest", "mt_anyhit", "front_full", "wave_mt")  # on phase 13's path


def in_turns(settings, fn, turns):
    """{setting: [fn(setting), ...]}, the settings run in turns (a b c,
    c b a, a b c, ...), so that a drift of the host's speed meets each."""
    out = {s: [] for s in settings}
    for t in range(turns):
        for s in (settings if t % 2 == 0 else settings[::-1]):
            out[s].append(fn(s))
    return out


def measured(count, ct, fn):
    """fn() synchronised, with its seconds, its peak memory after a reset,
    the memory allocated before it, its kernel launches and the cluster
    tracer's STATS, each counted from 0 just before it."""
    for k in ct.STATS:
        ct.STATS[k] = 0
    before = torch.cuda.memory_allocated()
    (out, secs, peak), launches = count(lambda: timed(fn))
    return {"out": out, "s": secs, "peak_bytes": peak, "transient_bytes": peak - before,
            "launches": launches, "traced": dict(ct.STATS)}


def summary(runs, rays):
    """The first turn's counts and peaks, the median seconds over the
    turns, and rays/s at that median."""
    first = runs[0]
    secs = float(np.median([r["s"] for r in runs]))
    return {"s": secs, "s_turns": [r["s"] for r in runs], "rays_per_s": rays / secs,
            "peak_bytes": first["peak_bytes"], "transient_bytes": first["transient_bytes"],
            "launches": {k: v for k, v in first["launches"].items() if v},
            "traced": first["traced"]}


def pipelined_films(path, ct, cases, dev, count):
    """13a: each case pipelined and not through render_pass (4 spp, depth
    4), in turns; the pipelined film with the kernels against the same
    with plain=True (rtol 1e-5, as phase 6), and against the non-pipelined
    film within tests/test_integrator.py's bound (rtol 1e-4, atol 1e-5):
    every pixel of cornell_box, >= 99.9% of the BMW's (the pixels beyond
    counted). The timed renders are counted; warm-ups and the plain film
    not."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    spp, depth = 4, 4
    out = {}
    for label, scene, data, use_bvh, min_share in cases:
        w, h = scene.camera.width, scene.camera.height
        cam = camera_to_params(scene.camera, dev)

        def film(pipe, plain=False):
            tracer = path.make_tracer(data, use_bvh=use_bvh, plain=plain)
            with torch.no_grad():
                return path.render_pass(data, cam, 0, 0, spp, width=w, height=h,
                                        max_depth=depth, tracer=tracer,
                                        pipeline_shadow=pipe)["color"]

        film(True), film(False)  # warm-ups
        runs = in_turns((True, False), lambda pipe: measured(count, ct, lambda: film(pipe)),
                        OPTION_TURNS)
        films = {pipe: runs[pipe][0]["out"] for pipe in runs}
        for pipe, rs in runs.items():
            check(all(torch.equal(r["out"], films[pipe]) for r in rs),
                  f"{label} pipeline_shadow={pipe}: the turns' films differ")
        got, ref = films[True].cpu().numpy(), films[False].cpu().numpy()
        check(np.isfinite(got).all() and got.mean() > 0, f"{label}: pipelined film not finite or black")
        plain = film(True, plain=True).cpu().numpy()
        plain_diff = float(np.abs(got - plain).max())
        within = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
        rays = w * h * spp * depth * 2
        row = {pipe: summary(runs[pipe], rays) for pipe in (True, False)}
        res = {"pipelined": row[True], "not_pipelined": row[False],
               "kernels_vs_plain_max_abs_diff": plain_diff,
               "vs_not_pipelined_max_abs_diff": float(np.abs(got - ref).max()),
               "pixels_within": float(within.mean()), "pixels_beyond": int((~within).sum())}
        out[label] = res
        for pipe, name in ((True, "pipelined"), (False, "not pipelined")):
            r = row[pipe]
            print(f"{label} {w}x{h} {spp} spp depth {depth} {name}: {r['s']:.6f} s a pass "
                  f"({', '.join(f'{s:.6f}' for s in r['s_turns'])}), "
                  f"{r['rays_per_s'] / 1e6:.4f} Mrays/s (median of {OPTION_TURNS} turns); "
                  f"launches a pass {r['launches']}; tracer {r['traced']}", flush=True)
        print(f"{label} pipelined: kernels vs plain=True max |diff| {plain_diff:.3g}; vs not "
              f"pipelined max |diff| {res['vs_not_pipelined_max_abs_diff']:.3g}, pixels within "
              f"rtol 1e-4 atol 1e-5 {res['pixels_within']:.6f} ({res['pixels_beyond']} beyond)",
              flush=True)
        check(np.allclose(got, plain, rtol=1e-5, atol=0.0),
              f"{label}: the pipelined film with the kernels differs from plain=True's by "
              f"{plain_diff}")
        check(res["pixels_within"] >= min_share,
              f"{label}: only {res['pixels_within']} of the pipelined pixels match the "
              "non-pipelined film")
        if not use_bvh:  # the brute tracer: one any-hit launch a sample, the trailing resolve
            pl, npl = row[True]["launches"], row[False]["launches"]
            check(pl.get("mt_anyhit") == spp and pl.get("mt_closest") == spp * depth
                  and npl.get("mt_anyhit") == spp * depth,
                  f"{label}: pipelined launches {pl}, not pipelined {npl}")
    return out


def pipelined_gradient(path, scenes, dev):
    """13a: d color.sum() / d (emission, lobe_weight) of cornell_box
    256x256, 4 spp, depth 4, pipelined against not, within 1e-4 of each
    field's max |g| (phase 8's bound on the card)."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    scene = scenes.cornell_box(256, 256)
    data = scene.build(device=dev)
    cam = camera_to_params(scene.camera, dev)
    tracer = path.make_tracer(data, use_bvh=False)
    pair = ("emission", "lobe_weight")
    _, ref = grad_render(path, data, cam, 256, 256, 4, 4, tracer, pair)
    _, got = grad_render(path, data, cam, 256, 256, 4, 4, tracer, pair, pipeline_shadow=True)
    errs = check_grads("cornell_box 256x256 pipelined gradient", got, ref, 1e-4)
    print("cornell_box 256x256 4 spp depth 4 gradient (emission, lobe_weight), pipelined vs "
          "not: " + ", ".join(f"{f} {e:.3g} of the scale" for f, e in errs.items()), flush=True)
    return errs


def spp_batch_renders(pt, ct, cases, dev, count):
    """13b: each case through Renderer at spp_batch 1, 2 and 4, in turns:
    the film against spp_batch=1's (rtol 1e-4, atol 1e-5), kernel launches
    a pass, peak memory and rays/s. The timed renders are counted; the
    warm-ups not."""
    out = {}
    sbs = (1, 2, 4)
    for label, scene, kw in cases:
        opts = {sb: pt.Options(spp_batch=sb, **kw) for sb in sbs}
        rs = {sb: pt.Renderer(scene, opts[sb], device=dev) for sb in sbs}
        for sb, r in rs.items():
            check(r.fn.render_kw["spp_batch"] == sb, f"{label}: spp_batch {sb} did not reach the pass")
            r.render()  # warm-up
        runs = in_turns(sbs, lambda sb: measured(count, ct, lambda: rs[sb].render()), OPTION_TURNS)
        w, h = scene.camera.width, scene.camera.height
        spp, depth = kw["samples_per_pixel"], kw["path_depth"]
        passes = -(-spp // kw.get("samples_per_pass", 4))
        rays = w * h * spp * depth * 2
        base = runs[1][0]["out"]["color"]
        res = {}
        for sb in sbs:
            film = runs[sb][0]["out"]["color"]
            check(np.isfinite(film).all() and film.mean() > 0, f"{label} spp_batch {sb}: film")
            row = summary(runs[sb], rays)
            row["launches_a_pass"] = {k: v / passes for k, v in row["launches"].items()}
            row["vs_sb1_max_abs_diff"] = float(np.abs(film - base).max())
            res[sb] = row
            print(f"{label} spp_batch {sb} (rays a trace: {min(w * h, rs[sb].max_wavefront) * sb}): "
                  f"{row['s']:.6f} s ({', '.join(f'{s:.6f}' for s in row['s_turns'])}), "
                  f"{row['rays_per_s'] / 1e6:.4f} Mrays/s (median of {OPTION_TURNS} turns); peak "
                  f"{row['peak_bytes']} bytes ({row['transient_bytes']} above the scenes); "
                  f"launches a pass {row['launches_a_pass']}; tracer {row['traced']}; vs "
                  f"spp_batch 1 max |diff| {row['vs_sb1_max_abs_diff']:.3g}", flush=True)
            check(np.allclose(film, base, rtol=1e-4, atol=1e-5),
                  f"{label}: spp_batch {sb}'s film differs from spp_batch 1's by "
                  f"{row['vs_sb1_max_abs_diff']}")
        out[label] = res
        del rs
    return out


def remat_steps(path, ct, cases, dev, count):
    """13c: each gradient step with remat and without, in turns: the
    gradients against each other (max |diff|; bit-equal expected on one
    card, within 1e-4 of the scale checked), peak memory after a reset,
    seconds a step, and kernel launches (the recompute's included). The
    timed steps are counted; the warm-ups not."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    out = {}
    for label, scene, data, use_bvh, n, spp, depth, kw in cases:
        w = scene.camera.width
        cam = camera_to_params(scene.camera, dev)
        tracer = path.make_tracer(data, use_bvh=use_bvh)
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        px, py = ids % w, ids // w

        def step(remat, spp=spp):
            import dataclasses

            leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in GRAD_FIELDS}
            sums = path.render_pass_pixels(dataclasses.replace(data, **leaves), cam, 0, 0, spp,
                                           px, py, max_depth=depth, tracer=tracer, remat=remat,
                                           **kw)
            sums["color"].sum().backward()
            return {f: leaves[f].grad for f in GRAD_FIELDS}

        step(False, 1), step(True, 1)  # warm-ups
        runs = in_turns((False, True), lambda remat: measured(count, ct, lambda: step(remat)),
                        REMAT_TURNS)
        rays = n * spp * depth * 2
        g0, g1 = runs[False][0]["out"], runs[True][0]["out"]
        for f in GRAD_FIELDS:
            check(bool(torch.isfinite(g1[f]).all()), f"{label} remat: the {f} gradient")
        errs = check_grads(f"{label} remat vs not", g1, g0, 1e-4)
        diffs = {f: float((g1[f] - g0[f]).abs().max()) for f in GRAD_FIELDS}
        equal = {f: bool(torch.equal(g1[f], g0[f])) for f in GRAD_FIELDS}
        res = {"remat": summary(runs[True], rays), "no_remat": summary(runs[False], rays),
               "max_abs_diff": diffs, "bit_equal": equal, "rel_err": errs}
        out[label] = res
        for key, name in (("no_remat", "without remat"), ("remat", "with remat")):
            r = res[key]
            print(f"{label} gradient step {name}: {r['s']:.6f} s "
                  f"({', '.join(f'{s:.6f}' for s in r['s_turns'])}), "
                  f"{r['rays_per_s'] / 1e6:.4f} Mrays/s (median of {REMAT_TURNS}); peak "
                  f"{r['peak_bytes']} bytes ({r['transient_bytes']} above the scene); launches "
                  f"{r['launches']}; tracer {r['traced']}", flush=True)
        print(f"{label} gradients with remat vs without: max |diff| {diffs}, bit-equal {equal}",
              flush=True)
    return out


def options_phase(pt, ct, mt, front, wave, bench, scenes, dev, smi):
    """Phase 13. Its main path is the timed renders and steps of 13a-c,
    each counted from 0 just before and read just after; the warm-ups,
    the plain film and the pipelined gradient check are not counted.
    Returns the launches."""
    from phosphorus_mk2_tpu_torch.integrator import path

    t0 = time.perf_counter()
    bmw_scene, bmw_data = bench.load_bmw(dev)
    check(bmw_data.num_tris == BMW_TRIS, f"BMW: {bmw_data.num_tris} triangles, not {BMW_TRIS}")
    box = scenes.cornell_box(256, 256)
    box_data = box.build(device=dev)
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    res = {"pipeline_shadow": pipelined_films(
        path, ct, [("cornell_box", box, box_data, False, 1.0),
                   ("BMW", bmw_scene, bmw_data, True, 0.999)], dev, count)}
    res["pipeline_shadow"]["gradient_rel_err"] = pipelined_gradient(path, scenes, dev)
    res["spp_batch"] = spp_batch_renders(pt, ct, [
        ("cornell_box 256x256 16 spp depth 4 brute", box,
         dict(use_bvh=False, samples_per_pixel=16, path_depth=4)),
        ("BMW 512x512 4 spp depth 4", bmw_scene,
         dict(use_bvh=True, samples_per_pixel=4, path_depth=4))], dev, count)
    res["remat"] = remat_steps(path, ct, [
        # bench cornell_fwd_bwd's shape: the whole frame, 16 spp, depth 4, brute
        ("cornell_box 256x256 16 spp depth 4", box, box_data, False, 256 * 256, 16, 4, {}),
        # bench bmw_fwd_bwd's: the first 1 << 16 pixels, 2 spp, depth 3
        ("BMW 1 << 16 pixels 2 spp depth 3", bmw_scene, bmw_data, True, 1 << 16, 2, 3,
         {})], dev, count)
    for k in OPTION_KERNELS:
        check(totals[k] > 0, f"phase 13: {k} was not launched")
    res["launches_counted"] = totals
    res["device"] = smi
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"options": res}, default=str), flush=True)
    print(f"phase 13: {res['s']:.1f} s; {smi}", flush=True)
    return totals


# ---------------------------------------------------------------------------
# phase 14: the un-consolidated shading path
# ---------------------------------------------------------------------------

SHADING_TURNS = 3        # timed turns of each branch, in one run
BRANCHES = ("attribute tables", "hit rows")  # the default above HIT_ROW_MAX_TRIS first


@contextlib.contextmanager
def shading_branch(path, data, branch):
    """Inside, make_scene_tables gives ``data`` the hit rows ("hit rows":
    the threshold raised to its triangle count) or not ("attribute
    tables": JAX's threshold, which the scene is above), checked."""
    saved = path.HIT_ROW_MAX_TRIS
    check(data.num_tris > saved, f"{data.num_tris} triangles are not above HIT_ROW_MAX_TRIS")
    rows = branch == "hit rows"
    if rows:
        path.HIT_ROW_MAX_TRIS = data.num_tris
    try:
        check(("hit_f" in path.make_scene_tables(data)) is rows,
              f"make_scene_tables does not take the {branch} branch")
        yield
    finally:
        path.HIT_ROW_MAX_TRIS = saved


def hit_row_bytes(path, data):
    """Bytes of the hit rows (hit_f and hit_i) the scene would have."""
    with shading_branch(path, data, "hit rows"):
        tables = path.make_scene_tables(data)
        return sum(tables[k].numel() * tables[k].element_size() for k in ("hit_f", "hit_i"))


def launches_a_step(fn, steps):
    """Device kernels of fn() under torch.profiler, over its bounce-steps,
    and the busy seconds; (None, None) when no device event was traced."""
    torch.cuda.synchronize()
    _, kernels, _ = device_events(fn)
    if not kernels:
        return None, None
    return len(kernels) / steps, sum(e.time_range.elapsed_us() for e in kernels) / 1e6


def shading_forward(pt, path, ct, cases, dev, count, profile):
    """14a: each scene through Renderer under both branches, in turns: no
    hit rows by default; the two films bit-equal (checked within phase
    6's rtol 1e-5, bit-equality and the max |diff| printed); the default
    film against a Renderer with plain=True (rtol 1e-5); rays/s (medians
    of SHADING_TURNS), the MT, front and wave kernels' launches a pass
    (equal under both branches); with --profile the device kernels a
    bounce-step (torch.profiler, one render of each branch: 31-87 s a
    scene on the H100, so not by default). The timed renders are counted;
    the warm-ups, the profiled renders and the plain film not."""
    out = {}
    for label, scene, kw in cases:
        clock = [time.perf_counter()]
        r = pt.Renderer(scene, pt.Options(**kw), device=dev)
        data = r.data
        check("hit_f" not in path.make_scene_tables(data),
              f"{label}: {data.num_tris} triangles, yet hit rows by default")
        w, h = scene.camera.width, scene.camera.height
        spp, depth = kw["samples_per_pixel"], kw["path_depth"]
        rays = w * h * spp * depth * 2
        steps = spp * math.ceil(w * h / r.max_wavefront) * depth

        def render(branch):
            with shading_branch(path, data, branch):
                return measured(count, ct, r.render)

        for b in BRANCHES:  # warm-ups
            with shading_branch(path, data, b):
                r.render()
        clock.append(time.perf_counter())
        runs = in_turns(BRANCHES, render, SHADING_TURNS)
        clock.append(time.perf_counter())
        films = {b: runs[b][0]["out"]["color"] for b in BRANCHES}
        for b, rs in runs.items():
            check(all(np.array_equal(x["out"]["color"], films[b]) for x in rs),
                  f"{label} {b}: the turns' films differ")
        attr, rows = films[BRANCHES[0]], films[BRANCHES[1]]
        check(np.isfinite(attr).all() and attr.mean() > 0, f"{label}: film not finite or black")
        equal = bool(np.array_equal(attr, rows))
        diff = float(np.abs(attr - rows).max())
        plain = pt.Renderer(scene, pt.Options(**kw, tracer_tune={"plain": True}),
                            device=dev).render()["color"]
        clock.append(time.perf_counter())
        plain_diff = float(np.abs(attr - plain).max())
        res = {"triangles": data.num_tris, "hit_row_bytes": hit_row_bytes(path, data),
               "films_bit_equal": equal, "films_max_abs_diff": diff,
               "kernels_vs_plain_max_abs_diff": plain_diff}
        for b in BRANCHES:
            row = summary(runs[b], rays)
            row["device_launches_a_bounce_step"] = row["profiled_busy_s"] = None
            if profile:
                with shading_branch(path, data, b):
                    row["device_launches_a_bounce_step"], row["profiled_busy_s"] = \
                        launches_a_step(r.render, steps)
            res[b] = row
            print(f"{label} ({data.num_tris} triangles), {b}: {row['s']:.6f} s "
                  f"({', '.join(f'{x:.6f}' for x in row['s_turns'])}), "
                  f"{row['rays_per_s'] / 1e6:.4f} Mrays/s (median of {SHADING_TURNS} turns); "
                  f"peak {row['peak_bytes']} bytes ({row['transient_bytes']} above the scene); "
                  f"launches a pass {row['launches']}; tracer {row['traced']}; device kernels "
                  + (f"a bounce-step {row['device_launches_a_bounce_step']} (of {steps}), busy "
                     f"{row['profiled_busy_s']} s" if profile
                     else "a bounce-step not measured (--profile)"), flush=True)
        clock.append(time.perf_counter())
        res["seconds"] = dict(zip(("set-up and warm-ups", "turns", "plain", "profiled"),
                                  np.diff(clock).tolist()))
        print(f"{label}: films of the two branches bit-equal {equal} (max |diff| {diff:.3g}); "
              f"vs plain=True max |diff| {plain_diff:.3g}; the hit rows would take "
              f"{res['hit_row_bytes']} bytes; seconds {res['seconds']}", flush=True)
        check(equal or np.allclose(attr, rows, rtol=1e-5, atol=0.0),
              f"{label}: the two branches' films differ by {diff}")
        check(np.allclose(attr, plain, rtol=1e-5, atol=0.0),
              f"{label}: the kernels' film differs from plain=True's by {plain_diff}")
        la, lr = res[BRANCHES[0]]["launches"], res[BRANCHES[1]]["launches"]
        check(la == lr and la.get("wave_mt", 0) > 0 and la.get("front_full", 0) > 0,
              f"{label}: kernel launches {la} under the attribute tables, {lr} with hit rows")
        out[label] = res
        del r
        torch.cuda.empty_cache()
    return out


def backward_profile(graph):
    """--profile: the backward of graph() (the forward builds the graph
    unprofiled) under torch.profiler: its kernels, busy seconds and
    indexing_backward_kernel's share of them."""
    loss = graph()
    torch.cuda.synchronize()
    _, kernels, _ = device_events(loss.backward)
    if not kernels:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    ib = sum(e.time_range.elapsed_us() for e in kernels if "indexing_backward" in e.name) / 1e6
    return {"kernels": len(kernels), "busy_s": busy, "index_backward_s": ib,
            "index_backward_share": ib / busy if busy else None}


def shading_gradients(path, ct, cases, dev, count, profile):
    """14b: bench bmw_fwd_bwd's gradient step (the first 1 << 16 pixels, 2
    spp, depth 3; d color.sum() / d (emission,
    lobe_weight, vertices)) under both branches, in turns: the gradients
    within 1e-4 of each field's max |g| (phase 8's bound), seconds a step,
    peak memory after a reset, launches; under --profile the backward's
    busy seconds and indexing_backward_kernel's share. The timed steps are
    counted; the warm-ups and the profiled steps not."""
    import dataclasses

    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params

    n, spp, depth = 1 << 16, 2, 3
    out = {}
    for label, scene, data in cases:
        w = scene.camera.width
        cam = camera_to_params(scene.camera, dev)
        tracer = path.make_tracer(data, use_bvh=True)
        check(tracer[0].func is ct.intersect_clusters, f"{label}: not the cluster tracer")
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        px, py = ids % w, ids // w

        def graph(spp=spp):
            leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in GRAD_FIELDS}
            sums = path.render_pass_pixels(dataclasses.replace(data, **leaves), cam, 0, 0, spp,
                                           px, py, max_depth=depth, tracer=tracer)
            return sums["color"].sum(), leaves

        def step(branch, spp=spp):
            with shading_branch(path, data, branch):
                loss, leaves = graph(spp)
                loss.backward()
            return {f: leaves[f].grad for f in GRAD_FIELDS}

        t0 = time.perf_counter()
        for b in BRANCHES:  # warm-ups
            step(b, 1)
        runs = in_turns(BRANCHES, lambda b: measured(count, ct, lambda: step(b)), SHADING_TURNS)
        rays = n * spp * depth * 2
        g_attr, g_rows = runs[BRANCHES[0]][0]["out"], runs[BRANCHES[1]][0]["out"]
        for f in GRAD_FIELDS:
            check(bool(torch.isfinite(g_attr[f]).all()) and float(g_attr[f].abs().max()) > 0,
                  f"{label}: the {f} gradient under the attribute tables")
        errs = {f: grad_err(g_attr[f], g_rows[f]) for f in GRAD_FIELDS}
        res = {"rel_err": errs, "grads": (g_attr, g_rows)}
        for b in BRANCHES:
            row = summary(runs[b], rays)
            if profile:
                with shading_branch(path, data, b):
                    row["backward_profile"] = backward_profile(lambda: graph()[0])
            res[b] = row
            print(f"{label} gradient step, {b}: {row['s']:.6f} s "
                  f"({', '.join(f'{x:.6f}' for x in row['s_turns'])}), "
                  f"{row['rays_per_s'] / 1e6:.4f} Mrays/s (median of {SHADING_TURNS}); peak "
                  f"{row['peak_bytes']} bytes ({row['transient_bytes']} above the scene); "
                  f"launches {row['launches']}; tracer {row['traced']}"
                  + (f"; backward {row['backward_profile']}" if profile else ""), flush=True)
        res["seconds"] = time.perf_counter() - t0
        print(f"{label} gradients, attribute tables vs hit rows: "
              + ", ".join(f"{f} {e:.3g} of the scale" for f, e in errs.items())
              + f"; {res['seconds']:.1f} s", flush=True)
        out[label] = res
    for label, res in out.items():  # checked once every case has printed its numbers
        check_grads(f"{label} attribute tables vs hit rows", *res.pop("grads"), 1e-4)
    return out


def raises(fn, exc):
    """Whether fn() raises exc."""
    try:
        fn()
    except exc:
        return True
    return False


def rows_backward_check(pt, scenes, dev):
    """14c: the backward of the few-row gathers (csrc/rows_backward.cu) at
    cornell_box.inverse's shapes. One InverseRenderer step (cornell_box
    256x256, its defaults, emission and lobe_weight trainable) after a
    warm-up step: every backward of a row gather counted under
    rows_backward (one a gather), none above the budget, and each one's
    inputs kept. At each distinct shape, on those inputs: the kernel
    within 1 float32 ulp of rows_backward_plain on the card (bit-equality
    printed) and of a float64 index_put_ rounded once, bit-equal twice,
    counted once a call; ms a call (CUDA events, launches included)
    beside the bytes bound, the plain version's ms, and
    index_put_(accumulate=True)'s in the cotangent's dtype (PyTorch's
    index backward, what table[idx] ran) and in float64 (the "float64"
    transpose before the kernel) as library_ms. A float16 cotangent and a
    table above the budget raise."""
    from phosphorus_mk2_tpu_torch.math import grad_gather as gg

    t0 = time.perf_counter()
    target = pt.Renderer(scenes.cornell_box(256, 256), pt.Options(samples_per_pixel=4),
                         device=dev).render()["color"]
    inv = pt.InverseRenderer(scenes.cornell_box(256, 256), target,
                             trainable=("emission", "lobe_weight"), device=dev)
    inv.step()
    kept = []
    real = gg.rows_backward

    def keep(idx, ct, rows):
        kept.append((idx.clone(), ct.clone(), rows))
        return real(idx, ct, rows)

    torch.cuda.synchronize()
    before = dict(gg.LAUNCHES)
    gg.rows_backward = keep
    try:
        inv.step()
    finally:
        gg.rows_backward = real
    torch.cuda.synchronize()
    step = {k: gg.LAUNCHES[k] - before[k] for k in gg.LAUNCHES}
    print(f"rows_backward: one cornell_box 256x256 InverseRenderer step: {step}", flush=True)
    check(step["rows_backward"] == len(kept) > 0 and step["rows_backward_above_budget"] == 0
          and step["rows_backward_plain"] == 0,
          f"rows_backward: a step's gathers were not all summed by the kernel: {step}")
    shapes = {}
    for idx, ct, rows in kept:
        shapes.setdefault((idx.numel(), rows, tuple(ct.shape[idx.dim():]), str(ct.dtype)),
                          (idx, ct, rows))
    res = {"step": step, "shapes": []}
    for (n, rows, width, dtype), (idx, ct, rows) in shapes.items():
        n0 = gg.LAUNCHES["rows_backward"]
        g1 = gg.rows_backward(idx, ct, rows)
        g2 = gg.rows_backward(idx, ct, rows)
        torch.cuda.synchronize()
        check(gg.LAUNCHES["rows_backward"] - n0 == 2,
              f"rows_backward {n} x {rows} x {width}: two calls counted "
              f"{gg.LAUNCHES['rows_backward'] - n0}")
        shape = (rows,) + width
        plain = gg.rows_backward_plain(idx, ct, rows)
        ref = torch.zeros(shape, dtype=torch.float64, device=dev).index_put_(
            (idx,), ct.double(), accumulate=True).to(ct.dtype)

        def ulps(a, b):
            b_np = b.cpu().numpy()
            return float(np.max(np.abs(a.cpu().numpy() - b_np) / np.spacing(np.abs(b_np)),
                                initial=0.0))

        row = {"indices": n, "rows": rows, "width": list(width), "dtype": dtype,
               "twice_bit_equal": bool(torch.equal(g1, g2)),
               "plain_bit_equal": bool(torch.equal(g1, plain)),
               "ulps_vs_plain": ulps(g1, plain), "ulps_vs_index_put_float64": ulps(g1, ref)}
        w = int(np.prod(width))
        elem = ct.element_size()
        row["bound_ms"] = (n * (w * elem + 8) + rows * w * elem) / 3.35e12 * 1e3
        row["ms"] = cuda_ms(lambda: gg.rows_backward(idx, ct, rows), 200)
        row["plain_ms"] = cuda_ms(lambda: gg.rows_backward_plain(idx, ct, rows), 5)
        row["library_ms"] = cuda_ms(lambda: torch.zeros(shape, dtype=ct.dtype, device=dev)
                                    .index_put_((idx,), ct, accumulate=True), 50)
        row["library_float64_ms"] = cuda_ms(
            lambda: torch.zeros(shape, dtype=torch.float64, device=dev)
            .index_put_((idx,), ct.double(), accumulate=True).to(ct.dtype), 50)
        res["shapes"].append(row)
        print(f"rows_backward {n} indices into {rows} rows of {list(width)} {dtype}: "
              f"twice bit-equal {row['twice_bit_equal']}, vs plain bit-equal "
              f"{row['plain_bit_equal']} ({row['ulps_vs_plain']:.3g} ulp), vs float64 "
              f"index_put_ {row['ulps_vs_index_put_float64']:.3g} ulp; ms a call "
              f"{row['ms']:.5f} (bound {row['bound_ms']:.6f}), plain {row['plain_ms']:.4f}, "
              f"index_put_ {row['library_ms']:.5f}, float64 index_put_ "
              f"{row['library_float64_ms']:.5f}", flush=True)
        check(row["twice_bit_equal"] and row["ulps_vs_plain"] <= 1.0
              and row["ulps_vs_index_put_float64"] <= 1.0,
              f"rows_backward {n} x {rows} x {list(width)}: {row}")
        check(raises(lambda: gg.rows_backward(idx, ct.half(), rows), ValueError),
              "rows_backward took a float16 cotangent")
        check(raises(lambda: gg.rows_backward(idx, ct, gg.ROWS_BUDGET // w + 1), ValueError),
              "rows_backward took a table above its budget")
    torch.cuda.synchronize()
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"rows_backward": res}), flush=True)
    return res


def shading_phase(pt, ct, mt, front, wave, bench, scenes, terrain, terrain_data, dev, smi,
                  profile):
    """Phase 14. Its main path is the timed renders and steps of 14a-b,
    each counted from 0 just before and read just after. Returns the
    launches."""
    from phosphorus_mk2_tpu_torch.integrator import path

    t0 = time.perf_counter()
    check(path.HIT_ROW_MAX_TRIS == 1 << 18, f"HIT_ROW_MAX_TRIS is {path.HIT_ROW_MAX_TRIS}")
    bmw_scene, bmw_data = bench.load_bmw(dev)
    print(f"BMW loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    check(bmw_data.num_tris == BMW_TRIS, f"BMW: {bmw_data.num_tris} triangles, not {BMW_TRIS}")
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    fwd = dict(use_bvh=True, samples_per_pixel=4, samples_per_pass=4, path_depth=4)
    res = {"forward": shading_forward(pt, path, ct, [
        ("terrain_scene 256x256 4 spp depth 4", scenes.terrain_scene(width=256, height=256),
         fwd),
        ("textured_terrain_scene 256x256 4 spp depth 4 mis",
         scenes.textured_terrain_scene(grid=512, width=256, height=256), dict(fwd, mis=True)),
        ("BMW 512x512 4 spp depth 4", bmw_scene, fwd)], dev, count, profile)}
    res["gradient"] = shading_gradients(path, ct, [
        ("terrain_scene 1 << 16 pixels 2 spp depth 3", terrain, terrain_data),
        ("BMW 1 << 16 pixels 2 spp depth 3", bmw_scene, bmw_data)], dev, count, profile)
    res["rows_backward"] = rows_backward_check(pt, scenes, dev)
    for k in ("front_full", "wave_mt"):
        check(totals[k] > 0, f"phase 14: {k} was not launched")
    res["launches_counted"] = totals
    res["device"] = smi
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"shading": res}, default=str), flush=True)
    print(f"phase 14: {res['s']:.1f} s; {smi}", flush=True)
    return totals



# ---------------------------------------------------------------------------
# phase 15: the Blender add-on, driven through a stub bpy
# ---------------------------------------------------------------------------

BLENDER_SPP = 8      # two progressive passes at the add-on's 4 samples a pass


def options_of(pt, s):
    """The Options the add-on's engine makes of its render settings."""
    return pt.Options(samples_per_pixel=s.samples_per_pixel, paths_per_sample=s.paths_per_sample,
                      path_depth=s.max_depth, samples_per_pass=s.samples_per_pass,
                      use_bvh=s.use_bvh)


def engine_on(dev, views=(), break_after=None):
    """The add-on's render engine on the stub's harness, rendering on dev."""
    from phosphorus_mk2_tpu_torch.blender.engine import PhosphorusRenderEngine
    from phosphorus_mk2_tpu_torch.tools import blender_stub

    class Engine(blender_stub.EngineHarness, PhosphorusRenderEngine):
        device = str(dev)

    return Engine(views, break_after)


def passes_vs_renderer(pt, eng, scene, settings, view, dev, label):
    """The engine's Combined and Normal passes of ``view`` against the last
    film of a Renderer of ``scene`` with the engine's Options, y-flipped:
    bit for bit. Returns the Renderer's set-up seconds."""
    t0 = time.perf_counter()
    r = pt.Renderer(scene, options_of(pt, settings), device=dev)
    t_build = time.perf_counter() - t0
    film = list(r.passes())[-1][0]
    w, h = scene.camera.width, scene.camera.height
    want = np.ones((h, w, 4), np.float32)
    want[..., :3] = film["color"]
    want[..., 3] = film["alpha"]
    pairs = [("Combined", want)] + ([("Normal", film["normal"])] if settings.normal_pass else [])
    for name, ref in pairs:
        got = eng.rect(name, view)
        check(got is not None, f"{label}: the engine wrote no {name} pass")
        ref = np.ascontiguousarray(ref[::-1], np.float32).reshape(-1)
        check(np.array_equal(got.view(np.uint32), ref.view(np.uint32)),
              f"{label}: the {name} pass differs from Renderer's film in "
              f"{int((got != ref).sum())} values, max |diff| {np.abs(got - ref).max():.3g}")
    check(np.isfinite(want).all() and want[..., :3].mean() > 0, f"{label}: film not finite or black")
    return t_build


def blender_bmw(pt, dev, count, smi, scale=1.0, res=512):
    """15a: the BMW asset (tools/bmw_asset.py) presented as a depsgraph by
    the stub, exported by the add-on's exporter and rendered through
    PhosphorusRenderEngine.render at res x res with the add-on's settings
    but BLENDER_SPP samples and the Normal pass. The engine's render is
    counted."""
    import tempfile

    from phosphorus_mk2_tpu_torch.blender.exporter import export_scene
    from phosphorus_mk2_tpu_torch.tools import blender_stub, bmw_asset

    with tempfile.TemporaryDirectory() as tmp:
        asset = bmw_asset.load_scene(bmw_asset.write_asset(os.path.join(tmp, "bmw.abc"), scale),
                                     res, res)
    tris = sum(m.num_faces for m in asset.meshes)
    settings = blender_stub.default_settings(samples_per_pixel=BLENDER_SPP, normal_pass=True)
    t0 = time.perf_counter()
    dg = blender_stub.depsgraph_from_scene(asset, settings)
    t_stub = time.perf_counter() - t0
    t0 = time.perf_counter()
    exported = export_scene(dg, dg.scene)
    t_export = time.perf_counter() - t0

    # the geometry is the asset's, bit for bit; the material ids are the
    # asset's through the exporter's table: __default 0, then each
    # material in the order the faces first use it
    check(len(exported.meshes) == len(asset.meshes), "BMW export: the meshes differ in number")
    first_use = {}
    for a, e in zip(asset.meshes, exported.meshes):
        check(np.array_equal(a.vertices.view(np.uint32), e.vertices.view(np.uint32))
              and np.array_equal(a.faces, e.faces), f"BMW export: mesh {a.name} is not the asset's")
        ids = asset._resolve_face_materials(a)
        for m in dict.fromkeys(ids.tolist()):
            first_use.setdefault(m, 1 + len(first_use))
        lut = np.zeros(len(asset.materials), np.int32)
        lut[list(first_use)] = list(first_use.values())
        check(np.array_equal(e.material, lut[ids]), f"BMW export: mesh {a.name}'s material ids")

    eng = engine_on(dev)
    before = torch.cuda.memory_allocated()
    (_, secs, peak), launches = count(lambda: timed(lambda: eng.render(dg)))
    n_pass = BLENDER_SPP // settings.samples_per_pass
    check(eng.updates == n_pass and eng.progress[-1] == 1.0 and eng.ended,
          f"BMW engine: {eng.updates} updates, progress {eng.progress}")
    t_build = passes_vs_renderer(pt, eng, exported, settings, None, dev, "BMW engine")
    t0 = time.perf_counter()
    pt.Renderer(asset, options_of(pt, settings), device=dev)  # no corner attributes
    t_asset_build = time.perf_counter() - t0
    pass_s = eng.update_times[-1] - eng.update_times[-2]
    rays = res * res * settings.samples_per_pass * settings.max_depth * 2
    out = {"triangles": tris, "meshes": len(asset.meshes), "stub_s": t_stub,
           "export_s": t_export, "build_s": t_build, "asset_build_s": t_asset_build,
           "engine_render_s": secs,
           "pass_s": pass_s, "rays_per_s": rays / pass_s, "peak_bytes": peak,
           "transient_bytes": peak - before, "launches": launches}
    print(f"15a BMW through the add-on ({tris} triangles, {len(asset.meshes)} meshes; Blender is "
          f"not on this machine: the depsgraph is tools/blender_stub.py's, with loops and the uv "
          f"layer): stub depsgraph {t_stub:.3f} s, export {t_export:.3f} s, geometry bit-equal to "
          f"the asset's; PhosphorusRenderEngine.render {res}x{res} {BLENDER_SPP} spp depth "
          f"{settings.max_depth} use_bvh={settings.use_bvh} ({n_pass} passes, Normal on) "
          f"{secs:.3f} s in all; a pass {pass_s:.6f} s, {rays / pass_s / 1e6:.4f} Mrays/s; "
          f"Renderer set-up {t_build:.3f} s (of the asset's scene, without corner attributes: "
          f"{t_asset_build:.3f} s); peak {peak} bytes ({peak - before} above what was "
          f"allocated before); Combined and Normal bit-equal to Renderer's last film; launches "
          f"{ {k: v for k, v in launches.items() if v} }; {smi}", flush=True)
    return out


def quad_scene(pt, width, height):
    """The JAX add-on test's stereo scene (tests/test_blender_engine.py
    _depsgraph) as a port Scene: a diffuse quad at z = 0 under a sky,
    the camera 4 back along +z."""
    from phosphorus_mk2_tpu_torch.core.material import Material
    from phosphorus_mk2_tpu_torch.scenes import make_quad

    scene = pt.Scene()
    scene.add_material(Material.diffuse((0.7, 0.7, 0.7), name="d"))
    scene.add_mesh(make_quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0], material="d",
                             name="quad"))
    scene.set_environment(Material.background((0.6, 0.7, 0.9), power=1.5))
    to_world = np.eye(4, dtype=np.float32)
    to_world[3, 2] = 4.0
    scene.camera = pt.Camera(to_world=to_world, focal_length=35.0, sensor_width=36.0,
                             width=width, height=height)
    return scene


def blender_quad(pt, dev, count, smi, width=64, height=48):
    """15b: the two-view quad scene through the engine (the brute tracer:
    2 triangles): each eye's passes against a Renderer on that eye's
    camera, the eyes apart, and a test_break after the first pass. The
    stereo render is counted."""
    import copy

    from phosphorus_mk2_tpu_torch.blender.exporter import export_scene
    from phosphorus_mk2_tpu_torch.tools import blender_stub

    settings = blender_stub.default_settings(samples_per_pixel=BLENDER_SPP, normal_pass=True)
    dg = blender_stub.depsgraph_from_scene(quad_scene(pt, width, height), settings)
    eng = engine_on(dev, ["left", "right"])
    (_, secs, _), launches = count(lambda: timed(lambda: eng.render(dg)))
    n_pass = BLENDER_SPP // settings.samples_per_pass
    check(eng.updates == 2 * n_pass and eng.active_views == ["left", "right"]
          and eng.progress == sorted(eng.progress) and eng.progress[-1] == 1.0,
          f"quad engine: {eng.updates} updates, views {eng.active_views}, progress {eng.progress}")
    exported = export_scene(dg, dg.scene)
    for view in ("left", "right"):
        eye = copy.deepcopy(exported)
        m = np.array(dg.scene.camera.matrix_world, np.float32)
        if view == "right":
            m[0, 3] += eng.eye_offset
        eye.camera.to_world = m.T.copy()
        passes_vs_renderer(pt, eng, eye, settings, view, dev, f"quad engine, {view} eye")
    check(not np.array_equal(eng.rect("Combined", "left"), eng.rect("Combined", "right")),
          "quad engine: the two eyes are equal")

    brk = engine_on(dev, ["left", "right"], break_after=2)  # polls: before pass 1, after it
    brk.render(dg)
    left = brk.result.layers[0].passes.find_by_name("Combined", "left").rect
    check(brk.updates == 1 and left.writes == 1 and brk.ended
          and brk.rect("Combined", "right") is None,
          f"quad engine: test_break after the first pass left {brk.updates} updates")
    print(f"15b the two-view quad through the add-on ({width}x{height}, {BLENDER_SPP} spp, depth "
          f"{settings.max_depth}, use_bvh={settings.use_bvh}: the brute tracer): {secs:.3f} s "
          f"for both eyes; each eye's Combined and Normal bit-equal to a Renderer on its camera, "
          f"the eyes differ; test_break after the first pass: one pass written, the render "
          f"returned; launches { {k: v for k, v in launches.items() if v} }; {smi}", flush=True)
    return {"s": secs, "launches": launches}


def blender_phase(pt, mt, front, wave, dev, smi):
    """Phase 15: the Blender add-on (phosphorus_mk2_tpu_torch/blender/),
    driven through tools/blender_stub.py since Blender is not on this
    machine. Its main path is the engine renders of 15a and 15b's stereo
    render, each counted from 0 just before and read just after; the
    Renderer films they are held to and the test_break render are not
    counted. Returns the launches."""
    from phosphorus_mk2_tpu_torch.tools import blender_stub

    t0 = time.perf_counter()
    bpy = blender_stub.install()
    check(bpy.types.RenderEngine is blender_stub.RenderEngine, "phase 15: another bpy is loaded")
    totals = launch_keys()
    count = launch_counter(COUNTED, totals)
    res = {"bmw": blender_bmw(pt, dev, count, smi), "quad": blender_quad(pt, dev, count, smi)}
    for part, kernels in (("bmw", ("front_full", "wave_mt", "wave_sweep")),
                          ("quad", ("mt_closest", "mt_anyhit"))):
        for k in kernels:
            check(res[part]["launches"][k] > 0, f"phase 15: {k} was not launched ({part})")
    res["launches_counted"] = totals
    res["device"] = smi
    res["s"] = time.perf_counter() - t0
    print(json.dumps({"blender": res}, default=str), flush=True)
    print(f"phase 15: {res['s']:.1f} s; {smi}", flush=True)
    return totals



def run(profile: bool, upto: int, only_tunables: bool = False, only_options: bool = False,
        only_shading: bool = False, only_blender: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    try:
        import phosphorus_mk2_tpu_torch as pt
        from phosphorus_mk2_tpu_torch import scenes
        from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct
        from phosphorus_mk2_tpu_torch.accel import front, mt, native_bvh, wave
        from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
        from phosphorus_mk2_tpu_torch.math import grad_gather
        from phosphorus_mk2_tpu_torch.tools import row_gather_probe as probe
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    try:
        from phosphorus_mk2_tpu_torch.bsdf import kernel as bk
    except ImportError:  # another checkout's port (--package) without the bsdf kernels
        bk = None
    global COUNTED
    COUNTED = (mt, front, wave) + ((bk,) if bk else ())
    dev = torch.device("cuda")

    phase("1 device")
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}", flush=True)

    phase("2 build")
    build_all({"mt": mt, "front": front, "wave": wave, "native_bvh": native_bvh,
               "grad_gather": grad_gather, **({"bsdf": bk} if bk else {})})
    sass = sass_loops(mt, wave)
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
    errs.update(front_parity(front, front_cases(cases, dev)))
    wave_cases = [("terrain_scene", terrain_data, tp, td, cases[0][4]),
                  ("multi_bsdf_scene", multi_data, mp, md, cases[1][4])]
    errs.update(wave_parity(wave, ct, probe, wave_cases, dev))
    errs["wave_sweep"] = max(errs["wave_sweep"], sweep_parity(wave, wave_cases[0], dev))
    if only_tunables:
        phase("12 the cluster tracer's tunables (alone)")
        from phosphorus_mk2_tpu_torch import bench

        tunables_phase(ct, mt, front, wave, bench, scenes, terrain_data, tp, td, dev, smi)
        return 0
    if only_options:
        phase("13 the integrator's options (alone)")
        from phosphorus_mk2_tpu_torch import bench

        options_phase(pt, ct, mt, front, wave, bench, scenes, dev, smi)
        return 0
    if only_shading:
        phase("14 the un-consolidated shading path (alone)")
        from phosphorus_mk2_tpu_torch import bench

        shading_phase(pt, ct, mt, front, wave, bench, scenes, terrain, terrain_data, dev, smi,
                      profile)
        return 0
    if only_blender:
        phase("15 the Blender add-on (alone)")
        blender_phase(pt, mt, front, wave, dev, smi)
        return 0
    if upto < 4:
        return 0

    phase("4 cluster tracer vs brute oracle")
    ties, fallback_share, _, _, _ = tracer_vs_oracle(mt, ct, terrain, terrain_data, dev, {})
    ties8, share8, needy, p4, d4 = tracer_vs_oracle(mt, ct, terrain, terrain_data, dev,
                                                    {"front_k": 8})

    phase("5 main path")
    launches, phase5_films = main_path(mt, front, wave, ct, probe, pt, scenes, dev)
    if upto < 6:
        return 0

    if profile:
        phase("profile")
        profile_traces(ct, terrain_data, tp, td, mixed_limits(13, N_RAYS, dev))
        profile_render(pt, ct, scenes)

    phase("6 whole path: kernels vs plain versions")
    whole_path_vs_plain(mt, pt, scenes, dev)

    phase("7 kernel timing")
    rows = mt_timing(mt, scenes, dev, launches, errs, sass)
    rows += front_timing(front, cases, launches, errs)
    rows += wave_timing(wave, ct, probe, scenes, wave_cases[0], multi_data, launches, errs,
                        dev, sass.get("wave_mt_kernel"), rows[0]["sm_clock_mhz"],
                        sass.get("wave_mt_kernel bf16"))
    rows += sweep_timing(wave, terrain_data.bvh["cluster_rows"], p4, d4, needy, launches, errs,
                         dev, sass, rows[0]["sm_clock_mhz"], terrain_data.bvh["cluster_rows_bf16"])
    phase("7b the lobe container's kernels")
    rows += bsdf_timing(bk, pt, scenes, launches)
    phase("7c the lobe weights' gradient")
    rows += bsdf_grad_timing(bk, launches, dev)
    if upto < 8:
        return 0

    phase("8 gradients and inverse rendering")
    grad_launches = gradients_phase(pt, scenes, ct, mt, front, wave, terrain, terrain_data, dev,
                                    profile)
    if upto < 9:
        return 0

    phase("9 scene I/O and sharded render")
    io_launches = scene_io_phase(pt, scenes, mt, front, wave, dev, smi, phase5_films)
    if upto < 10:
        return 0

    phase("10 CLI, bench and entry points")
    entry_launches = entry_points_phase(pt, scenes, mt, front, wave, dev, phase5_films)
    if upto < 11:
        return 0

    phase("11 oracle tracers and gather_rows")
    oracle_launches = oracle_phase(pt, scenes, mt, front, wave, terrain, terrain_data, dev, smi)
    if upto < 12:
        return 0

    phase("12 the cluster tracer's tunables")
    from phosphorus_mk2_tpu_torch import bench

    tune_launches, tune_errs = tunables_phase(ct, mt, front, wave, bench, scenes, terrain_data,
                                              tp, td, dev, smi)
    if upto < 13:
        return 0

    phase("13 the integrator's options")
    option_launches = options_phase(pt, ct, mt, front, wave, bench, scenes, dev, smi)
    if upto < 14:
        return 0

    phase("14 the un-consolidated shading path")
    shading_launches = shading_phase(pt, ct, mt, front, wave, bench, scenes, terrain,
                                     terrain_data, dev, smi, profile)
    if upto < 15:
        return 0

    phase("15 the Blender add-on")
    blender_launches = blender_phase(pt, mt, front, wave, dev, smi)
    for row in rows:  # the kernels line counts the main path of every phase
        row["launches"] += (grad_launches[row["name"]] + io_launches[row["name"]]
                            + entry_launches[row["name"]] + oracle_launches[row["name"]]
                            + tune_launches[row["name"]] + option_launches[row["name"]]
                            + shading_launches[row["name"]] + blender_launches[row["name"]])
        if row["max_abs_err"] is None:  # a new instance: its parity is phase 12's
            row["max_abs_err"] = tune_errs[row["name"]]
    names = [row["name"] for row in rows]
    check(all(k in names for k in NEW_KERNELS), f"the kernels line lacks one of {NEW_KERNELS}")
    check(all(row["launches"] > 0 for row in rows),
          f"a kernel was never launched on a main path: {[(r['name'], r['launches']) for r in rows]}")

    print(json.dumps({"tracer_vs_oracle": {"exact_t_ties": ties, "rays": N_RAYS,
                                           "fallback_share": fallback_share,
                                           "front_k_8": {"exact_t_ties": ties8,
                                                         "fallback_share": share8}}}))
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
    ap.add_argument("--upto", type=int, default=15, metavar="PHASE",
                    help="stop after this phase (2 or 3: build and parity only, for a "
                         "first look at a new kernel); prints no result line")
    ap.add_argument("--only-tunables", action="store_true",
                    help="phases 1-3, then phase 12 alone (no result line)")
    ap.add_argument("--only-options", action="store_true",
                    help="phases 1-3, then phase 13 alone (no result line)")
    ap.add_argument("--only-shading", action="store_true",
                    help="phases 1-3, then phase 14 alone (no result line)")
    ap.add_argument("--only-blender", action="store_true",
                    help="phases 1-3, then phase 15 alone (no result line)")
    ap.add_argument("--sweep-timing", action="store_true",
                    help="only time wave_sweep at phase 7's shapes and print one JSON line "
                         "(no result line)")
    ap.add_argument("--m", default="", metavar="M,...",
                    help="with --sweep-timing: more ray counts to time, comma-separated")
    ap.add_argument("--package", metavar="DIR",
                    help="drive the port of the checkout in DIR (with --sweep-timing, or "
                         "--upto 5 to time the main path of another version)")
    args = ap.parse_args()
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    if args.sweep_timing:
        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
            return 2
        return sweep_timing_only([int(x) for x in args.m.split(",") if x])
    try:
        rc = run(args.profile, args.upto, args.only_tunables, args.only_options,
                 args.only_shading, args.only_blender)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if rc == 0 and (args.upto < 15 or args.only_tunables or args.only_options
                    or args.only_shading or args.only_blender):
        print(f"chip_smoke: stopped after phase {args.upto}; no result", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())

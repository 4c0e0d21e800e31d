"""Render options, mirroring the reference CLI flags
(reference src/options.hpp:6-43: spp=16, depth=9, paths/sample=16,
single_threaded, host_only, progressive, render_normals, verbose).

A copy of ``phosphorus_mk2_tpu/core/options.py``. The port honours
samples_per_pixel, path_depth, samples_per_pass, use_bvh, mis, seed,
checkpoint_dir, checkpoint_every, max_wavefront, spp_batch, remat,
aniso_taps and tracer_tune. It ignores use_pallas (a CUDA scene's brute
tracer always runs the hand kernels of accel/mt.py) and depth_unroll and
sample_unroll (the JAX scans' unrolls: the port's loops are eager
Python, with no scan to unroll)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Options:
    output: str = "out.exr"
    samples_per_pixel: int = 16
    paths_per_sample: int = 1  # path revival is disabled in the reference too
    path_depth: int = 9
    progressive: bool = False
    render_normals: bool = False
    verbose: bool = False
    # knobs of the JAX package (no reference counterpart):
    samples_per_pass: int = 4      # spp per accumulation pass
    use_bvh: bool = True           # False = brute-force oracle tracer
    mis: bool = False              # NEE/BSDF multiple importance sampling
                                   # (deviation: the reference has no MIS
                                   # and keeps an (e*4) NEE quirk; see
                                   # integrator/path.trace_sample)
    use_pallas: bool = False       # the JAX package's Pallas brute tracer;
                                   # ignored here (CUDA scenes always run
                                   # the hand kernels of accel/mt.py)
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0      # passes between checkpoints; 0 = off
    max_wavefront: int = 0         # pixels per device pass; larger frames
                                   # render in sequential wavefront chunks
                                   # (bounds device memory for 4K-class
                                   # frames). 0 = auto (Renderer): 1<<20
                                   # for the brute tracer, 1<<17 for the
                                   # cluster tracer, the JAX package's
                                   # bounds, since the cluster tracer's
                                   # per-ray front tables and row gathers
                                   # grow with the wavefront. The bound
                                   # costs launches: multi_bsdf_scene's
                                   # 512x512 BVH pass runs 301,084 kernels
                                   # at 1<<17 and 157,032 at 1<<20 (PERF.md
                                   # §5, H100 80GB HBM3 at 700 W; ROADMAP
                                   # Queue 2)
    # the JAX package's scan unrolls: accepted and ignored here, as the
    # port's integrator is eager PyTorch with no scan to unroll
    depth_unroll: int = 0          # bounce-scan unroll; 0 = auto
    sample_unroll: int = 0         # sample-scan unroll; 0 = auto
    spp_batch: int = 1             # samples folded into one wavefront:
                                   # each trace runs spp_batch x the
                                   # chunk's pixels (max_wavefront counts
                                   # pixels); 1 where it does not divide
                                   # a pass's samples
    remat: bool = False            # torch.utils.checkpoint of each bounce
                                   # under autograd (memory for
                                   # recompute); no effect on a forward
    aniso_taps: int = 0            # anisotropic texture taps along the
                                   # footprint's uv major axis (0 =
                                   # isotropic trilinear); the stand-in
                                   # for the reference's OIIO
                                   # EWA (src/material.cpp:127-129)
    tracer_tune: dict | None = None  # cluster-tracer knobs (dense_waves/
                                   # chunk/dense_chunk/expand_batch/
                                   # front_k/sc_front/sc_topk/recompact/
                                   # dense_k/fb_cc, and slab_bf16,
                                   # front_levels, wave_dedup/dedup_d:
                                   # exact; rows_bf16: bf16 rows, which
                                   # changes images), a "shadow" sub-dict
                                   # for the any-hit trace only; see
                                   # accel/cluster_traverse._trace; None
                                   # = the defaults

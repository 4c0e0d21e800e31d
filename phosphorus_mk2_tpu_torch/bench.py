"""Benchmark of the port on one NVIDIA GPU: the repo's ``bench.py``
metrics, measured on the card.

    python -m phosphorus_mk2_tpu_torch.bench          # the three always-on lines
    python -m phosphorus_mk2_tpu_torch.bench --bmw    # and the three BMW lines

Each metric is one JSON line on stdout, printed as soon as it is
measured, under the metric name ``bench.py`` uses:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "rays": N, "device": "<name>, <power limit>", ...extras}

1. ``cornell_fwd_bwd_rays_per_sec`` (headline; BASELINE.json's "rays/sec
   fwd+bwd"): the gradient of the pixel sum of one 256x256, 16-spp,
   depth-4 render of cornell_box (brute tracer) with respect to emission,
   lobe weights and vertex positions; extras: the forward alone, the
   scoped (emission, lobe_weight) gradient, peak memory, the host floor
   of one trivial launch and an HBM roofline (bench.py's bytes-per-ray
   model over the card's copy bandwidth, measured here);
2. ``cornell_bvh_renderer_fwd_rays_per_sec``: the same scene through the
   production ``Renderer`` session (``use_bvh=True``, one 16-spp pass);
3. ``bmw_live_fwd_rays_per_sec``: one 1 << 17-ray closest-hit trace
   through the cluster tracer on the 887,604-triangle BMW asset, with
   its decomposition: the front table alone (``front.front_all``), the
   wave loop as the rest, its row bytes, and the gather roofline, the
   rate of ``wave.row_gather`` on the asset's own cluster rows;
4. (--bmw) ``bmw_fwd_rays_per_sec``: a 512x512, 4-spp, depth-4 forward
   render of the asset;
5. (--bmw) ``bmw_fwd_bwd_rays_per_sec`` and
6. (--bmw) ``bmw_fwd_bwd_scoped_emlw_rays_per_sec``: one gradient step
   of a pixel loss on 1 << 16 pixels, 2 spp, depth 3 (emission,
   lobe_weight and vertices; then emission and lobe_weight with the
   vertex chains cut by ``trainable=``).

Rays are counted as bench.py counts them, W*H*spp*depth*2 (closest and
shadow per bounce; the dense wavefront issues all of them), and for the
BMW trace one a ray. Every time is the best of ``reps`` calls after one
untimed warm-up, on the host clock with the device synchronised before
and after each call. ``vs_baseline`` divides by the same function of the
port on the host CPU (``device="cpu"``: the kernels' plain versions), at
CPU_SPP samples for cornell_box and at a cut of the BMW's pixels or rays
that the line states. The BMW asset is written by the port's
tools/bmw_asset.py into a temporary directory at first use and read back
by its Alembic reader.

A metric that fails prints ``{"metric": ..., "error": ...}`` and the
others still run; the exit code is then 1. Without a card the bench
exits 2 and measures nothing: it never runs on the CPU by itself. Each
metric is a function of its sizes and a ``device``, so that the tests
run it small on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from phosphorus_mk2_tpu_torch.device import resolve_device

WIDTH = HEIGHT = 256
SPP = 16
MAX_DEPTH = 4
CPU_SPP = 2  # the CPU baseline's samples, its rate scaled by ray count

# bench.py's HBM traffic model: ~36 f32 of per-ray carry state (p/d/beta/
# radiance/aux) + ~1 (rays x 128-tri chunk) intermediate, read and written
# once per bounce
HBM_BYTES_PER_RAY = (36 * 4) * 2 + 128 * 4
COPY_BYTES = 1 << 30  # the copy that measures the card's bandwidth

RES_BMW = 512
N_LIVE = 1 << 17                            # bmw_live's rays
BMW_SPP, BMW_DEPTH = 4, 4                   # bmw_fwd's shape
N_BMW, SPP_BMW, DEPTH_BMW = 1 << 16, 2, 3   # the BMW gradient steps' shape
GATHER_ROWS = 1 << 15                       # rows of the gather-roofline probe
# the CPU baselines' cuts of the BMW work (each CPU run well under 30 s)
CPU_LIVE_RAYS = 1 << 12
CPU_BMW_PIXELS = 1 << 10
CPU_GRAD_PIXELS = 1 << 9

EMLW = ("emission", "lobe_weight")
FIELDS_ALL = ("emission", "lobe_weight", "vertices")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps: int = 2):
    """(best seconds of ``reps`` calls after one untimed warm-up, the last
    result); the device synchronised before and after every call."""
    out = fn()
    sync(device)
    best = math.inf
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def device_label(device) -> str:
    """"<name>, <power limit>" as nvidia-smi gives them for a card; "cpu"
    for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    """Peak bytes allocated on the card since the last reset (None on the CPU)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return None


def copy_gbps(device, nbytes: int = COPY_BYTES) -> float:
    """The device's copy bandwidth: one ``copy_`` of nbytes, counted as
    the bytes read plus the bytes written, GB/s (best of 5)."""
    src = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    t, _ = timed(lambda: dst.copy_(src), device, reps=5)
    return 2 * nbytes / t / 1e9


def launch_floor(device, k: int = 256):
    """Host floor of a trivial launch: (ms a launch of k back-to-back
    one-element adds, synchronised before and after the k; ms of one add
    and its synchronise), best of 3."""
    x = torch.zeros(1, device=device)

    def many():
        for _ in range(k):
            x.add_(1.0)

    t_many, _ = timed(many, device, reps=3)
    t_one, _ = timed(lambda: x.add_(1.0), device, reps=k)
    return t_many / k * 1e3, t_one * 1e3


def _check_finite(name, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"{name}: a result is not finite")


# ---------------------------------------------------------------------------
# cornell_box
# ---------------------------------------------------------------------------

def _cornell(dev, width, height):
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import make_tracer
    from phosphorus_mk2_tpu_torch.scenes import cornell_box

    scene = cornell_box(width=width, height=height)
    data = scene.build(dev)
    cam = camera_to_params(scene.camera, dev)
    tracer = make_tracer(data, use_bvh=False)  # the MT kernels on the card
    return data, cam, tracer


def grad_step(data, cam, px, py, spp, depth, tracer, fields, trainable=None):
    """A function of no arguments returning the gradients of the colour
    sum of an spp-sample render of pixels px, py with respect to
    ``fields`` (leaf copies of the scene's)."""
    from phosphorus_mk2_tpu_torch.integrator.path import render_pass_pixels

    leaves = {f: getattr(data, f).detach().clone().requires_grad_() for f in fields}

    def fn():
        out = render_pass_pixels(
            dataclasses.replace(data, **leaves), cam, 0, 0, spp, px, py,
            max_depth=depth, tracer=tracer, trainable=trainable,
        )
        return torch.autograd.grad(out["color"].sum(), list(leaves.values()))

    return fn


def cornell_fwd_bwd(device="cuda", width=WIDTH, height=HEIGHT, spp=SPP, depth=MAX_DEPTH,
                    cpu_spp=CPU_SPP, copy_bytes=COPY_BYTES, reps=2) -> dict:
    """bench.py's headline line (bench.py:73-132, 220-238)."""
    from phosphorus_mk2_tpu_torch.integrator.path import frame_pixels, render_pass

    dev = resolve_device(device)
    data, cam, tracer = _cornell(dev, width, height)
    px, py = frame_pixels(width, height, dev)
    rays = width * height * spp * depth * 2

    @torch.no_grad()
    def fwd():
        return render_pass(data, cam, 0, 0, spp, width=width, height=height,
                           max_depth=depth, tracer=tracer)["color"]

    peak = {}
    peak_reset(dev)
    t_fwd, color = timed(fwd, dev, reps)
    peak["fwd"] = peak_bytes(dev)
    mean = float(color.mean()) / spp
    if not (math.isfinite(mean) and mean > 0.0):
        raise RuntimeError(f"cornell_box forward: mean {mean}")
    peak_reset(dev)
    t_bwd, grads = timed(grad_step(data, cam, px, py, spp, depth, tracer, FIELDS_ALL), dev, reps)
    peak["fwd_bwd"] = peak_bytes(dev)
    _check_finite("cornell_box gradient", *grads)
    peak_reset(dev)
    t_sc, grads = timed(grad_step(data, cam, px, py, spp, depth, tracer, EMLW, EMLW), dev, reps)
    peak["scoped"] = peak_bytes(dev)
    _check_finite("cornell_box scoped gradient", *grads)
    fwdbwd = rays / t_bwd
    floor_ms, sync_ms = launch_floor(dev)
    gbps = copy_gbps(dev, copy_bytes)
    hbm_roofline = gbps * 1e9 / HBM_BYTES_PER_RAY  # rays/s if HBM-bound

    # the baseline: the same gradient of the port on the host CPU
    cpu = torch.device("cpu")
    data_c, cam_c, tracer_c = _cornell(cpu, width, height)
    pxc, pyc = frame_pixels(width, height, cpu)
    t_c, _ = timed(grad_step(data_c, cam_c, pxc, pyc, cpu_spp, depth, tracer_c, FIELDS_ALL),
                   cpu, reps=1)
    baseline = width * height * cpu_spp * depth * 2 / t_c
    return {
        "metric": "cornell_fwd_bwd_rays_per_sec",
        "value": round(fwdbwd, 1),
        "unit": "rays/s",
        "vs_baseline": round(fwdbwd / baseline, 4),
        "fwd_rays_per_sec": round(rays / t_fwd, 1),
        "scoped_emlw_rays_per_sec": round(rays / t_sc, 1),
        "baseline_cpu_fwd_bwd_rays_per_sec": round(baseline, 1),
        "baseline_cpu_s": round(t_c, 4),
        "launch_floor_ms_per_launch": round(floor_ms, 6),
        "launch_sync_ms": round(sync_ms, 6),
        "copy_gbps": round(gbps, 1),
        "hbm_roofline_rays_per_sec": round(hbm_roofline, 1),
        "rays": rays, "width": width, "height": height, "spp": spp, "depth": depth,
        "cpu_spp": cpu_spp,
        "mean": round(mean, 5),
        "peak_bytes": peak,
        "device": device_label(dev),
        "roofline_note": (
            "roofline = bench.py's bytes-per-ray model over the copy bandwidth "
            f"measured in this run: {hbm_roofline / max(rays / t_fwd, 1):.0f}x the "
            "forward throughput (the eager integrator is bound by its launches; "
            "launch_floor_ms_per_launch is the host cost of one trivial launch); "
            "baseline = the same gradient of the port on the host CPU at cpu_spp "
            "(the kernels' plain versions)"
        ),
    }


def cornell_bvh_renderer_fwd(device="cuda", width=WIDTH, height=HEIGHT, spp=SPP,
                             depth=MAX_DEPTH, cpu_spp=CPU_SPP, reps=2) -> dict:
    """bench.py's production-path line (bench.py:166-218): one spp-sample
    pass through ``Renderer(use_bvh=True)``, film copied to the host."""
    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.renderer import Renderer
    from phosphorus_mk2_tpu_torch.scenes import cornell_box

    dev = resolve_device(device)

    def session(n, d):
        opts = Options(use_bvh=True, samples_per_pixel=n, samples_per_pass=n, path_depth=depth)
        return Renderer(cornell_box(width=width, height=height), opts, device=d)

    r = session(spp, dev)
    t, film = timed(r.render, dev, reps)
    mean = float(film["color"].mean())
    if not (math.isfinite(mean) and mean > 0.0):
        raise RuntimeError(f"cornell_box Renderer: mean {mean}")
    rays = width * height * spp * depth * 2
    t_c, _ = timed(session(cpu_spp, "cpu").render, "cpu", reps=1)
    baseline = width * height * cpu_spp * depth * 2 / t_c
    return {
        "metric": "cornell_bvh_renderer_fwd_rays_per_sec",
        "value": round(rays / t, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays / t / baseline, 4),
        "baseline_cpu_fwd_rays_per_sec": round(baseline, 1),
        "baseline_cpu_s": round(t_c, 4),
        "rays": rays, "width": width, "height": height, "spp": spp, "depth": depth,
        "cpu_spp": cpu_spp,
        "mean": round(mean, 5),
        "device": device_label(dev),
        "note": (
            "production Renderer session (use_bvh=True; cornell_box's 36 triangles "
            "take the brute tracer, as in the JAX package), one pass, the film "
            "copied to the host; baseline = the same session on the host CPU"
        ),
    }


# ---------------------------------------------------------------------------
# the BMW asset
# ---------------------------------------------------------------------------

def load_bmw(device="cuda", res=RES_BMW, scale: float = 1.0):
    """(scene, data): the BMW asset of tools/bmw_asset.py written into a
    temporary directory, read back by the port's Alembic reader, built on
    ``device`` with its BVH attached, the camera at res x res."""
    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
    from phosphorus_mk2_tpu_torch.tools import bmw_asset

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = bmw_asset.write_asset(f"{tmp}/bmw_class.abc", scale=scale)
        scene = bmw_asset.load_scene(path, res, res)
    return scene, attach_bvh(scene.build(dev))


def _asset(device, bmw):
    """(scene, data, the data's device): ``bmw``, or the asset loaded on
    ``device``."""
    scene, data = bmw if bmw is not None else load_bmw(device)
    return scene, data, data.device


def _cut(n: int, m: int):
    """m indices spread evenly over range(n) (all of them when m >= n)."""
    step = max(1, n // m)
    return torch.arange(0, n, step, dtype=torch.int64)[:m]


def bmw_live(device="cuda", n_rays=N_LIVE, cpu_rays=CPU_LIVE_RAYS, gather_rows=GATHER_ROWS,
             reps=2, bmw=None) -> dict:
    """bench.py's live BMW line (bench.py:301-422): an n_rays closest-hit
    trace through the cluster tracer. bmw: the asset as ``load_bmw`` gives
    it (loaded on ``device`` when None)."""
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse as ct
    from phosphorus_mk2_tpu_torch.accel import front, wave
    from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params, generate_rays

    scene, data, dev = _asset(device, bmw)
    res = scene.camera.width
    cam = camera_to_params(scene.camera, dev)
    ids = torch.arange(n_rays, dtype=torch.int64, device=dev)
    u = torch.full((n_rays, 2), 0.5, device=dev)
    p, d = generate_rays(cam, ids % res, (ids // res) % res, u, u)

    t_trace, out = timed(lambda: ct.intersect_clusters(data, p, d), dev, reps)
    hits = int(out["hit"].sum())

    # decomposition: the front table alone, then the wave loop as the
    # rest of the trace; its bytes = the table's (ray, cluster) pairs x
    # the row size (an upper bound: the early-out skips some)
    bvh = data.bvh
    kk = min(ct.MAX_FRONT, bvh["cluster_bmin"].shape[0])
    jj = min(ct.SC_FRONT, bvh["sc_bmin"].shape[0])
    tl = torch.full((n_rays,), T_MAX, device=dev)
    t_front, tbl = timed(lambda: front.front_all(
        bvh["sc_bmin"], bvh["sc_bmax"], bvh["sc_member_bmin"], bvh["sc_member_bmax"],
        p, d, tl, jj=jj, kk=kk), dev, reps=3)
    overlap = int((tbl[0] < T_MAX).sum())
    rows = bvh["cluster_rows"]
    row_bytes = rows[0].numel() * rows.element_size()
    wave_gb = overlap * row_bytes / 1e9
    t_wave = max(t_trace - t_front, 1e-9)

    # the gather roofline: row_gather of gather_rows seeded random rows of
    # the asset's own table, the bytes of the rows read
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, rows.shape[0], (gather_rows,), generator=gen,
                        dtype=torch.int32).to(dev)
    t_gather, _ = timed(lambda: wave.row_gather(idx, rows), dev, reps=5)
    gather_gbps = gather_rows * row_bytes / t_gather / 1e9

    # the baseline: the same trace on the host CPU, on cpu_rays of the rays
    cpu = torch.device("cpu")
    data_c = data.to(cpu)
    sel = _cut(n_rays, cpu_rays).to(dev)
    pc, dc = p[sel].cpu(), d[sel].cpu()
    t_c, _ = timed(lambda: ct.intersect_clusters(data_c, pc, dc), cpu, reps=1)
    baseline = pc.shape[0] / t_c
    value = n_rays / t_trace
    return {
        "metric": "bmw_live_fwd_rays_per_sec",
        "value": round(value, 1),
        "unit": "rays/s",
        "vs_baseline": round(value / baseline, 4),
        "baseline_cpu_rays_per_sec": round(baseline, 1),
        "baseline_cpu_s": round(t_c, 4),
        "cpu_rays": pc.shape[0],
        "rays": n_rays,
        "trace_ms": round(t_trace * 1e3, 4),
        "hits": hits,
        "tris": data.num_tris,
        "front_table_ms": round(t_front * 1e3, 4),
        "front_mode": "front_full (the kernel selects the kk nearest)",
        "wave_loop_ms": round(t_wave * 1e3, 4),
        "wave_loop_gather_gb": round(wave_gb, 4),
        "achieved_gather_gbps": round(wave_gb / t_wave, 1),
        "gather_roofline_gbps": round(gather_gbps, 1),
        "pct_of_gather_roofline": round(100 * wave_gb / t_wave / gather_gbps, 2),
        "device": device_label(dev),
        "note": (
            f"{n_rays}-ray closest-hit trace of the BMW asset (one ray a pixel of "
            f"{res}x{res}, pixel centres), production tracer defaults; wave loop = "
            "trace - front table; gather roofline = row_gather of "
            f"{gather_rows} random rows of the asset's cluster-row table in this run "
            "(bytes read); baseline = the same trace on the host CPU on cpu_rays "
            "rays spread over the set"
        ),
    }


def bmw_fwd(device="cuda", spp=BMW_SPP, depth=BMW_DEPTH, cpu_pixels=CPU_BMW_PIXELS, reps=2,
            bmw=None) -> dict:
    """bench.py's --bmw forward line (bench.py:537-594): a full-frame
    spp-sample render of the BMW asset through the cluster tracer."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import (
        frame_pixels,
        make_tracer,
        render_pass_pixels,
    )

    scene, data, dev = _asset(device, bmw)
    res = scene.camera.width
    cam = camera_to_params(scene.camera, dev)
    tracer = make_tracer(data, use_bvh=True)
    px, py = frame_pixels(res, scene.camera.height, dev)

    @torch.no_grad()
    def fwd(data, cam, tracer, px, py):
        return render_pass_pixels(data, cam, 0, 0, spp, px, py, max_depth=depth,
                                  tracer=tracer)["color"]

    best, color = timed(lambda: fwd(data, cam, tracer, px, py), dev, reps)
    mean = float(color.mean()) / spp
    if not (math.isfinite(mean) and mean > 0.0):
        raise RuntimeError(f"BMW forward: mean {mean}")
    rays = px.shape[0] * spp * depth * 2

    cpu = torch.device("cpu")
    data_c = data.to(cpu)
    sel = _cut(px.shape[0], cpu_pixels)
    t_c, _ = timed(lambda: fwd(data_c, camera_to_params(scene.camera, cpu),
                               make_tracer(data_c, use_bvh=True), px.cpu()[sel], py.cpu()[sel]),
                   cpu, reps=1)
    baseline = sel.shape[0] * spp * depth * 2 / t_c
    return {
        "metric": "bmw_fwd_rays_per_sec",
        "value": round(rays / best, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays / best / baseline, 4),
        "baseline_cpu_fwd_rays_per_sec": round(baseline, 1),
        "baseline_cpu_s": round(t_c, 4),
        "cpu_pixels": sel.shape[0],
        "rays": rays,
        "tris": data.num_tris,
        "res": res, "spp": spp, "depth": depth,
        "mean": round(mean, 5),
        "device": device_label(dev),
        "note": (
            "the BMW asset written and imported by the port; one render_pass over "
            "the whole frame, cluster tracer (front_full, wave_mt, wave_sweep); "
            "baseline = the same render on the host CPU over cpu_pixels pixels "
            "spread over the frame"
        ),
    }


def _bmw_grad(device, bmw, metric, fields, trainable, n, spp, depth, cpu_pixels, reps,
              note) -> dict:
    """bench.py's BMW gradient-step lines (bench.py:430-534): the
    gradient of the colour sum of n pixels (row-major from the first)."""
    from phosphorus_mk2_tpu_torch.core.camera import camera_to_params
    from phosphorus_mk2_tpu_torch.integrator.path import make_tracer

    scene, data, dev = _asset(device, bmw)
    res = scene.camera.width
    ids = torch.arange(n, dtype=torch.int64)
    px, py = ids % res, (ids // res) % scene.camera.height

    def step(d, sel):
        return grad_step(d, camera_to_params(scene.camera, d.device),
                         px[sel].to(d.device), py[sel].to(d.device), spp, depth,
                         make_tracer(d, use_bvh=True), fields, trainable)

    peak_reset(dev)
    t, grads = timed(step(data, slice(None)), dev, reps)
    peak = peak_bytes(dev)
    _check_finite(metric, *grads)
    rays = n * spp * depth * 2
    sel = _cut(n, cpu_pixels)
    t_c, _ = timed(step(data.to("cpu"), sel), "cpu", reps=1)
    baseline = sel.shape[0] * spp * depth * 2 / t_c
    return {
        "metric": metric,
        "value": round(rays / t, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays / t / baseline, 4),
        "baseline_cpu_fwd_bwd_rays_per_sec": round(baseline, 1),
        "baseline_cpu_s": round(t_c, 4),
        "cpu_pixels": sel.shape[0],
        "step_ms": round(t * 1e3, 4),
        "rays": rays,
        "grads_finite": True,
        "peak_bytes": peak,
        "tris": data.num_tris,
        "wavefront": n, "spp": spp, "depth": depth,
        "device": device_label(dev),
        "note": note,
    }


def bmw_fwd_bwd(device="cuda", n=N_BMW, spp=SPP_BMW, depth=DEPTH_BMW,
                cpu_pixels=CPU_GRAD_PIXELS, reps=2, bmw=None) -> dict:
    return _bmw_grad(
        device, bmw, "bmw_fwd_bwd_rays_per_sec", FIELDS_ALL, None, n, spp, depth, cpu_pixels, reps,
        "one gradient of a pixel loss (emission, lobe_weight, vertices; trainable=None) "
        "through the cluster tracer, the first n pixels of the 512x512 frame; "
        "baseline = the same step on the host CPU over "
        "cpu_pixels of them",
    )


def bmw_fwd_bwd_scoped(device="cuda", n=N_BMW, spp=SPP_BMW, depth=DEPTH_BMW,
                       cpu_pixels=CPU_GRAD_PIXELS, reps=2, bmw=None) -> dict:
    return _bmw_grad(
        device, bmw, "bmw_fwd_bwd_scoped_emlw_rays_per_sec", EMLW, EMLW, n, spp, depth, cpu_pixels,
        reps,
        "emission+lobe_weight gradient with trainable=: those gradients as the full "
        "graph's, the vertex chains cut; baseline = the same step on the host CPU over "
        "cpu_pixels pixels",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bmw", action="store_true",
                    help="also the BMW forward and gradient-step lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: torch sees no CUDA device; the bench measures the card and "
              "does not run on the CPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    failed = []
    bmw = []  # the asset, loaded once at first use

    def asset():
        if not bmw:
            bmw.append(load_bmw(dev))
        return bmw[0]

    def emit(name, fn):
        try:
            line = fn()
        except Exception as e:  # noqa: BLE001 - one metric's failure must not stop the rest
            traceback.print_exc()
            line = {"metric": name, "error": repr(e)[:300]}
            failed.append(name)
        print(json.dumps(line), flush=True)

    emit("cornell_fwd_bwd_rays_per_sec", lambda: cornell_fwd_bwd(dev))
    emit("cornell_bvh_renderer_fwd_rays_per_sec", lambda: cornell_bvh_renderer_fwd(dev))
    emit("bmw_live_fwd_rays_per_sec", lambda: bmw_live(dev, bmw=asset()))
    if args.bmw:
        emit("bmw_fwd_rays_per_sec", lambda: bmw_fwd(dev, bmw=asset()))
        emit("bmw_fwd_bwd_rays_per_sec", lambda: bmw_fwd_bwd(dev, bmw=asset()))
        emit("bmw_fwd_bwd_scoped_emlw_rays_per_sec",
             lambda: bmw_fwd_bwd_scoped(dev, bmw=asset()))
    if failed:
        print(f"bench: {len(failed)} metric(s) failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Entry: progressive renders through ``Renderer.passes()``.

Set-up builds the configuration's scene as users bring it, the session
(``Renderer``) with the cell's options, and warms it with one whole pass
(every kernel, buffer and the film's gather). The window then runs renders
back to back, each under a new render seed drawn from the run's seed, pass
after pass, each pass's film gathered to the host; once the window's time
is up the render is cancelled between chunks, and only whole passes count.
A traced run times ``trace_passes`` passes untraced, then traces as many.
The check compares two of the window's films (the last, and one drawn from
the seed among all of them) at pixels drawn from the seed with the plain
reference's films of the same seeds and samples.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from harness import check, common, data, program_scene
from harness.profile import Trace


class Counted:
    """A call counter around the session's sharded render function."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _options(cell):
    from phosphorus_mk2_tpu_torch.core.options import Options

    return Options(samples_per_pixel=cell["spp"], samples_per_pass=cell["samples_per_pass"],
                   path_depth=cell["path_depth"], mis=cell["mis"], use_bvh=cell["use_bvh"],
                   max_wavefront=cell.get("max_wavefront", 0),
                   tracer_tune=cell.get("tracer_tune"))


def session(ctx):
    """(renderer, session seconds) after the scene is made and imported."""
    from phosphorus_mk2_tpu_torch.renderer import Renderer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    arrays = data.scene_arrays(cfg, cell["width"], cell["height"])
    scene = program_scene.build(cfg, arrays)
    t0 = common.synced(dev)
    r = Renderer(scene, _options(cell), device=dev)
    return r, common.synced(dev) - t0


def warm(ctx, renderer):
    """One whole pass of a render under a seed of its own."""
    renderer.options.seed = int(common.rng(ctx["seed"], 6).integers(0, 2 ** 31))
    for _ in renderer.passes():
        break


def _answers(ctx, renderer):
    """Run the window; returns (timing, films kept for the check, trace)."""
    cell, dev = ctx["cell"], ctx["device"]
    w, h = cell["width"], cell["height"]
    seeds = common.rng(ctx["seed"], 1)
    pick = common.rng(ctx["seed"], 2)
    counted = renderer.fn = Counted(renderer.fn)
    per_pass = max(1, min(cell["samples_per_pass"], cell["spp"]))
    traced = ctx["trace"]
    limit = {"passes": cell["trace_passes"] if traced else None}
    out = {"pass_s": [], "samples": 0, "films": {}, "seen": 0}
    t_w0 = common.now()
    deadline = t_w0 + ctx["seconds"]

    def cancel():
        return limit["passes"] is None and common.now() >= deadline

    def one_render():
        rseed = int(seeds.integers(0, 2 ** 31))
        renderer.options.seed = rseed
        t_prev = common.now()
        prev = 0
        for film, done in renderer.passes(cancel=cancel):
            t = common.now()
            out["pass_s"].append(t - t_prev)
            out["t_end"] = t_prev = t
            out["samples"] += w * h * (done - prev)
            prev = done
            out["seen"] += 1
            out["films"]["last"] = (rseed, done, film)
            if pick.random() * out["seen"] < 1.0:
                out["films"]["drawn"] = (rseed, done, film)
            if limit["passes"] is not None and out["seen"] >= limit["passes"]:
                return True
        return cancel()

    trace = None
    gc0 = [g["collections"] for g in gc.get_stats()]
    if traced:
        from phosphorus_mk2_tpu_torch.accel import mt

        while not one_render():  # the same passes untraced, to compare
            pass
        untraced = list(out["pass_s"])
        limit["passes"] *= 2
        calls = []
        original = mt.mt_closest

        def recorded(table, p, d, cols=None):
            calls.append((int(p.shape[0]), int(mt.live_columns(table) if cols is None else cols)))
            return original(table, p, d, cols=cols)

        mt.mt_closest = recorded
        counted.calls = 0
        trace = Trace()
        try:
            with trace.record():
                while not one_render():
                    pass
        finally:
            mt.mt_closest = original
        passes = out["seen"] - len(untraced)
        trace.extra = {"chunks": counted.calls, "passes": passes, "spp": passes * per_pass,
                       "mt_calls": calls, "untraced_pass_s": untraced,
                       "traced_pass_s": out["pass_s"][len(untraced):]}
    else:
        while not one_render():
            pass
    if not out["seen"]:
        raise RuntimeError("no pass completed in the window: the window is shorter than a pass")
    out["gc"] = [g["collections"] - c for g, c in zip(gc.get_stats(), gc0)]
    out["wall_s"] = out["t_end"] - t_w0
    return out, trace


def reference_films(ctx, answers, pixels, bf16=False):
    """The reference's films at ``pixels`` for each (seed, samples) kept."""
    from reference import integrator
    from reference.scene import Camera, Tables
    from reference.trace import Tracer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    arrays = data.scene_arrays(cfg, cell["width"], cell["height"])
    tb = Tables(arrays["meshes"], cfg["materials"], cfg.get("background"), dev, bf16=bf16)
    cam = Camera(arrays["camera"], dev)
    tracer = Tracer(tb.tri[:, 0:3], tb.tri[:, 3:6], tb.tri[:, 6:9])
    px = torch.as_tensor(pixels % cell["width"], device=dev)
    py = torch.as_tensor(pixels // cell["width"], device=dev)
    per_pass = max(1, min(cell["samples_per_pass"], cell["spp"]))
    strata = integrator.strata_of(cell["spp"])
    out = {}
    with torch.no_grad():
        for key, (rseed, done) in answers.items():
            c, n, a = integrator.film(tb, cam, tracer, px, py, rseed, done, per_pass,
                                      max_depth=cell["path_depth"], mis=cell["mis"],
                                      strata=strata)
            out[key] = {"color": c.cpu().numpy(), "normal": n.cpu().numpy(),
                        "alpha": a.cpu().numpy()}
    return out


def check_pixels(ctx):
    cell = ctx["cell"]
    n = cell["width"] * cell["height"]
    k = min(n, cell["check"]["pixels"])
    return np.sort(common.rng(ctx["seed"], 3).choice(n, size=k, replace=False))


def compare(ctx, prog_films, ref_films):
    """The worst of each compared number over the films kept."""
    chk = ctx["cell"]["check"]
    numbers = {}
    for key in ref_films:
        got = check.film_numbers(prog_films[key], ref_films[key], chk["tol_rel"], chk["tol_abs"])
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def run(ctx):
    cell, dev = ctx["cell"], ctx["device"]
    renderer, session_s = session(ctx)
    with torch.no_grad():
        warm(ctx, renderer)
    setup_s = common.synced(dev) - ctx["t_start"]
    out, trace = _answers(ctx, renderer)
    device = common.device_record(dev)
    del renderer
    common.free(dev)

    t_check = common.now()
    pixels = check_pixels(ctx)
    kept = {k: (v[0], v[1]) for k, v in out["films"].items()}
    prog = {}
    for key, (_, _, film) in out["films"].items():
        prog[key] = {k: film[k].reshape(-1, film[k].shape[-1] if film[k].ndim == 3 else 1)[pixels]
                     for k in ("color", "normal", "alpha")}
    numbers = compare(ctx, prog, reference_films(ctx, kept, pixels))
    correct, rows = check.judge(numbers, cell["check"]["limits"])
    check_s = common.now() - t_check

    w, h = cell["width"], cell["height"]
    result = {"correct": correct, "attempted": out["seen"], "failed": 0 if correct else 1,
              "device": device, "checked": rows,
              "films_checked": {k: [int(v[0]), int(v[1])] for k, v in kept.items()}}
    if trace is None:
        e2e = {"render_samples_per_s": {"value": out["samples"] / out["wall_s"],
                                        "unit": "samples/s"},
               "pass_p95_ms": {"value": common.p95(out["pass_s"]) * 1e3, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
        result["metrics"] = e2e
        ms = np.asarray(out["pass_s"]) * 1e3
        tenths = np.array_split(ms, min(10, ms.size))
        result["info"] = {"passes": out["seen"], "window_s": out["wall_s"],
                          "pass_ms_quartiles": [float(q) for q in np.percentile(ms, [25, 50, 75])],
                          "pass_median_ms_by_tenth": [round(float(np.median(t)), 3)
                                                      for t in tenths],
                          "gc_collections_by_generation": out["gc"],
                          "session_s": session_s, "pixels_checked": int(pixels.size),
                          "check_s": check_s, "frame": [w, h]}
    else:
        ctx_m = {"trace": trace, "session_s": session_s, **trace.extra}
        result["trace"] = trace
        result["reader_ctx"] = ctx_m
        result["info"] = {"untraced_pass_ms": [x * 1e3 for x in trace.extra["untraced_pass_s"]],
                          "traced_pass_ms": [x * 1e3 for x in trace.extra["traced_pass_s"]],
                          "traced_window_idle_pct": 100.0 * (1.0 - trace.busy_s()
                                                             / trace.window_s()),
                          "check_s": check_s}
    return result

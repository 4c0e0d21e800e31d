"""Entry: progressive renders through ``Renderer.passes()`` of a
configuration whose materials go past the Cornell reference's: the sheen
lobe, with the glossy, mirror, glass and Oren-Nayar lobes.

The session, the warm-up, the window, the pixels checked and the
comparison are ``entries/render.py``'s, imported unchanged; what differs is
the scene, built through the program's scene API with the material kind
``sheen`` added to ``harness/program_scene.py``'s kinds, and the films of
the check, taken from ``reference_lobes/`` (the plain reference with the
sheen lobe). The result keys and the per-layer readers' context are those
of ``render.py``, with two more for the cluster tracer's readers:
``tracer_stats``, what the tracer's ``STATS`` counters gained in the
session's calls made while the window was traced, and ``wave_work``, what
``wave_mt``'s ``WORK`` counters hold after the window (each None where the
program keeps no such counter).
"""
from __future__ import annotations

import numpy as np
import torch

from entries import render
from harness import check, common, data, program_scene


def _material(m: dict):
    from phosphorus_mk2_tpu_torch.core.material import Material

    return Material.sheen(tuple(m["color"]), roughness=m["roughness"], name=m["name"])


def build_scene(cfg: dict, arrays: dict):
    """``program_scene.build`` of the configuration, each ``sheen`` material
    then put in its slot (made first as a stand-in diffuse one)."""
    mats = cfg["materials"]
    stand_in = [dict(m, kind="diffuse") if m["kind"] == "sheen" else m for m in mats]
    scene = program_scene.build(dict(cfg, materials=stand_in), arrays)
    for i, m in enumerate(mats):
        if m["kind"] == "sheen":
            scene.materials[i] = _material(m)
    return scene


def session(ctx):
    """(renderer, session seconds) after the scene is made and imported."""
    from phosphorus_mk2_tpu_torch.renderer import Renderer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    scene = build_scene(cfg, data.scene_arrays(cfg, cell["width"], cell["height"]))
    t0 = common.synced(dev)
    r = Renderer(scene, render._options(cell), device=dev)
    return r, common.synced(dev) - t0


class TracedStats:
    """Around the session's render function: what the cluster tracer's
    ``STATS`` gained in the calls made while a torch.profiler session is
    active (host integers; nothing is added on the device)."""

    def __init__(self, fn, stats):
        self.fn, self.stats, self.gained = fn, stats, {}

    def __call__(self, *args, **kwargs):
        if not torch._C._autograd._profiler_enabled():
            return self.fn(*args, **kwargs)
        before = dict(self.stats)
        out = self.fn(*args, **kwargs)
        for k, v in self.stats.items():
            self.gained[k] = self.gained.get(k, 0) + v - before.get(k, 0)
        return out


def _program_counters():
    """(the cluster tracer's STATS, wave_mt's WORK) of the program, each None
    where it keeps no such counter."""
    from phosphorus_mk2_tpu_torch.utils import profiling

    rec = getattr(profiling, "RECORDER", None)
    groups = rec.read()["counters"] if rec is not None else {}
    return groups.get("accel.cluster_traverse.STATS"), groups.get("accel.wave.WORK")


def reference_films(ctx, answers, pixels, bf16=False):
    """The reference's films at ``pixels`` for each (seed, samples) kept."""
    from reference.scene import Camera
    from reference.trace import Tracer
    from reference_lobes import integrator
    from reference_lobes.scene import Tables

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


def control_readings(ctx) -> dict:
    """The precision control (``benchmark/control.py``'s, for this entry):
    the reference with bfloat16 tables judged against the float32 one on
    the films of one render's seed, at ``control_samples`` and at one pass."""
    cell = ctx["cell"]
    per_pass = max(1, min(cell["samples_per_pass"], cell["spp"]))
    seed0 = int(common.rng(ctx["seed"], 1).integers(0, 2 ** 31))
    answers = {"last": (seed0, cell.get("control_samples", cell["spp"])),
               "drawn": (seed0, per_pass)}
    pixels = render.check_pixels(ctx)
    ref = reference_films(ctx, answers, pixels)
    low = reference_films(ctx, answers, pixels, bf16=True)
    return render.compare(ctx, low, ref)


def run(ctx):
    from phosphorus_mk2_tpu_torch.accel import cluster_traverse

    cell, dev = ctx["cell"], ctx["device"]
    _, work = _program_counters()
    if work is not None:
        work.clear()  # WORK gains only while traced: from here, this run's window
    renderer, session_s = session(ctx)
    with torch.no_grad():
        render.warm(ctx, renderer)
    setup_s = common.synced(dev) - ctx["t_start"]
    stats = renderer.fn = TracedStats(renderer.fn, cluster_traverse.STATS)
    out, trace = render._answers(ctx, renderer)
    device = common.device_record(dev)
    del renderer
    common.free(dev)

    t_check = common.now()
    pixels = render.check_pixels(ctx)
    kept = {k: (v[0], v[1]) for k, v in out["films"].items()}
    prog = {}
    for key, (_, _, film) in out["films"].items():
        prog[key] = {k: film[k].reshape(-1, film[k].shape[-1] if film[k].ndim == 3 else 1)[pixels]
                     for k in ("color", "normal", "alpha")}
    numbers = render.compare(ctx, prog, reference_films(ctx, kept, pixels))
    correct, rows = check.judge(numbers, cell["check"]["limits"])
    check_s = common.now() - t_check

    w, h = cell["width"], cell["height"]
    result = {"correct": correct, "attempted": out["seen"], "failed": 0 if correct else 1,
              "device": device, "checked": rows,
              "films_checked": {k: [int(v[0]), int(v[1])] for k, v in kept.items()}}
    info = {"session_s": session_s, "pixels_checked": int(pixels.size), "check_s": check_s,
            "frame": [w, h]}
    if trace is None:
        result["metrics"] = {"render_samples_per_s": {"value": out["samples"] / out["wall_s"],
                                                      "unit": "samples/s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
        ms = np.asarray(out["pass_s"]) * 1e3
        info.update({"passes": out["seen"], "window_s": out["wall_s"],
                     "pass_ms_quartiles": [float(q) for q in np.percentile(ms, [25, 50, 75])],
                     "gc_collections_by_generation": out["gc"]})
    else:
        _, work = _program_counters()
        wave_work = None if work is None else {k: v.tolist() for k, v in work.items()}
        result["trace"] = trace
        result["reader_ctx"] = {"trace": trace, "session_s": session_s, **trace.extra,
                                "tracer_stats": stats.gained or None, "wave_work": wave_work}
        info.update({"untraced_pass_ms": [x * 1e3 for x in trace.extra["untraced_pass_s"]],
                     "traced_pass_ms": [x * 1e3 for x in trace.extra["traced_pass_s"]],
                     "traced_window_idle_pct": 100.0 * (1.0 - trace.busy_s() / trace.window_s()),
                     "tracer_stats": stats.gained, "wave_work": wave_work})
    result["info"] = info
    return result

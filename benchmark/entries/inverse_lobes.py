"""Entry: inverse-rendering steps through ``InverseRenderer.step()`` on a
configuration whose materials go past the Cornell reference's: the sheen
lobe, with the glossy, mirror, glass and Oren-Nayar lobes.

The procedure is ``entries/inverse.py``'s: set-up builds the scene as users
bring it, a target image and a start drawn from the run's seed (each
trainable value times a factor in [0.5, 1.5)) and the optimizer session,
then drives that session through its first steps, the warm-up and the
check's first answers; the window takes steps back to back on the same
session, the loss read back to the host each step; after the window the
session takes more steps, the check's second answers. What differs:

* the scene is built by ``entries/render_lobes.build_scene`` (the material
  kind ``sheen`` added), and the check's reference is ``reference_lobes/``
  (its tables, lobes, integrator and ``inverse``), the trace staying the
  reference's own brute one;
* the steps checked are the traffic file's ``check.steps_start`` (from the
  seeded start: losses, first gradient, change) and ``check.steps_after``
  (from the session's state after the window: losses, change). Every
  reference step renders the whole frame at the cell's samples, so the
  check's time is the same whatever the window did;
* a traced run also shows the program's ``optim.SAVED`` counter (bytes
  and tensors autograd saved in the forwards of the steps taken while a
  profiler session was active, and those forwards; None where the program
  keeps no such counter) beside its numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from entries.inverse import inputs, opt_seed, seeded_start, steps_from
from entries.render_lobes import build_scene
from harness import check, common, data
from harness.profile import Trace

TRAINABLE = ("emission", "lobe_weight")


def _lobes_used(cfg) -> tuple:
    from reference_lobes.scene import lobes_of

    mats = list(cfg["materials"]) + ([cfg["background"]] if cfg.get("background") else [])
    return max(1, max(len(lobes_of(m)[0]) for m in mats)), len(mats)


def session(ctx, target, factors):
    """(InverseRenderer at the seeded start, session seconds)."""
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    scene = build_scene(cfg, data.scene_arrays(cfg, cell["width"], cell["height"]))
    t0 = common.synced(dev)
    inv = InverseRenderer(scene, target, trainable=TRAINABLE,
                          learning_rate=cell["learning_rate"], spp=cell["spp"],
                          max_depth=cell["max_depth"], use_bvh=cell["use_bvh"],
                          seed=opt_seed(ctx), device=dev)
    session_s = common.synced(dev) - t0
    with torch.no_grad():
        for name, f in factors.items():
            # the table's lobe slots past the materials' own lobes hold none
            p = inv.params[name][:f.shape[0]]
            view = p[:, :f.shape[1]] if name == "lobe_weight" else p
            view.mul_(torch.from_numpy(f).to(p.device))
    return inv, session_s


def reference(ctx, bf16=False) -> dict:
    """The reference's scene tables (with the sheen lobe), camera, tracer
    and pixels of the cell."""
    from reference.scene import Camera
    from reference.trace import Tracer
    from reference_lobes.scene import Tables

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    arrays = data.scene_arrays(cfg, cell["width"], cell["height"])
    tb = Tables(arrays["meshes"], cfg["materials"], cfg.get("background"), dev, bf16=bf16)
    ids = torch.arange(cell["width"] * cell["height"], device=dev)
    return {"tables": tb, "camera": Camera(arrays["camera"], dev), "bf16": bf16,
            "tracer": Tracer(tb.tri[:, 0:3], tb.tri[:, 3:6], tb.tri[:, 6:9]),
            "px": ids % cell["width"], "py": ids // cell["width"]}


def reference_steps(ctx, ref: dict, target, start: dict, first: int, n: int,
                    state=None) -> tuple:
    """(the reference's steps first+1 .. first+n from float64 ``start`` and
    Adam ``state`` (moments, as ``steps_from`` gives them; None: fresh),
    the parameters and Adam's state after them)."""
    from reference import rng
    from reference_lobes import inverse

    cell, dev = ctx["cell"], ctx["device"]
    start = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in start.items()}
    if ref["bf16"]:
        start = {k: v.to(torch.bfloat16).to(torch.float64) for k, v in start.items()}
    if state is not None:
        state = tuple({k: torch.as_tensor(v, device=dev) for k, v in state[key].items()}
                      for key in ("m", "v")) + (first,)
    tgt = torch.from_numpy(target.reshape(-1, 3)).to(dev)
    seeds = rng.step_seeds(opt_seed(ctx), first + n)[first:]
    losses, grad, last, after = inverse.run(
        ref["tables"], ref["camera"], ref["tracer"], ref["px"], ref["py"], tgt, start, seeds,
        spp=cell["spp"], max_depth=cell["max_depth"], lr=cell["learning_rate"],
        block=cell["check"]["block"], state=state)
    answers = {"losses": losses, "grad": {k: v.cpu().numpy() for k, v in grad.items()},
               "change": {k: (last[k] - start[k]).cpu().numpy() for k in start}}
    return answers, last, after


def control_readings(ctx) -> dict:
    """The precision control (``benchmark/control.py``'s, for this entry):
    the reference with bfloat16 tables in the program's place, judged
    against the float32 reference as a run is: its first steps from the
    seeded start, then the after-window steps from its own state after
    them, as a run's continue from the session's state."""
    n_start, n_after = ctx["cell"]["check"]["steps_start"], ctx["cell"]["check"]["steps_after"]
    lobes, materials = _lobes_used(ctx["config"])
    target, factors = inputs(ctx, lobes, materials)
    ref, low = reference(ctx), reference(ctx, bf16=True)
    first, _, _ = reference_steps(ctx, ref, target, seeded_start(ref, factors), 0, n_start)
    got, last, (m, v, _) = reference_steps(ctx, low, target, seeded_start(low, factors), 0,
                                           n_start)
    state = {"m": m, "v": v}
    low_after, _, _ = reference_steps(ctx, low, target, last, n_start, n_after, state)
    low_after.pop("grad")  # judged as a run's second stage is: losses and change
    ref_after, _, _ = reference_steps(ctx, ref, target, last, n_start, n_after, state)
    return check.worst(check.step_numbers(got, first), check.step_numbers(low_after, ref_after))


def _saved_counter():
    """The program's ``optim.SAVED`` counter, or None where it keeps none."""
    from phosphorus_mk2_tpu_torch.utils import profiling

    rec = getattr(profiling, "RECORDER", None)
    return (rec.read()["counters"] if rec is not None else {}).get("optim.SAVED")


def run(ctx):
    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    n_start, n_after = cell["check"]["steps_start"], cell["check"]["steps_after"]
    lobes, materials = _lobes_used(cfg)
    target, factors = inputs(ctx, lobes, materials)
    inv, session_s = session(ctx, target, factors)
    _, answers = steps_from(inv, n_start, lobes, materials, grad=True)
    setup_s = common.synced(dev) - ctx["t_start"]

    steps, trace, untraced, saved = 0, None, [], None
    if ctx["trace"]:
        for _ in range(cell["trace_steps"]):  # the same steps untraced, to compare
            t0 = common.now()
            inv.step()
            untraced.append(common.now() - t0)
        steps += len(untraced)
        trace = Trace()
        with trace.record():
            for _ in range(cell["trace_steps"]):
                inv.step()
        trace.extra = {"steps": cell["trace_steps"], "untraced_step_s": untraced}
        saved = _saved_counter()
        steps += cell["trace_steps"]
    else:
        t_prev = t_w0 = common.now()
        deadline = t_w0 + ctx["seconds"]
        step_s = []  # each step ends with its loss on the host
        while t_prev < deadline:
            inv.step()
            t = common.now()
            step_s.append(t - t_prev)
            t_prev = t
        wall = common.synced(dev) - t_w0
        steps = len(step_s)
    taken = n_start + steps
    state, after = steps_from(inv, n_after, lobes, materials)
    device = common.device_record(dev)
    del inv
    common.free(dev)

    t_check = common.now()
    ref = reference(ctx)
    first, _, _ = reference_steps(ctx, ref, target, seeded_start(ref, factors), 0, n_start)
    ref_after, _, _ = reference_steps(ctx, ref, target, state["params"], taken, n_after, state)
    stages = {"start": check.step_numbers(answers, first),
              "after the window": check.step_numbers(after, ref_after)}
    numbers = check.worst(*stages.values())
    check_s = common.now() - t_check
    correct, rows = check.judge(numbers, cell["check"]["limits"])
    result = {"correct": correct, "attempted": taken + n_after,
              "failed": 0 if correct else 1, "device": device, "checked": rows,
              "info": {f"stage {k}": v for k, v in stages.items()}}
    result["info"].update({"check_s": check_s, "frame": [cell["width"], cell["height"]],
                           "losses": answers["losses"], "session_s": session_s})
    if trace is None:
        result["metrics"] = {"grad_step_s": {"value": wall / steps, "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
        result["info"].update({"steps": steps, "window_s": wall, "step_s_quartiles":
                               [float(q) for q in np.percentile(step_s, [25, 50, 75])]})
    else:
        result["info"].update({"untraced_step_s": untraced,
                               "traced_step_s": trace.window_s() / cell["trace_steps"],
                               "traced_window_idle_pct": 100.0 * (1.0 - trace.busy_s()
                                                                  / trace.window_s()),
                               "saved": None if saved is None else dict(saved)})
        result["trace"] = trace
        result["reader_ctx"] = {"trace": trace, "session_s": session_s, **trace.extra}
    return result

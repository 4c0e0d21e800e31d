"""Entry: inverse-rendering steps through ``InverseRenderer.step()``.

Set-up builds the scene as users bring it, a target image and a start drawn
from the run's seed (each trainable value of the scene times a factor in
[0.5, 1.5)), and the optimizer session (``InverseRenderer`` with its
documented defaults), then drives that session through its first steps:
they are the warm-up, and the check's first answers. The window takes steps
back to back on the same session, each a forward, the loss, the backward
and an Adam update, with the loss read back to the host. After the window
the session takes two more steps, the check's second answers. The check
holds each stage's losses and the parameters' change, and the first
gradient (from Adam's first moment), against the plain reference's steps: the first
stage from the same seeded start, the second from the session's own
parameters and Adam moments as the window left them (the reference cannot
replay the window's steps in the check's time).
"""
from __future__ import annotations

import numpy as np
import torch

from harness import check, common, data, program_scene
from harness.profile import Trace

TRAINABLE = ("emission", "lobe_weight")
CHECKED_STEPS = 3   # from the seeded start, before the window
AFTER_STEPS = 2     # from the session's state after the window


def inputs(ctx, lobes: int, materials: int):
    """(target (H, W, 3) float32, start factors {field: array}) of the seed."""
    cell = ctx["cell"]
    g = common.rng(ctx["seed"], 4)
    target = g.uniform(0.0, 1.0, size=(cell["height"], cell["width"], 3)).astype(np.float32)
    factors = {"emission": g.uniform(0.5, 1.5, size=(materials, 3)).astype(np.float32),
               "lobe_weight": g.uniform(0.5, 1.5, size=(materials, lobes, 3)).astype(np.float32)}
    return target, factors


def opt_seed(ctx) -> int:
    return int(common.rng(ctx["seed"], 5).integers(0, 2 ** 31))


def _lobes_used(cfg) -> tuple:
    from reference.scene import lobes_of

    mats = list(cfg["materials"]) + ([cfg["background"]] if cfg.get("background") else [])
    return max(1, max(len(lobes_of(m)[0]) for m in mats)), len(mats)


def session(ctx, target, factors):
    """(InverseRenderer at the seeded start, session seconds)."""
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    arrays = data.scene_arrays(cfg, cell["width"], cell["height"])
    scene = program_scene.build(cfg, arrays)
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


def _leaves(params: dict, lobes: int, materials: int) -> dict:
    return {k: (v[:materials, :lobes] if k == "lobe_weight" else v[:materials]).detach()
            .to(torch.float64).cpu().numpy() for k, v in params.items()}


def _moment(inv, name: str, lobes: int, materials: int) -> dict:
    # a parameter Adam has not stepped has no moment: zero
    return _leaves({k: inv.opt.state.get(p, {}).get(name, torch.zeros_like(p))
                    for k, p in inv.params.items()}, lobes, materials)


def steps_from(inv, n: int, lobes: int, materials: int, grad: bool = False) -> tuple:
    """(the session's state now: parameters and Adam's moments, its next n
    steps: losses, the change after the last and, with ``grad`` (a fresh
    Adam only), the first step's gradient as Adam holds it, exp_avg /
    (1 - beta1)). Later in a run the gradient is not taken from the
    moments: (exp_avg' - beta1 exp_avg) / (1 - beta1) in float32 loses
    6e-7 of |exp_avg| to rounding, many times |gradient| once the steps
    shrink."""
    state = {"params": _leaves(inv.params, lobes, materials),
             "m": _moment(inv, "exp_avg", lobes, materials),
             "v": _moment(inv, "exp_avg_sq", lobes, materials)}
    answers = {"losses": []}
    for i in range(n):
        answers["losses"].append(float(inv.step()))
        if i == 0 and grad:
            b1 = inv.opt.param_groups[0]["betas"][0]
            m1 = _moment(inv, "exp_avg", lobes, materials)
            answers["grad"] = {k: v / (1.0 - b1) for k, v in m1.items()}
    p = _leaves(inv.params, lobes, materials)
    answers["change"] = {k: p[k] - state["params"][k] for k in p}
    return state, answers


def reference(ctx, bf16=False) -> dict:
    """The reference's scene tables, camera, tracer and pixels of the cell."""
    from reference.scene import Camera, Tables
    from reference.trace import Tracer

    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    arrays = data.scene_arrays(cfg, cell["width"], cell["height"])
    tb = Tables(arrays["meshes"], cfg["materials"], cfg.get("background"), dev, bf16=bf16)
    ids = torch.arange(cell["width"] * cell["height"], device=dev)
    return {"tables": tb, "camera": Camera(arrays["camera"], dev), "bf16": bf16,
            "tracer": Tracer(tb.tri[:, 0:3], tb.tri[:, 3:6], tb.tri[:, 6:9]),
            "px": ids % cell["width"], "py": ids // cell["width"]}


def seeded_start(ref: dict, factors: dict) -> dict:
    """The trainable fields at the seeded start, float64 on the device."""
    tb = ref["tables"]
    return {k: (getattr(tb, k) * torch.from_numpy(f).to(tb.tri.device)).to(torch.float64)
            for k, f in factors.items()}


def reference_steps(ctx, ref: dict, target, start: dict, first: int, n: int,
                    state=None) -> tuple:
    """(the reference's steps first+1 .. first+n from float64 ``start`` and
    Adam ``state`` (moments, as ``steps_from`` gives them; None: fresh),
    the parameters and Adam's state after them)."""
    from reference import inverse, rng

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


def run(ctx):
    cell, cfg, dev = ctx["cell"], ctx["config"], ctx["device"]
    lobes, materials = _lobes_used(cfg)
    target, factors = inputs(ctx, lobes, materials)
    inv, session_s = session(ctx, target, factors)
    _, answers = steps_from(inv, CHECKED_STEPS, lobes, materials, grad=True)
    setup_s = common.synced(dev) - ctx["t_start"]

    steps, trace, untraced = 0, None, []
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
        steps += cell["trace_steps"]
    else:
        t_w0 = common.now()
        deadline = t_w0 + ctx["seconds"]
        while common.now() < deadline:
            inv.step()
            steps += 1
        wall = common.synced(dev) - t_w0
    taken = CHECKED_STEPS + steps
    state, after = steps_from(inv, AFTER_STEPS, lobes, materials)
    device = common.device_record(dev)
    del inv
    common.free(dev)

    t_check = common.now()
    ref = reference(ctx)
    first, _, _ = reference_steps(ctx, ref, target, seeded_start(ref, factors), 0, CHECKED_STEPS)
    ref_after, _, _ = reference_steps(ctx, ref, target, state["params"], taken, AFTER_STEPS,
                                      state)
    stages = {"start": check.step_numbers(answers, first),
              "after the window": check.step_numbers(after, ref_after)}
    numbers = check.worst(*stages.values())
    check_s = common.now() - t_check
    correct, rows = check.judge(numbers, cell["check"]["limits"])
    result = {"correct": correct, "attempted": taken + AFTER_STEPS,
              "failed": 0 if correct else 1, "device": device, "checked": rows,
              "info": {f"stage {k}": v for k, v in stages.items()}}
    result["info"]["check_s"] = check_s
    if trace is None:
        result["metrics"] = {"grad_step_s": {"value": wall / steps, "unit": "s"},
                             "setup_s": {"value": setup_s, "unit": "s"}}
        result["info"].update({"steps": steps, "window_s": wall, "session_s": session_s,
                               "losses": answers["losses"]})
    else:
        result["info"].update({"untraced_step_s": untraced,
                               "traced_step_s": trace.window_s() / cell["trace_steps"],
                               "traced_window_idle_pct": 100.0 * (1.0 - trace.busy_s()
                                                                  / trace.window_s())})
        result["trace"] = trace
        result["reader_ctx"] = {"trace": trace, "session_s": session_s, **trace.extra}
    return result

"""The precision control of a cell: the plain reference put in the program's
place, computed with every stored float table rounded to bfloat16, judged
by the cell's own comparison against the float32 reference; with --program
also the program itself with its own lower-precision path switched on,
where the cell's traffic file names one (``program_control``).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--program]

Prints one JSON line a seed and control with the compared numbers and their
limits and whether the control fails the cell (it must). The benchmark's
own runs never run it.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def render_readings(ctx) -> dict:
    from entries import render
    from harness import common

    cell = ctx["cell"]
    per_pass = max(1, min(cell["samples_per_pass"], cell["spp"]))
    seed0 = int(common.rng(ctx["seed"], 1).integers(0, 2 ** 31))
    answers = {"last": (seed0, cell.get("control_samples", cell["spp"])),
               "drawn": (seed0, per_pass)}
    pixels = render.check_pixels(ctx)
    ref = render.reference_films(ctx, answers, pixels)
    low = render.reference_films(ctx, answers, pixels, bf16=True)
    return render.compare(ctx, low, ref)


def inverse_readings(ctx) -> dict:
    """Both stages of the gradient cells' check, with the reference in
    bfloat16 as the program: its first steps from the seeded start, then
    two more from its own state after them, as a run's steps after the
    window continue from the session's state."""
    from entries import inverse
    from harness import check

    lobes, materials = inverse._lobes_used(ctx["config"])
    target, factors = inverse.inputs(ctx, lobes, materials)
    n, after = inverse.CHECKED_STEPS, inverse.AFTER_STEPS
    ref, low = inverse.reference(ctx), inverse.reference(ctx, bf16=True)
    first, _, _ = inverse.reference_steps(ctx, ref, target, inverse.seeded_start(ref, factors),
                                          0, n)
    got, last, (m, v, _) = inverse.reference_steps(
        ctx, low, target, inverse.seeded_start(low, factors), 0, n)
    state = {"m": m, "v": v}
    low_after, _, _ = inverse.reference_steps(ctx, low, target, last, n, after, state)
    low_after.pop("grad")  # judged as a run's second stage is: loss and change
    ref_after, _, _ = inverse.reference_steps(ctx, ref, target, last, n, after, state)
    return check.worst(check.step_numbers(got, first), check.step_numbers(low_after, ref_after))


def readings(workload: str, seed: int, device: str, overrides=None, config_overrides=None):
    """(numbers, limits) of the control on one seed."""
    import torch

    from harness import data

    cell = data.workload(workload)
    cell.update(overrides or {})
    cfg = data.config(cell["config"])
    cfg.update(config_overrides or {})
    ctx = {"cell": cell, "config": cfg, "seed": seed, "device": torch.device(device)}
    fn = render_readings if cell["entry"] == "render" else inverse_readings
    return fn(ctx), cell["check"]["limits"]


def program_readings(workload: str, seed: int, seconds: float):
    """The compared numbers of a run of the program with its own
    lower-precision path switched on (the cell's ``program_control``)."""
    import run
    from harness import data

    over = data.workload(workload).get("program_control")
    if over is None:
        return None
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", "0"])
    res = run.execute(args, overrides=over)
    return {name: value for name, value, _ in res["checked"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program", action="store_true",
                    help="also run the program with its own lower-precision path, if any")
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args()
    from harness import check

    for s in a.seeds.split(","):
        numbers, limits = readings(a.workload, int(s), a.device)
        ok, rows = check.judge(numbers, limits)
        print(json.dumps({"workload": a.workload, "seed": int(s), "control_fails": not ok,
                          "numbers": rows}), flush=True)
        if a.program:
            got = program_readings(a.workload, int(s), a.seconds)
            if got is not None:
                ok, rows = check.judge(got, limits)
                print(json.dumps({"workload": a.workload, "seed": int(s), "program_control": True,
                                  "control_fails": not ok, "numbers": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

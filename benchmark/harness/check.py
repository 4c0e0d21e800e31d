"""The comparisons that decide ``correct``: every number compared with the
limit its cell's traffic file states, printed beside it."""
from __future__ import annotations

import statistics

import numpy as np


def film_numbers(prog: dict, ref: dict, tol_rel: float, tol_abs: float) -> dict:
    """Of sampled pixels' films (color (N, 3), normal (N, 3), alpha (N,)):
    bad_pixel_share, the share of pixels with some value off the reference
    by more than tol_abs + tol_rel * |reference value|."""
    bad = np.zeros(ref["alpha"].shape[0], bool)
    for k in ("color", "normal", "alpha"):
        p = np.asarray(prog[k], np.float64).reshape(bad.shape[0], -1)
        r = np.asarray(ref[k], np.float64).reshape(bad.shape[0], -1)
        off = ~(np.abs(p - r) <= tol_abs + tol_rel * np.abs(r))
        bad |= off.any(axis=1)
    return {"bad_pixel_share": float(bad.mean())}


def _worst_leaf(prog: dict, ref: dict) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref leaf|, |median leaf|)."""
    norms = {k: float(np.linalg.norm(np.asarray(ref[k], np.float64))) for k in ref}
    med = statistics.median(norms.values())
    worst = 0.0
    for k in ref:
        pn = float(np.linalg.norm(np.asarray(prog[k], np.float64)))
        worst = max(worst, abs(pn - norms[k]) / max(norms[k], med, 1e-30))
    return worst


def step_numbers(prog: dict, ref: dict) -> dict:
    """Of an optimizer run's steps: loss_gap, the worst step's
    |loss - reference| / reference; change_gap, the parameters' change
    after the last step, worst leaf; grad_gap, where the program's answers
    hold the first gradient, its worst leaf."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": float(loss_gap)}
    if "grad" in prog:
        out["grad_gap"] = _worst_leaf(prog["grad"], ref["grad"])
    out["change_gap"] = _worst_leaf(prog["change"], ref["change"])
    return out


def worst(*stages: dict) -> dict:
    """The largest reading of each number over the stages that have it."""
    names = dict.fromkeys(k for st in stages for k in st)
    return {k: max(float(st[k]) for st in stages if k in st) for k in names}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]): every number at or under its
    limit; a number that is not finite fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits[name]
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        rows.append([name, value, limit])
    return ok, rows

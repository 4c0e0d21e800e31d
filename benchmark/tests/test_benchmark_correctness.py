"""What decides ``correct``, shown to fail: the precision control (the
reference with its tables in bfloat16 in the program's place) fails every
cell's comparison, and a run whose timed path is broken underneath comes
out not correct, once for each fault a cell can have. On the CPU at tiny
sizes; the ``card`` test runs the control at each cell's own size."""
import pytest
import torch

import control
from test_benchmark_harness import run_small, small

CELLS = ["cornell_box.render", "cornell_box.inverse"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_precision_control_fails(cell):
    ov, cov = small(cell)
    numbers, limits = control.readings(cell, 2 ** 31 + 9, "cpu", ov, cov)
    assert any(v > limits[k] for k, v in numbers.items()), numbers


def _scaled_pass(scale_color=1.0, half=False, empty=False):
    """A render_pass_pixels that breaks its pass: the color altered, half of
    the samples left out with the mean over the rest, or nothing added."""
    from phosphorus_mk2_tpu_torch.integrator import path

    real = path.render_pass_pixels

    def broken(scene, cam, seed, offset, n, px, py, **kw):
        m = max(1, n // 2) if half else n
        out = real(scene, cam, seed, offset, m, px, py, **kw)
        if empty:
            return {k: torch.zeros_like(v) for k, v in out.items()}
        f = n / m
        return {k: v * (scale_color * f if k == "color" else f) for k, v in out.items()}

    return broken


RENDER_FAULTS = {
    "unchanged": dict(empty=True),
    "half_left_out": dict(half=True),
    "altered": dict(scale_color=1.0 + 1e-3),
}


@pytest.mark.parametrize("cell", ["cornell_box.render"])
@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
def test_a_broken_render_is_not_correct(monkeypatch, cell, fault):
    from phosphorus_mk2_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "render_pass_pixels", _scaled_pass(**RENDER_FAULTS[fault]))
    assert not run_small(cell)["correct"]


def _later(real, broken, after):
    """``broken`` in place of ``real`` from its (after + 1)-th call on."""
    calls = [0]

    def f(*args, **kwargs):
        calls[0] += 1
        return (broken if calls[0] > after else real)(*args, **kwargs)

    return f


def _inverse_fault(monkeypatch, fault, after=0):
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer
    from phosphorus_mk2_tpu_torch.parallel import sharding

    if fault == "unchanged":
        real = torch.optim.Adam.step
        monkeypatch.setattr(torch.optim.Adam, "step",
                            _later(real, lambda self, closure=None: None, after))
    elif fault == "half_left_out":
        real = InverseRenderer._errors

        def half(self, sd, cam, key, n, tgts):
            errs = real(self, sd, cam, key, n, tgts)
            return [e[: e.shape[0] // 2] * 2.0 ** 0.5 for e in errs]

        monkeypatch.setattr(InverseRenderer, "_errors", _later(real, half, after))
    else:
        real = sharding.render_pass_pixels
        monkeypatch.setattr(sharding, "render_pass_pixels",
                            _later(real, _scaled_pass(scale_color=1.0 + 1e-3), after))


@pytest.mark.parametrize("cell", ["cornell_box.inverse"])
@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    _inverse_fault(monkeypatch, fault)
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_a_step_broken_after_the_checked_steps_is_not_correct(monkeypatch, fault):
    """A session that steps soundly through the first steps and then breaks
    (a cache or a captured graph that goes wrong in the window) fails."""
    from entries.inverse import CHECKED_STEPS

    _inverse_fault(monkeypatch, fault, after=CHECKED_STEPS)
    assert not run_small("cornell_box.inverse")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_precision_control_fails_at_the_cells_size(card, cell):
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        numbers, limits = control.readings(cell, seed, "cuda")
        print("control", cell, seed, numbers, flush=True)
        assert any(v > limits[k] for k, v in numbers.items()), (seed, numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["cornell_box.inverse"])
@pytest.mark.parametrize("fault", ["half_left_out", "altered"])
def test_a_broken_step_is_not_correct_at_the_cells_size(card, monkeypatch, cell, fault):
    import run

    _inverse_fault(monkeypatch, fault)
    for seed in (2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203):
        args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "1"])
        res = run.execute(args)
        print("fault", cell, fault, seed, res["checked"], flush=True)
        assert not res["correct"]

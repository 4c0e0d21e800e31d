"""The cell ``multi_bsdf.inverse``: on the CPU at tiny sizes, the cell run
end to end through ``run.execute`` (untraced and traced), the precision
control and each fault of a broken step failing ``correct`` (the sheen lobe
evaluated and sampled as a diffuse one in the eager lobe tables, which
autograd's calls take; a step without Adam; half the frame out of the loss;
the color altered by 1e-3), the cell's files, and every metric listed for
the cell read by a reader. The ``card`` tests run the faults and the
control at the cell's own size and print the compared numbers that set its
limits."""
import json
import os

import pytest
import torch

import run
from entries import inverse_lobes
from harness import common, data
from harness.profile import Trace
from test_benchmark_correctness import _later, _scaled_pass
from test_benchmark_multi_bsdf import _sheen_as_diffuse

CELL = "multi_bsdf.inverse"
SEED = 2 ** 31 + 4329
NEW = ("optim.saved_mb_per_step.grad", "bsdf.eager_ms_per_step.grad",
       "tracer.host_ms_per_step.grad")
FAULTS = ("sheen_as_diffuse", "unchanged", "half_left_out", "altered")


def small(**extra):
    """A 40x32 frame at 2 spp, the reference in blocks of 640 pixels."""
    spec = data.workload(CELL)
    ov = {"width": 40, "height": 32, "spp": 2, "check": {**spec["check"], "block": 640}}
    ov.update(extra)
    return ov


def run_small(trace=0, seconds=1.0, seed=SEED, **extra):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, device="cpu", overrides=small(**extra))


def _fault(monkeypatch, fault, after=0):
    """Break the session's steps from the (after + 1)-th on (the sheen lobe:
    from the start)."""
    from phosphorus_mk2_tpu_torch.optim import InverseRenderer
    from phosphorus_mk2_tpu_torch.parallel import sharding

    if fault == "sheen_as_diffuse":
        _sheen_as_diffuse(monkeypatch)
    elif fault == "unchanged":
        real = torch.optim.Adam.step
        monkeypatch.setattr(torch.optim.Adam, "step",
                            _later(real, lambda self, closure=None: None, after))
    elif fault == "half_left_out":
        real = InverseRenderer._errors

        def half(self, *args, **kwargs):
            errs = real(self, *args, **kwargs)
            return [e[: e.shape[0] // 2] * 2.0 ** 0.5 for e in errs]

        monkeypatch.setattr(InverseRenderer, "_errors", _later(real, half, after))
    else:
        real = sharding.render_pass_pixels
        monkeypatch.setattr(sharding, "render_pass_pixels",
                            _later(real, _scaled_pass(scale_color=1.0 + 1e-3), after))


def test_the_cells_files_parse_and_every_metric_has_a_reader():
    spec = data.spec()
    cell, = [w for w in spec["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    with open(os.path.join(data.BENCH, "workloads", CELL + ".json")) as f:
        traffic = json.load(f)
    assert (traffic["width"], traffic["height"], traffic["spp"], traffic["max_depth"]) == (
        512, 512, 4, 3)
    chk = traffic["check"]
    assert chk["steps_start"] >= 1 and chk["steps_after"] >= 1
    assert set(chk["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    names = [m["name"] for m in data.metrics_of(CELL, "per_layer")]
    assert set(NEW) <= set(names)
    for name in names:
        assert callable(common.reader(name).read), name
    assert {m["name"] for m in data.metrics_of(CELL, "end_to_end")} == {"grad_step_s", "setup_s"}


def test_the_configuration_holds_the_render_cells_scene():
    scene = data.config("multi_bsdf")
    cfg = data.config(data.workload(CELL)["config"])
    for key in ("scene", "scale", "triangles", "materials", "background"):
        assert cfg[key] == scene[key], key
    assert cfg["trainable"] == list(inverse_lobes.TRAINABLE)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_end_to_end(trace):
    res = run_small(trace=trace)
    assert res["correct"], res["checked"]
    if trace:
        got = res["metrics"]
        for name in NEW:
            assert got[name]["value"] > 0, name
        saved = res["info"]["saved"]
        assert saved["scopes"] >= data.workload(CELL)["trace_steps"] and saved["bytes"] > 0
    else:
        assert set(res["metrics"]) == {"grad_step_s", "setup_s"}
        assert res["info"]["check_s"] > 0 and res["info"]["frame"] == [40, 32]


def test_the_precision_control_fails():
    cell = data.workload(CELL)
    cell.update(small())
    ctx = {"cell": cell, "config": data.config(cell["config"]), "seed": SEED,
           "device": torch.device("cpu")}
    numbers = inverse_lobes.control_readings(ctx)
    limits = cell["check"]["limits"]
    assert any(v > limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault)
    res = run_small()
    assert not res["correct"], res["checked"]


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_a_step_broken_after_the_checked_steps_is_not_correct(monkeypatch, fault):
    _fault(monkeypatch, fault, after=data.workload(CELL)["check"]["steps_start"])
    assert not run_small()["correct"]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_spans_and_counters_reads_nothing(monkeypatch, name):
    from phosphorus_mk2_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "RECORDER", None)
    tr = Trace()
    tr.window = (0, 1000)
    assert common.reader(name).read({"trace": tr, "steps": 2}) is None


@pytest.mark.card
def test_the_precision_control_fails_at_the_cells_size(card):
    cell = data.workload(CELL)
    fails = []
    for seed in (2 ** 31 + 601, 2 ** 31 + 602):
        ctx = {"cell": cell, "config": data.config(cell["config"]), "seed": seed, "device": card}
        numbers = inverse_lobes.control_readings(ctx)
        print("control", CELL, seed, numbers, flush=True)
        fails.append(any(v > cell["check"]["limits"][k] for k, v in numbers.items()))
    assert all(fails)


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct_at_the_cells_size(card, monkeypatch, fault):
    _fault(monkeypatch, fault)
    correct = []
    for seed in (2 ** 31 + 701, 2 ** 31 + 702):
        args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "1"])
        res = run.execute(args)
        print("fault", CELL, fault, seed, res["checked"], res["info"], flush=True)
        correct.append(res["correct"])
    assert not any(correct)

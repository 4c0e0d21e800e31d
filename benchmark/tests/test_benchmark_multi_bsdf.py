"""The cell ``multi_bsdf.render``: on the CPU at tiny sizes, the cell run
end to end through ``run.execute``, the precision control and each fault of
a broken pass failing ``correct`` (the sheen lobe evaluated and sampled as
a diffuse one among them), and every per-layer metric of the cell read as a
number from a traced run (the device ones from its counters beside
synthetic kernel records, as the CPU has no device trace). The ``card``
tests run the same at the cell's own size and print the compared numbers
that set its limit."""
import pytest
import torch

import run
from entries import render_lobes
from harness import common, data
from harness.profile import Trace
from test_benchmark_correctness import RENDER_FAULTS, _scaled_pass

CELL = "multi_bsdf.render"
NEW = ("tracer.syncs_per_trace.render", "tracer.host_ms_per_trace.render",
       "cluster_kernels.busy_ms_per_trace.render", "wave_mt.roofline_pct.render",
       "bsdf.sorted_dispatch_ms_per_spp.render")
SEED = 2 ** 31 + 4321


def small(**extra):
    """A 64x64 frame in two chunks of 2,048 pixels (each wide enough for the
    sorted dispatch's lobe evaluations), 2 spp a pass, depth 3, every pixel
    checked."""
    spec = data.workload(CELL)
    ov = {"width": 64, "height": 64, "spp": 4, "samples_per_pass": 2, "path_depth": 3,
          "max_wavefront": 2048, "control_samples": 2,
          "check": {**spec["check"], "pixels": 64 * 64}}
    ov.update(extra)
    return ov


def run_small(trace=0, seconds=3.0, seed=SEED, device="cpu", **extra):
    args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, device=device, overrides=small(**extra))


def _sheen_as_diffuse(monkeypatch):
    from phosphorus_mk2_tpu_torch.bsdf import lobes
    from phosphorus_mk2_tpu_torch.core.material import SHEEN

    monkeypatch.setitem(lobes.EVALS, SHEEN, lobes._eval_diffuse)
    monkeypatch.setitem(lobes.SAMPLERS, SHEEN, lobes._sample_diffuse)


def _break(monkeypatch, fault):
    from phosphorus_mk2_tpu_torch.parallel import sharding

    if fault == "sheen_as_diffuse":
        _sheen_as_diffuse(monkeypatch)
    else:
        monkeypatch.setattr(sharding, "render_pass_pixels", _scaled_pass(**RENDER_FAULTS[fault]))


FAULTS = sorted(RENDER_FAULTS) + ["sheen_as_diffuse"]


def test_the_cell_runs_end_to_end():
    res = run_small()
    assert res["correct"], res["checked"]
    assert set(res["metrics"]) == {m["name"] for m in data.metrics_of(CELL, "end_to_end")}
    assert set(res["metrics"]) == {"render_samples_per_s", "setup_s"}
    assert res["info"]["pixels_checked"] == 64 * 64 and res["info"]["check_s"] > 0


def test_the_precision_control_fails():
    cell = data.workload(CELL)
    cell.update(small())
    ctx = {"cell": cell, "config": data.config(cell["config"]), "seed": SEED,
           "device": torch.device("cpu")}
    numbers = render_lobes.control_readings(ctx)
    assert numbers["bad_pixel_share"] > cell["check"]["limits"]["bad_pixel_share"], numbers


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_render_is_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    res = run_small()
    assert not res["correct"], res["checked"]


def test_every_new_metric_reads_a_number_from_a_traced_run():
    res = run_small(trace=1)
    assert res["correct"], res["checked"]
    got = res["metrics"]
    for name in ("tracer.syncs_per_trace.render", "tracer.host_ms_per_trace.render",
                 "bsdf.sorted_dispatch_ms_per_spp.render", "renderer.chunks_per_pass.render"):
        assert got[name]["value"] > 0, name
    assert got["renderer.chunks_per_pass.render"]["value"] == 2.0
    info = res["info"]
    stats, work = info["tracer_stats"], info["wave_work"]
    assert got["tracer.syncs_per_trace.render"]["value"] == stats["syncs"] / stats["traces"]
    # the device readers on kernel records named as the card's, 1 ms each
    tr = Trace()
    tr.window = (0, 10 ** 9)
    tr.device = [("void wave_mt_kernel<float>(...)", 0, 10 ** 6),
                 ("void wave_sweep_staged_kernel<float>(...)", 2 * 10 ** 6, 3 * 10 ** 6),
                 ("void front_kernel<true>(...)", 4 * 10 ** 6, 5 * 10 ** 6),
                 ("void at::native::elementwise_kernel(...)", 0, 10 ** 6)]
    ctx = {"trace": tr, "tracer_stats": stats, "wave_work": work}
    busy = common.reader("cluster_kernels.busy_ms_per_trace.render").read(ctx)
    assert busy == pytest.approx(3.0 / stats["traces"])
    roof = common.reader("wave_mt.roofline_pct.render")
    (pairs, rays, winners, rows), = work.values()
    moved = 28 * pairs + 8 * rays + 12 * winners + 4608 * rows
    assert roof.read(ctx) == pytest.approx(100.0 * moved / 3.35e12 / 1e-3)
    assert roof.wave_mt_bytes("wave_mt_bf16", 0, 0, 0, 1) == 2304


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_counters_reads_nothing(name):
    tr = Trace()
    tr.window = (0, 1000)
    tr.device = [("void wave_mt_kernel<float>(...)", 0, 100)]
    ctx = {"trace": tr, "tracer_stats": None, "wave_work": None, "spp": 4, "passes": 1}
    assert common.reader(name).read(ctx) is None


@pytest.mark.card
def test_every_metric_reads_a_number_on_the_card(card):
    res = run_small(trace=1, device="cuda")
    print("traced tiny run", res["correct"], res["metrics"], flush=True)
    assert res["correct"], res["checked"]
    names = {m["name"] for m in data.metrics_of(CELL, "per_layer")}
    assert set(res["metrics"]) == names
    for name in names:
        value = res["metrics"][name]["value"]
        assert value == value and value >= 0, name
        if res["metrics"][name]["unit"] == "%":
            assert 0.0 < value <= 100.0, (name, value)


@pytest.mark.card
def test_the_precision_control_fails_at_the_cells_size(card):
    cell = data.workload(CELL)
    for seed in (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303):
        ctx = {"cell": cell, "config": data.config(cell["config"]), "seed": seed, "device": card}
        numbers = render_lobes.control_readings(ctx)
        print("control", CELL, seed, numbers, flush=True)
        assert numbers["bad_pixel_share"] > cell["check"]["limits"]["bad_pixel_share"]


@pytest.mark.card
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_render_is_not_correct_at_the_cells_size(card, monkeypatch, fault):
    _break(monkeypatch, fault)
    for seed in (2 ** 31 + 401, 2 ** 31 + 402, 2 ** 31 + 403):
        # a window longer than a pass (5-7 s): the render is cancelled only between chunks
        args = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "10"])
        res = run.execute(args)
        print("fault", CELL, fault, seed, res["checked"], res["films_checked"], flush=True)
        assert not res["correct"]

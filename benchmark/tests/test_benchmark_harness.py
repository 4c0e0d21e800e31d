"""The harness on the CPU: BENCHMARK.json against the contract, every file
found by name, the metric arithmetic on synthetic inputs, tiny dry runs of
both entries, the command's refusal without a card, the modules a run
loads, and the frozen scene copies against the program's scene functions."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from harness import check, common, data
from harness.profile import WINDOW, Trace

BENCH = data.BENCH
ROOT = data.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small(cell: str, **extra):
    """Cell and configuration overrides of a tiny CPU run."""
    spec = data.workload(cell)
    ov = {"width": 16, "height": 16}
    if spec["entry"] == "render":
        ov.update(spp=8, path_depth=min(spec["path_depth"], 3),
                  check={**spec["check"], "pixels": 64})
    ov.update(extra)
    return ov, {}


def run_small(cell, trace=0, seconds=1.0, seed=2 ** 31 + 5, **extra):
    import run

    ov, cov = small(cell, **extra)
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, device="cpu", overrides=ov, config_overrides=cov)


def test_benchmark_json_keeps_the_contract():
    spec = data.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1].startswith("benchmark/")
    assert 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for m in spec[group]:
            assert NAME.match(m["name"]) and m["name"] not in names, m["name"]
            names.add(m["name"])
            if "unit" in m:
                assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"]: w for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"], (
                m["name"], c)
    for c in cells:
        reported = [m for m in spec["end_to_end"] if "workloads" not in m
                    or c in m["workloads"]]
        assert len(reported) >= 2 and any(c in m["workloads"] for m in spec["per_layer"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_part_is_found_by_its_name():
    spec = data.spec()
    for c in spec["configs"]:
        cfg = data.config(c["name"])
        assert c["file"].startswith("benchmark/") and cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH, "scenes", cfg["scene"] + ".py"))
    for w in spec["workloads"]:
        cell = data.workload(w["name"])
        assert os.path.exists(os.path.join(BENCH, "entries", cell["entry"] + ".py"))
        assert set(cell["check"]["limits"])
    for m in spec["per_layer"]:
        assert callable(common.reader(m["name"]).read)


def _trace(events, window=(0, 100)):
    tr = Trace()
    tr.device = sorted(events, key=lambda e: e[1])
    tr.window = window
    tr.host = [(WINDOW, *window), ("aten::mul", 40, 60), ("chunk", 30, 90)]
    return tr


def test_the_union_of_overlapping_intervals():
    tr = _trace([("a", 10, 30), ("b", 20, 40), ("c", 50, 55), ("d", 95, 120)])
    assert tr.busy_intervals() == [[10, 40], [50, 55], [95, 100]]
    assert tr.busy_s() == pytest.approx(40e-9)
    assert tr.kernel_count() == 4
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::mul"] == pytest.approx(10e-9)       # 40-50, inside the inner span
    assert sum(gaps.values()) == pytest.approx(60e-9)       # all idle time, named
    ops = dict(tr.breakdown()["device_ops"])
    assert ops["d"] == pytest.approx(25e-9)


def test_the_95th_percentile_of_a_known_list():
    assert common.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert common.p95([7.0] * 3) == 7.0


def test_the_roofline_share():
    tr = _trace([("void mt_closest_kernel<64>(...)", 0, 1000),
                 ("mt_closest_finish_kernel(...)", 1000, 2000), ("other", 0, 50)],
                window=(0, 3000))
    ctx = {"trace": tr, "mt_calls": [(65536, 36), (65536, 36)]}
    ops = 2 * 65536 * 36 * 46
    want = 100.0 * ops / 67e12 / 2e-6
    assert common.reader("mt_closest.roofline_pct.render").read(ctx) == pytest.approx(want)
    assert common.reader("mt_closest.roofline_pct.render").read({"trace": tr, "mt_calls": []}) is None


def test_readers_that_find_nothing_return_nothing():
    tr = _trace([])
    ctx = {"trace": tr, "passes": 1, "spp": 4, "mt_calls": [(64, 36)]}
    assert common.reader("backward.index_pct.grad").read(ctx) is None
    assert common.reader("mt_closest.roofline_pct.render").read(ctx) is None


def test_the_compared_numbers():
    ref = {"color": np.ones((4, 3)), "normal": np.zeros((4, 3)), "alpha": np.ones(4)}
    prog = {k: v.copy() for k, v in ref.items()}
    prog["color"][1, 2] *= 1.001
    assert check.film_numbers(prog, ref, 1e-4, 1e-6)["bad_pixel_share"] == 0.25
    steps = {"losses": [1.0, 2.0], "grad": {"a": np.ones(4), "b": np.ones(9)},
             "change": {"a": np.ones(4), "b": np.ones(9)}}
    off = {**steps, "losses": [1.0, 2.2]}
    got = check.step_numbers(off, steps)
    assert got["loss_gap"] == pytest.approx(0.1) and got["grad_gap"] == 0.0
    ok, rows = check.judge({"x": float("nan")}, {"x": 1.0})
    assert not ok and rows == [["x", rows[0][1], 1.0]]


def test_cancel_leaves_only_whole_passes():
    res = run_small("cornell_box.render", seconds=0.05, spp=64)
    info = res["info"]
    assert res["correct"] and info["passes"] == res["attempted"] >= 1
    per_pass = data.workload("cornell_box.render")["samples_per_pass"]
    rate = res["metrics"]["render_samples_per_s"]["value"]
    assert rate * info["window_s"] == pytest.approx(16 * 16 * per_pass * info["passes"])


@pytest.mark.parametrize("cell", ["cornell_box.render", "cornell_box.inverse"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_of_each_cell_is_correct(cell, trace):
    res = run_small(cell, trace=trace)
    assert res["correct"], res["checked"]
    if trace:
        names = {m["name"] for m in data.metrics_of(cell, "per_layer")}
        assert "setup.session_s" in names
    else:
        assert set(res["metrics"]) == {m["name"] for m in data.metrics_of(cell, "end_to_end")}


def _modules_after(imports: str) -> set:
    code = (f"import sys; sys.path[:0] = {[BENCH, ROOT]!r}; {imports}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules_after("import run, entries.render, entries.inverse, control, "
                          "reference.integrator, reference.inverse")
    assert not mods & set(common.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("import reference.integrator, reference.inverse, reference.trace")
    assert not mods & {"jax", "jaxlib", "flax", "phosphorus_mk2_tpu", "phosphorus_mk2_tpu_torch"}


def test_the_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "cornell_box.render", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_frozen_scenes_are_the_programs():
    from phosphorus_mk2_tpu_torch.scenes import cornell_box
    from scenes import cornell_box as frozen_box

    sc = cornell_box(32, 24)
    fz = frozen_box.build(32, 24)
    assert len(sc.meshes) == len(fz["meshes"])
    for m, f in zip(sc.meshes, fz["meshes"]):
        assert np.array_equal(m.vertices, f["vertices"]) and np.array_equal(m.faces, f["faces"])
    assert np.array_equal(sc.camera.to_world, fz["camera"]["to_world"])

"""The port's bench (phosphorus_mk2_tpu_torch/bench.py) on the CPU at tiny
sizes: each metric function gives one line under the repo's bench.py
metric name, with bench.py's keys (read from its source), its ray count
and finite values; ``main()`` exits non-zero without a card and after
any failed metric.

Tolerances: none. The lines' counts are exact; rates are only checked
finite and positive (CPU rates at toy sizes measure nothing of the
card).
"""
import ast
import json
import math
from pathlib import Path

import pytest
import torch

from phosphorus_mk2_tpu_torch import bench

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# bench.py's key renamed by the port: the null-scan floor of the TPU
# became the host floor of one trivial launch
RENAMED = {"launch_floor_ms_per_scan_iter": "launch_floor_ms_per_launch"}


def _bench_py_keys() -> dict:
    """{metric name: the keys of bench.py's line for it}, from its source:
    every dict literal with a constant "metric" (error lines left out),
    bmw_live's decomposition dict added to its line."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys, decomp = {}, set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Dict):
            continue
        names = [k.value for k in node.keys if isinstance(k, ast.Constant)]
        if "front_table_ms" in names:
            decomp = set(names)
        if "metric" not in names or "error" in names:
            continue
        metric = node.values[names.index("metric")]
        if isinstance(metric, ast.Constant):
            keys[metric.value] = {RENAMED.get(n, n) for n in names}
    keys["bmw_live_fwd_rays_per_sec"] |= decomp
    return keys


BENCH_PY = _bench_py_keys()


@pytest.fixture(scope="module")
def bmw():
    return bench.load_bmw("cpu", res=32, scale=0.02)


def _check(line, metric, rays):
    assert line["metric"] == metric
    assert BENCH_PY[metric] <= set(line), BENCH_PY[metric] - set(line)
    assert line["rays"] == rays and line["unit"] == "rays/s"
    assert line["device"] == "cpu"
    assert "error" not in line
    assert line["value"] > 0 and line["vs_baseline"] > 0
    for k, v in line.items():
        if isinstance(v, float):
            assert math.isfinite(v), k
    json.dumps(line)


def test_bench_py_names_six_metrics():
    assert set(BENCH_PY) == {
        "cornell_fwd_bwd_rays_per_sec", "cornell_bvh_renderer_fwd_rays_per_sec",
        "bmw_live_fwd_rays_per_sec", "bmw_fwd_rays_per_sec", "bmw_fwd_bwd_rays_per_sec",
        "bmw_fwd_bwd_scoped_emlw_rays_per_sec"}


def test_cornell_fwd_bwd():
    line = bench.cornell_fwd_bwd("cpu", width=8, height=8, spp=2, depth=2, cpu_spp=1,
                                 copy_bytes=1 << 16, reps=1)
    _check(line, "cornell_fwd_bwd_rays_per_sec", 8 * 8 * 2 * 2 * 2)
    assert line["launch_floor_ms_per_launch"] > 0 and line["hbm_roofline_rays_per_sec"] > 0
    assert line["fwd_rays_per_sec"] > 0 and line["scoped_emlw_rays_per_sec"] > 0
    assert line["mean"] > 0 and line["cpu_spp"] == 1


def test_cornell_bvh_renderer_fwd():
    line = bench.cornell_bvh_renderer_fwd("cpu", width=8, height=8, spp=2, depth=2, cpu_spp=1,
                                          reps=1)
    _check(line, "cornell_bvh_renderer_fwd_rays_per_sec", 8 * 8 * 2 * 2 * 2)
    assert line["mean"] > 0


def test_bmw_live(bmw):
    line = bench.bmw_live("cpu", n_rays=1024, cpu_rays=64, gather_rows=32, reps=1, bmw=bmw)
    _check(line, "bmw_live_fwd_rays_per_sec", 1024)  # the whole 32x32 frame
    assert line["cpu_rays"] == 64 and 0 < line["hits"] <= 1024
    assert line["front_table_ms"] > 0 and line["wave_loop_gather_gb"] > 0
    assert line["tris"] == bmw[1].num_tris > 1024


def test_bmw_fwd(bmw):
    line = bench.bmw_fwd("cpu", spp=1, depth=2, cpu_pixels=32, reps=1, bmw=bmw)
    _check(line, "bmw_fwd_rays_per_sec", 32 * 32 * 1 * 2 * 2)
    assert line["cpu_pixels"] == 32 and line["mean"] > 0 and line["res"] == 32


@pytest.mark.parametrize("fn, metric", [
    (bench.bmw_fwd_bwd, "bmw_fwd_bwd_rays_per_sec"),
    (bench.bmw_fwd_bwd_scoped, "bmw_fwd_bwd_scoped_emlw_rays_per_sec"),
])
def test_bmw_gradient_steps(bmw, fn, metric):
    line = fn("cpu", n=128, spp=1, depth=2, cpu_pixels=16, reps=1, bmw=bmw)
    _check(line, metric, 128 * 1 * 2 * 2)
    assert line["grads_finite"] is True and line["cpu_pixels"] == 16
    assert line["wavefront"] == 128


def test_cut_spreads_its_indices():
    assert bench._cut(10, 3).tolist() == [0, 3, 6]
    assert bench._cut(4, 8).tolist() == [0, 1, 2, 3]


def test_main_without_a_card_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() measures it")
    assert bench.main([]) != 0
    assert bench.main(["--bmw"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def _fake_card(monkeypatch, fail=()):
    """main() as on a card, every metric replaced by a stub (one that
    raises for the names in ``fail``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(bench, "load_bmw", lambda dev: ("scene", "data"))

    def stub(metric):
        def fn(*args, **kw):
            if metric in fail:
                raise RuntimeError(f"{metric} broke")
            return {"metric": metric, "value": 1.0}
        return fn

    for name, metric in [("cornell_fwd_bwd", "cornell_fwd_bwd_rays_per_sec"),
                         ("cornell_bvh_renderer_fwd", "cornell_bvh_renderer_fwd_rays_per_sec"),
                         ("bmw_live", "bmw_live_fwd_rays_per_sec"),
                         ("bmw_fwd", "bmw_fwd_rays_per_sec"),
                         ("bmw_fwd_bwd", "bmw_fwd_bwd_rays_per_sec"),
                         ("bmw_fwd_bwd_scoped", "bmw_fwd_bwd_scoped_emlw_rays_per_sec")]:
        monkeypatch.setattr(bench, name, stub(metric))


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_main_prints_every_line_in_order(monkeypatch, capsys):
    _fake_card(monkeypatch)
    assert bench.main(["--bmw"]) == 0
    assert [ln["metric"] for ln in _lines(capsys)] == [
        "cornell_fwd_bwd_rays_per_sec", "cornell_bvh_renderer_fwd_rays_per_sec",
        "bmw_live_fwd_rays_per_sec", "bmw_fwd_rays_per_sec", "bmw_fwd_bwd_rays_per_sec",
        "bmw_fwd_bwd_scoped_emlw_rays_per_sec"]
    assert bench.main([]) == 0
    assert len(_lines(capsys)) == 3


def test_a_failed_metric_prints_its_error_and_fails_the_run(monkeypatch, capsys):
    _fake_card(monkeypatch, fail=("bmw_live_fwd_rays_per_sec",))
    assert bench.main(["--bmw"]) == 1
    lines = _lines(capsys)
    assert len(lines) == 6
    bad = [ln for ln in lines if "error" in ln]
    assert [ln["metric"] for ln in bad] == ["bmw_live_fwd_rays_per_sec"]
    assert "broke" in bad[0]["error"]

"""The cluster tracer's and the lobe container's spans and wave_mt's
work counters (accel/cluster_traverse.py, bsdf/bsdf.py, accel/wave.py)
on the CPU: where the spans nest in a render's bounce, the shared no-op
and no counting without a torch.profiler session, films bit-equal with
tracing on and off, and ``wave.WORK`` equal to a plain count of the
live pairs, rays, winners and distinct rows of every wave."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phosphorus_mk2_tpu_torch.accel import cluster_traverse, wave
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.bsdf import bsdf
from phosphorus_mk2_tpu_torch.core.material import DIFFUSE, SHEEN
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.renderer import Renderer
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene
from phosphorus_mk2_tpu_torch.utils import profiling

TRACER = {"tracer.front", "tracer.waves", "tracer.fallback"}


@pytest.fixture(autouse=True)
def empty_stores():
    profiling.RECORDER.clear()
    wave.WORK.clear()
    yield
    profiling.RECORDER.clear()
    wave.WORK.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def film(res=64, depth=2):
    """A multi_bsdf render through the cluster tracer, its container calls
    on the eager route (the CPU's)."""
    r = Renderer(multi_bsdf_scene(res, res),
                 Options(samples_per_pixel=1, path_depth=depth, mis=True, seed=7), device="cpu")
    out = r.render()
    return [out[k] for k in ("color", "normal", "alpha")]


def rays(n=512, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = (torch.rand((n, 3), generator=g) - 0.5) * 1.6
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return p, d


def test_the_spans_nest_in_a_bounce():
    with cpu_profile():
        film()
    spans = list(profiling.RECORDER.spans)
    by = {s.index: s for s in spans}
    traces = [s for s in spans if s.name == "tracer.trace"]
    assert traces and {by[s.parent].name for s in traces} == {"integrator.trace",
                                                             "integrator.shadow"}
    assert {s.args["kind"] for s in traces} == {"closest", "any_hit"}
    assert all(s.args["rays"] == 64 * 64 for s in traces)
    stages = [s for s in spans if s.name in TRACER]
    assert {s.name for s in stages} == TRACER
    for s in stages:
        top = by[s.parent]
        assert top.name == "tracer.trace" and top.start <= s.start and s.end <= top.end
    for t in traces:  # the three stages in order, once each
        kids = sorted((s for s in stages if s.parent == t.index), key=lambda s: s.start)
        assert [s.name for s in kids] == ["tracer.front", "tracer.waves", "tracer.fallback"]
    # the container calls inside the bounce's stages
    calls = [s for s in spans if s.name == "bsdf.eager"]
    assert calls and not [s for s in spans if s.name == "bsdf.kernel"]
    parents = {by[s.parent].name for s in calls}
    assert "integrator.bsdf_sample" in parents
    assert parents <= {"integrator.bsdf_sample", "integrator.nee"}


def test_without_a_profiler_the_spans_are_no_ops_and_nothing_is_counted(monkeypatch):
    data = attach_bvh(multi_bsdf_scene(8, 8).build(device="cpu"))
    p, d = rays()
    profiling.RECORDER.clear()  # the set-up spans, always kept

    def no_clock():
        raise AssertionError("a span that is not kept read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert not profiling.tracing()
    for name in ("tracer.trace", "tracer.waves", "bsdf.eager"):
        assert profiling.span(name) is profiling.NO_SPAN
    cluster_traverse.intersect_clusters(data, p, d)
    cluster_traverse.occluded_clusters(data, p, d, torch.full((p.shape[0],), 0.5))
    lob = {"type": torch.tensor([[DIFFUSE, SHEEN]] * 64), "param": torch.full((64, 2, 6), 0.5),
           "weight": torch.ones(64, 2, 3), "flags": torch.full((64, 2), 8),
           "n": torch.full((64,), 2), "present": (DIFFUSE, SHEEN), "max_lobes": 2}
    bsdf.bsdf_f(lob, d[:64], d[64:128], d[128:192])
    assert len(profiling.RECORDER.spans) == 0 and wave.WORK == {}


@pytest.mark.parametrize("depth", [2, 9])
def test_films_are_bit_equal_with_tracing_on_and_off(depth):
    off = film(32, depth)
    with cpu_profile():
        on = film(32, depth)
    assert wave.WORK  # the counters ran
    for a, b in zip(on, off):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("tune", [{}, {"dense_k": 1}, {"recompact": 0}])
def test_the_work_counters_equal_a_plain_count(monkeypatch, tune):
    data = attach_bvh(multi_bsdf_scene(8, 8).build(device="cpu"))
    p, d = rays(700)
    real = wave.wave_mt_plain
    want = np.zeros(4, np.int64)

    def counted(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, **kw):
        bt, bc = best_t.numpy().copy(), best_c.numpy().copy()
        ct, cc = col_t.numpy(), col_c.numpy()
        live = (ct < bt[:, None]) & (ct < 3.0e38)
        if any_hit:
            live &= (bc < 0)[:, None]
        real(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, **kw)
        want[:] += [live.sum(), ct.shape[0], (best_t.numpy() < bt).sum(),
                    np.unique(cc[live]).size]

    monkeypatch.setattr(wave, "wave_mt_plain", counted)
    with cpu_profile():
        cluster_traverse.intersect_clusters(data, p, d, **tune)
        cluster_traverse.occluded_clusters(data, p, d, torch.full((p.shape[0],), 0.7), **tune)
    (key,) = wave.WORK
    assert key == ("wave_mt", "cpu") and wave.WORK_FIELDS == ("pairs", "rays", "winners", "rows")
    got = wave.WORK[key].numpy()
    assert got.tolist() == want.tolist() and (got > 0).all()
    assert profiling.RECORDER.read()["counters"]["accel.wave.WORK"] is wave.WORK

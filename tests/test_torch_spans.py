"""The port's spans and counters (utils/profiling.py) on the CPU: which
spans are kept with tracing off and on, the parent and root of each, a
span closed by an exception, the bounded store, the clock shared with
torch.profiler's events, the Chrome trace of trace(), the spans a
Renderer pass and an InverseRenderer step emit, the library loads, the
counters' read-out, and films and losses bit-equal with tracing on and
off. Nothing here compares times: only names, links, containment and
equality."""
import json
import shutil
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from phosphorus_mk2_tpu_torch.accel import block_traverse, build, cluster_traverse, front, mt
from phosphorus_mk2_tpu_torch.accel import traverse, wave
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.optim import InverseRenderer
from phosphorus_mk2_tpu_torch.renderer import Renderer
from phosphorus_mk2_tpu_torch.scenes import cornell_box
from phosphorus_mk2_tpu_torch.utils import profiling

torch.set_num_threads(1)

RES = 8
STAGES = {"integrator.trace", "integrator.hit_rows", "integrator.emission", "integrator.nee",
          "integrator.shadow", "integrator.bsdf_sample"}
# the lobe container's calls, on their CPU route (bsdf/bsdf.py)
BSDF = {"bsdf.eager"}
PASS = {"renderer.pass", "renderer.chunk", "renderer.film_gather", "integrator.tables",
        "integrator.sample"} | STAGES | BSDF
STEP = {"optim.step", "optim.forward", "optim.backward", "optim.loss_readback",
        "optim.update", "integrator.tables", "integrator.sample"} | STAGES | BSDF


@pytest.fixture(autouse=True)
def empty_store():
    profiling.RECORDER.clear()
    yield
    profiling.RECORDER.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def names():
    return {s.name for s in profiling.RECORDER.spans}


def renderer():
    return Renderer(cornell_box(RES, RES),
                    Options(use_bvh=False, samples_per_pixel=4, samples_per_pass=2,
                            path_depth=2, mis=True, seed=3), device="cpu")


def inverse():
    target = np.random.default_rng(0).uniform(0.0, 1.0, (RES, RES, 3)).astype(np.float32)
    return InverseRenderer(cornell_box(RES, RES), target, spp=2, max_depth=2,
                           use_bvh=False, seed=5, device="cpu")


@pytest.mark.parametrize("name", ["renderer.pass", "integrator.trace", "optim.backward"])
def test_tracing_off_keeps_no_hot_path_span(name, monkeypatch):
    def no_clock():
        raise AssertionError("a span that is not kept read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert not profiling.tracing()
    sp = profiling.span(name)
    assert sp is profiling.NO_SPAN and profiling.stages() is profiling.NO_SPAN
    with sp:
        with profiling.stages() as stage:
            stage(name)
    assert len(profiling.RECORDER.spans) == 0


def test_a_profiler_session_turns_tracing_on():
    assert not profiling.tracing()
    with cpu_profile():
        assert profiling.tracing()
        with profiling.span("renderer.pass"):
            pass
    assert not profiling.tracing()
    with profiling.span("renderer.pass"):
        pass
    assert [s.name for s in profiling.RECORDER.spans] == ["renderer.pass"]


@pytest.mark.parametrize("traced", [False, True])
def test_setup_spans_are_kept_either_way(traced):
    with (cpu_profile() if traced else torch.no_grad()):
        with profiling.span("setup.kernels", {"lib": "x"}) as sp:
            pass
    assert isinstance(sp, profiling.Span) and sp.args == {"lib": "x"}
    assert [s.name for s in profiling.RECORDER.spans] == ["setup.kernels"]
    assert sp.start <= sp.end and sp.parent == -1 and sp.root == sp.index


def test_parents_and_roots_across_a_pass_chunk_sample_and_stage():
    with cpu_profile():
        with profiling.span("renderer.pass") as p:
            with profiling.span("renderer.chunk") as c:
                with profiling.span("integrator.sample") as s:
                    with profiling.stages() as stage:
                        stage("integrator.trace")
                        stage("integrator.hit_rows")
        with profiling.span("renderer.pass") as p2:
            pass
    kept = {sp.name: sp for sp in profiling.RECORDER.spans if sp.root == p.index}
    assert set(kept) == {"renderer.pass", "renderer.chunk", "integrator.sample",
                         "integrator.trace", "integrator.hit_rows"}
    assert (p.parent, c.parent, s.parent) == (-1, p.index, c.index)
    a, b = kept["integrator.trace"], kept["integrator.hit_rows"]
    assert a.parent == b.parent == s.index and a.end <= b.start
    assert p.start <= c.start <= s.start <= a.start and b.end <= s.end <= c.end <= p.end
    assert p2.root == p2.index != p.index and p2.parent == -1


@pytest.mark.parametrize("kind", ["span", "stage", "spanned", "stage_timer"])
def test_a_span_closes_on_an_exception(kind):
    @profiling.spanned("setup.session")
    def raising():
        raise ValueError

    with cpu_profile():
        with pytest.raises(ValueError):
            if kind == "span":
                with profiling.span("renderer.pass"):
                    raise ValueError
            elif kind == "stage":
                with profiling.stages() as stage:
                    stage("integrator.trace")
                    raise ValueError
            elif kind == "spanned":
                raising()
            else:
                with profiling.StageTimer().stage("write"):
                    raise ValueError
        with profiling.span("renderer.pass") as after:
            pass
    first = profiling.RECORDER.spans[0]
    assert first.end >= first.start > 0
    assert after.parent == -1  # nothing left open


def test_the_bounded_store_counts_what_it_drops(monkeypatch):
    small = profiling.Recorder(cap=3)
    monkeypatch.setattr(profiling, "RECORDER", small)
    for i in range(5):
        with profiling.span("setup.step", {"i": i}):
            pass
    got = small.read()
    assert [s.args["i"] for s in got["spans"]] == [2, 3, 4] and got["dropped"] == 2
    assert [s.index for s in got["spans"]] == [2, 3, 4]


def test_a_span_contains_its_operators_kineto_record():
    """Spans are stamped with time.time_ns(), the clock of the profiler's
    events: the record of an operator run inside a span lies inside it."""
    a = torch.ones(128, 128)
    with cpu_profile() as prof:
        with profiling.span("check.matmul") as sp:
            a.matmul(a)
    recs = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "aten::matmul"]
    assert recs
    for ev in recs:
        start = ev.start_ns()
        assert sp.start <= start and start + ev.duration_ns() <= sp.end


def test_trace_writes_the_programs_spans_into_its_chrome_trace(tmp_path):
    r = renderer()
    with profiling.trace(str(tmp_path)):
        next(r.passes())
    doc = json.loads(next(tmp_path.glob("*.json")).read_text())
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert {e["name"] for e in ours} == PASS
    (pass_ev,) = [e for e in ours if e["name"] == "renderer.pass"]
    lo, hi = pass_ev["ts"], pass_ev["ts"] + pass_ev["dur"]
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops and any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in ops)
    assert all(e["args"]["root"] == pass_ev["args"]["index"] for e in ours)


@pytest.mark.parametrize("session", ["render", "inverse"])
def test_a_pass_and_a_step_emit_exactly_the_listed_spans(session):
    s = renderer() if session == "render" else inverse()
    setup = {"setup.session", "setup.scene_build", "setup.tracer"}
    if session == "inverse":
        setup.add("setup.optimizer")
    assert names() == setup
    (root,) = [sp for sp in profiling.RECORDER.spans if sp.name == "setup.session"]
    assert all(sp.root == root.index for sp in profiling.RECORDER.spans)
    profiling.RECORDER.clear()
    with cpu_profile():
        if session == "render":
            next(s.passes())
        else:
            s.step()
    assert names() == (PASS if session == "render" else STEP)
    roots = {sp.root for sp in profiling.RECORDER.spans}
    (top,) = [sp for sp in profiling.RECORDER.spans if sp.parent == -1]
    assert roots == {top.index} and top.name in ("renderer.pass", "optim.step")


def test_attach_bvh_is_a_setup_span():
    attach_bvh(cornell_box(RES, RES).build(device="cpu"), builder="python")
    assert "setup.bvh" in names()


@pytest.mark.parametrize("session", ["render", "inverse"])
def test_films_and_losses_are_bit_equal_with_tracing_on_and_off(session):
    def run():
        if session == "render":
            film = renderer().render()
            return [film[k] for k in ("color", "normal", "alpha")]
        inv = inverse()
        losses = [inv.step() for _ in range(2)]
        return [np.asarray(losses)] + [p.detach().numpy() for p in inv.params.values()]

    off = run()
    with cpu_profile():
        on = run()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert np.array_equal(a, b)


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++ to build a library")
def test_a_library_load_is_a_setup_span_and_its_build_is_counted(tmp_path, monkeypatch):
    src = tmp_path / "seven.cpp"
    src.write_text('extern "C" int seven(void) { return 7; }\n')
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "libs")
    flags = ("-shared", "-fPIC")
    before = profiling.COUNTERS["kernels.builds"]
    lib, _ = build.load_shared(src, "g++", flags, "seven")
    assert lib.seven() == 7 and profiling.COUNTERS["kernels.builds"] == before + 1
    lib, _ = build.load_shared(src, "g++", flags, "seven")
    assert profiling.COUNTERS["kernels.builds"] == before + 1
    spans = [s for s in profiling.RECORDER.spans if s.name == "setup.kernels"]
    assert [s.args for s in spans] == [{"lib": "seven", "built": True},
                                       {"lib": "seven", "built": False}]


@pytest.mark.parametrize("group, table", [
    ("utils.profiling", profiling.COUNTERS), ("accel.mt.LAUNCHES", mt.LAUNCHES),
    ("accel.front.LAUNCHES", front.LAUNCHES), ("accel.wave.LAUNCHES", wave.LAUNCHES),
    ("accel.traverse.STATS", traverse.STATS), ("accel.block_traverse.STATS",
                                              block_traverse.STATS),
    ("accel.cluster_traverse.STATS", cluster_traverse.STATS)])
def test_the_read_out_holds_the_counters_by_reference(group, table):
    assert profiling.RECORDER.read()["counters"][group] is table


def test_stage_timer_stages_are_kept_spans():
    t = profiling.StageTimer()
    with t.stage("render", sync=torch.ones(2)):
        pass
    (sp,) = profiling.RECORDER.spans
    assert sp.name == "render" and sp.sync is None
    assert t.totals["render"] == (sp.end - sp.start) * 1e-9

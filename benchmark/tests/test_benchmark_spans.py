"""The readers of the program's spans (harness/spans.py and the
``program_span`` metrics) on synthetic spans and traces: the interval
arithmetic, the window, set-up spans read over the whole run, and
nothing read (None, no error) from a program that keeps no spans."""
import types

import pytest

from harness import common, spans
from harness.profile import Trace

SPAN_METRICS = ("setup.kernels_s", "setup.optimizer_s", "renderer.film_gather_ms.render",
                "integrator.host_ms_per_spp.render", "device.idle_in_integrator_pct.render",
                "optim.backward_ms.grad", "optim.wait_ms.grad")


class Store:
    def __init__(self, spans_):
        self.spans = [types.SimpleNamespace(name=n, start=s, end=e) for n, s, e in spans_]


def trace(device, window=(0, 1000)):
    tr = Trace()
    tr.device = sorted(device, key=lambda d: d[1])
    tr.window = window
    return tr


@pytest.fixture
def program(monkeypatch):
    """Install synthetic spans as the program's recorder."""
    from phosphorus_mk2_tpu_torch.utils import profiling

    def install(spans_):
        monkeypatch.setattr(profiling, "RECORDER", Store(spans_))
    return install


def test_idle_intervals_and_their_overlap():
    tr = trace([("k", 100, 200), ("k", 150, 300), ("k", 600, 700)])
    idle = spans.idle_intervals(tr)
    assert idle == [(0, 100), (300, 600), (700, 1000)]
    assert spans.overlap_ns(idle, [(50, 120), (250, 650)]) == 50 + 300


def test_window_spans_and_setup_spans(program):
    program([("renderer.film_gather", 10, 14), ("renderer.film_gather", 500, 510),
             ("renderer.film_gather", 990, 1010), ("setup.kernels", -5000, -1000),
             ("setup.kernels", 2000, 2500)])
    ctx = {"trace": trace([])}
    assert spans.mean_ms(ctx, "renderer.film_gather") == pytest.approx((4 + 10) / 2 * 1e-6)
    assert spans.setup_s("setup.kernels") == pytest.approx(4500e-9)
    assert spans.mean_ms(ctx, "optim.backward") is None


def test_the_idle_share_inside_samples(program):
    program([("integrator.sample", 0, 500)])
    ctx = {"trace": trace([("k", 100, 200), ("k", 600, 700)]), "spp": 2}
    # idle: 0-100, 200-600, 700-1000 (800 ns), of which 0-100 and 200-500 in the sample
    got = common.reader("device.idle_in_integrator_pct.render").read(ctx)
    assert got == pytest.approx(100.0 * 400 / 800)
    got = common.reader("integrator.host_ms_per_spp.render").read(ctx)
    assert got == pytest.approx(500e-6 / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(name, monkeypatch):
    from phosphorus_mk2_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "RECORDER")
    ctx = {"trace": trace([("k", 100, 200)]), "spp": 4, "steps": 4, "passes": 1}
    assert common.reader(name).read(ctx) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_an_empty_store_reads_nothing(name, program):
    program([])
    ctx = {"trace": trace([("k", 100, 200)]), "spp": 4, "steps": 4, "passes": 1}
    assert common.reader(name).read(ctx) is None

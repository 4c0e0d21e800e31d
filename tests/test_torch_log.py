"""The port's utils/log.py against the JAX package's: the counterparts of
tests/test_log.py, and the verbose ``Renderer.render()`` of both packages
emitting the same ``render`` JSON line (the port used to log through
stdlib logging at INFO, silent at Python's default level, and emitted
no line).

Tolerances: none. The lines carry counts and sizes, compared exactly;
the timings (wall_s, mrays_per_s) are only checked positive.
"""
import io
import json

import torch

from phosphorus_mk2_tpu.core.options import Options as JOptions
from phosphorus_mk2_tpu.renderer import Renderer as JRenderer
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.renderer import Renderer
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box
from phosphorus_mk2_tpu_torch.utils import log as tlog
from phosphorus_mk2_tpu_torch.utils.log import LEVELS, Metrics, get_logger, set_level

torch.set_num_threads(1)


def test_logger_levels(capsys):
    log = get_logger("test")
    set_level("warn")
    log.info("hidden")
    log.warn("shown")
    err = capsys.readouterr().err
    assert "hidden" not in err
    assert "shown" in err and "test" in err
    set_level("info")
    log.debug("quiet")
    log.info("loud")
    err = capsys.readouterr().err
    assert "quiet" not in err and "loud" in err


def test_metrics_emit_json_line():
    m = Metrics("render")
    m.inc("passes").inc("passes").set("spp", 16).lap("first_pass_s")
    buf = io.StringIO()
    rec = m.emit(out=buf)
    assert rec["event"] == "render"
    assert rec["passes"] == 2 and rec["spp"] == 16
    assert "wall_s" in rec and "first_pass_s" in rec
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == rec


def test_the_module_is_the_jax_packages():
    from phosphorus_mk2_tpu.utils import log as jlog

    assert LEVELS == jlog.LEVELS
    assert get_logger("x") is get_logger("x")
    for name in ("Logger", "Metrics", "get_logger", "set_level"):
        assert hasattr(tlog, name), name
    import phosphorus_mk2_tpu.utils as jutils
    import phosphorus_mk2_tpu_torch.utils as tutils

    assert {n for n in dir(jutils) if not n.startswith("_")} <= set(dir(tutils))


def _opts(cls):
    return cls(samples_per_pixel=2, samples_per_pass=1, path_depth=1, use_bvh=False,
               verbose=True)


def test_verbose_render_emits_metrics(capsys):
    set_level("info")
    film = Renderer(sphere_in_box(width=8, height=8), _opts(Options), device="cpu").render()
    out = capsys.readouterr()
    rec = json.loads(out.out.strip().splitlines()[-1])
    assert rec["event"] == "render" and rec["passes"] == 2
    assert rec["mrays_per_s"] > 0 and rec["spp"] == 2
    assert rec["width"] == 8 and rec["height"] == 8 and rec["wall_s"] > 0
    assert "pass 1/2 spp" in out.err and "pass 2/2 spp" in out.err
    assert film["color"].shape == (8, 8, 3)


def test_verbose_render_line_matches_jax(capsys):
    set_level("info")
    JRenderer(j_sphere_in_box(width=8, height=8), _opts(JOptions)).render()
    jout = capsys.readouterr()
    Renderer(sphere_in_box(width=8, height=8), _opts(Options), device="cpu").render()
    tout = capsys.readouterr()
    jrec = json.loads(jout.out.strip().splitlines()[-1])
    trec = json.loads(tout.out.strip().splitlines()[-1])
    assert set(trec) == set(jrec)
    for k in ("event", "passes", "spp", "width", "height"):
        assert trec[k] == jrec[k], k
    # the same pass lines on stderr, logger name and message
    strip = [ln.split("]", 1)[1] for ln in jout.err.splitlines() if "renderer:" in ln]
    assert strip and strip == [ln.split("]", 1)[1] for ln in tout.err.splitlines()
                               if "renderer:" in ln]


def test_quiet_render_prints_nothing(capsys):
    opts = _opts(Options)
    opts.verbose = False
    Renderer(sphere_in_box(width=8, height=8), opts, device="cpu").render()
    out = capsys.readouterr()
    assert out.out == "" and "renderer:" not in out.err

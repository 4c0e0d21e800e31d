"""The port's CLI against the JAX package's: the same argv through both,
on the CPU (-c), on builtin:cornell_box 12x12 with the brute tracer.

Tolerances, and why:
  * depth 1: every pixel of every channel within rtol 2e-3, atol 1e-6.
    The films agree to rtol 1e-4 (tests/test_torch_render.py: the same
    samples hit the same triangles, only float summation order differs),
    and the EXR stores half floats, whose rounding can put two such
    values one half step (2**-10 relative) apart.
  * depth 2: at least 99% of the pixels within that bound, and the
    channel means within 1e-3 relative: past the first bounce a
    last-place difference can flip a Russian-roulette or an edge
    decision, which changes a path's whole contribution
    (tests/test_torch_render.py's depth-4 rule).
  * the port against itself (perf knobs, a resumed optimizer): bit for
    bit, since the knobs are ignored and the same samples are taken.
"""
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import cli as jcli
from phosphorus_mk2_tpu.io.exr import read_exr as j_read_exr
from phosphorus_mk2_tpu_torch import cli as tcli
from phosphorus_mk2_tpu_torch.io.exr import read_exr, write_film

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BOX = ["builtin:cornell_box", "--width", "12", "--height", "12", "--no-bvh", "-c", "-1"]


def _run(mod, tmp_path, name, argv):
    out = str(tmp_path / f"{name}.exr")
    assert mod.main([*argv, "-o", out]) == 0
    return read_exr(out) if mod is tcli else j_read_exr(out)


def _rgb(ch):
    return np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)


def _both(tmp_path, name, argv):
    return _run(jcli, tmp_path, f"j_{name}", argv), _run(tcli, tmp_path, f"t_{name}", argv)


def _per_pixel(j, t):
    assert set(t) == set(j)
    assert _rgb(j).max() > 0
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=1e-6, err_msg=k)


def test_parser_is_the_jax_clis():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert tp.prog == "phosphorus_mk2_tpu_torch"

    def actions(p):
        return [(a.option_strings, a.dest, a.default, a.help, a.type, a.nargs, a.metavar,
                 type(a).__name__) for a in p._actions]

    assert actions(tp) == actions(jp)
    assert tcli.BUILTIN_SCENES == jcli.BUILTIN_SCENES


def test_depth1_exr_per_pixel(tmp_path):
    j, t = _both(tmp_path, "d1", [*BOX, "-s", "2", "-d", "1"])
    _per_pixel(j, t)


def test_depth2_exr_statistics(tmp_path):
    j, t = _both(tmp_path, "d2", [*BOX, "-s", "2", "-d", "2"])
    a, b = _rgb(t), _rgb(j)
    within = np.isclose(a, b, rtol=2e-3, atol=1e-6).all(axis=-1).mean()
    assert within >= 0.99, within
    np.testing.assert_allclose(a.mean(axis=(0, 1)), b.mean(axis=(0, 1)), rtol=1e-3)


def test_normals_write_the_jax_channels(tmp_path):
    j, t = _both(tmp_path, "nrm", [*BOX, "-s", "2", "-d", "1", "--normals"])
    assert {"normal.X", "normal.Y", "normal.Z"} <= set(j)
    _per_pixel(j, t)


def test_yaml_scene_through_both(tmp_path):
    argv = [str(ROOT / "examples" / "cornell.yaml"), "--width", "12", "--height", "12",
            "-s", "2", "-d", "1", "-c", "-1"]
    j, t = _both(tmp_path, "yaml", argv)
    _per_pixel(j, t)


def _shape(text):
    """The printed lines with every number and path replaced."""
    text = re.sub(r"/\S+", "PATH", text)
    return re.sub(r"\d+(\.\d+)?", "N", text).splitlines()


def test_printed_lines_match_jax(tmp_path, capsys):
    argv = [*BOX, "-s", "4", "-d", "1", "--spp-per-pass", "2", "--progressive", "-v"]
    jcli.main([*argv, "-o", str(tmp_path / "j.exr"), "--png", str(tmp_path / "j.png")])
    jout = capsys.readouterr().out
    tcli.main([*argv, "-o", str(tmp_path / "t.exr"), "--png", str(tmp_path / "t.png")])
    tout = capsys.readouterr().out
    assert _shape(tout) == _shape(jout)
    assert tout.count("progressive preview") == 2
    assert "Devices: 1 x cpu" in tout
    assert os.path.getsize(tmp_path / "t.png") > 0


def test_mis_flag_changes_image(tmp_path):
    plain = _rgb(_run(tcli, tmp_path, "plain", [*BOX, "-s", "2", "-d", "2"]))
    mis = _rgb(_run(tcli, tmp_path, "mis", [*BOX, "-s", "2", "-d", "2", "--mis"]))
    assert np.isfinite(plain).all() and np.isfinite(mis).all()
    assert plain.max() > 0.0
    assert not np.allclose(plain, mis)


def test_perf_knobs_leave_the_image_bit_equal(tmp_path):
    base = _run(tcli, tmp_path, "base", [*BOX, "-s", "2", "-d", "2"])
    tuned = _run(tcli, tmp_path, "tuned", [
        *BOX, "-s", "2", "-d", "2", "--spp-batch", "2", "--depth-unroll", "2",
        "--sample-unroll", "1", "--remat", "--pallas"])
    for k in base:
        assert np.array_equal(tuned[k], base[k]), k


def test_optimize_writes_the_jax_keys_and_resumes(tmp_path, capsys):
    from phosphorus_mk2_tpu.optim import InverseRenderer as JInverse
    from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere
    from phosphorus_mk2_tpu_torch.core.options import Options
    from phosphorus_mk2_tpu_torch.renderer import Renderer
    from phosphorus_mk2_tpu_torch.scenes import sphere_in_box

    target = Renderer(sphere_in_box(12, 12),
                      Options(use_bvh=False, samples_per_pixel=4, path_depth=2),
                      device="cpu").render()
    tgt = str(tmp_path / "target.exr")
    write_film(tgt, {"color": target["color"], "alpha": target["alpha"]})
    out, ck = str(tmp_path / "rec.exr"), str(tmp_path / "ck")
    argv = ["builtin:sphere_in_box", "-o", out, "-d", "2", "--spp-per-pass", "4", "--no-bvh",
            "--width", "12", "--height", "12", "--optimize", tgt, "--train", "emission",
            "--steps", "4", "--lr", "0.05", "--checkpoint-dir", ck, "--checkpoint-every", "2",
            "-c", "-v"]
    assert tcli.main(argv) == 0
    text = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", text)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    params = np.load(out + ".params.npz")
    jinv = JInverse(j_sphere(width=12, height=12), target["color"], trainable=("emission",),
                    spp=4, max_depth=2, use_bvh=False)
    assert sorted(params.files) == sorted(jinv.params) == ["emission"]
    assert params["emission"].shape == tuple(jinv.params["emission"].shape)
    assert os.path.exists(os.path.join(ck, "optimizer.npz"))

    # resume: the second call starts at step 4 and takes no step
    assert tcli.main(argv) == 0
    text = capsys.readouterr().out
    assert "resumed optimizer checkpoint at step 4" in text and "(0 steps)" in text
    again = np.load(out + ".params.npz")
    assert np.array_equal(again["emission"], params["emission"])


def test_optimize_from_a_png_target(tmp_path, capsys):
    pytest.importorskip("PIL")
    from phosphorus_mk2_tpu_torch.io.exr import write_png

    rgb = _rgb(_run(tcli, tmp_path, "png_src", [*BOX, "-s", "2", "-d", "2"]))
    tgt = str(tmp_path / "target.png")
    write_png(tgt, rgb)
    out, prev = str(tmp_path / "rec.exr"), str(tmp_path / "prev.png")
    assert tcli.main([*BOX, "-d", "2", "--spp-per-pass", "2", "-o", out, "--optimize", tgt,
                      "--train", "lobe_weight", "--steps", "2", "--png", prev]) == 0
    assert "Wrote recovered-scene preview" in capsys.readouterr().out
    assert sorted(np.load(out + ".params.npz").files) == ["lobe_weight"]
    assert os.path.getsize(prev) > 0


def test_unknown_builtin_exits_as_jax_does():
    with pytest.raises(SystemExit) as j:
        jcli.load_scene("builtin:nope")
    with pytest.raises(SystemExit) as t:
        tcli.load_scene("builtin:nope")
    assert str(t.value) == str(j.value)


def test_without_host_only_a_cardless_host_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI renders on it")
    out = tmp_path / "never.exr"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["builtin:cornell_box", "-o", str(out), "--width", "8", "--height", "8",
                   "-s", "1", "-d", "1", "--no-bvh"])
    assert not out.exists()
    assert list(tmp_path.iterdir()) == []

"""The port's dry-run entry points (entry.py) against the repo's
``__graft_entry__.py``: entry()'s forward step on the same seed, and
dryrun_multichip's training step and checkpoint resume on CPU shards.

Tolerance of entry()'s step (one sample, depth 3): at least 99% of the
pixels within rtol 1e-3 (atol 1e-6), and the channel means within 1e-3
relative, tests/test_torch_render.py's rule past the first bounce (a
last-place difference can flip a Russian-roulette or an edge decision,
which changes one path's whole contribution).
"""
import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from phosphorus_mk2_tpu_torch import entry as tentry

torch.set_num_threads(1)


def test_entry_step_matches_jax():
    jfn, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = tentry.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape == (32 * 32, 3)
    assert np.isfinite(got).all() and want.max() > 0
    per_pixel = np.isclose(got, want, rtol=1e-3, atol=1e-6).all(axis=-1)
    assert per_pixel.mean() >= 0.99, per_pixel.mean()
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3)


def test_entry_step_takes_the_sample_offset():
    fn, (data, zero) = tentry.entry("cpu")
    assert zero == 0
    a, b = fn(data, 0), fn(data, 1)
    assert not torch.equal(a, b)
    assert torch.equal(fn(data, 0), a)


def test_dryrun_multichip_on_two_cpu_shards(capsys):
    res = tentry.dryrun_multichip(2, device="cpu", grid=32)
    out = capsys.readouterr().out
    assert res["resumed_at"] == 1 and np.isfinite(res["loss"]) and res["loss"] > 0
    assert res["tris"] > 1024  # the cluster tracer, not the brute one
    assert "one training step OK" in out and "mesh {'host': 2, 'chip': 1}" in out
    assert "2-pass checkpoint/resume OK" in out and "resumed at 1/2" in out


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(1)

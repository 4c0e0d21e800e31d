"""``spp_batch`` (samples folded into one wider wavefront) and per-ray
sample indices in the port, against the port at spp_batch=1 and against
the JAX package's ``render_pass(spp_batch=)``, ``trace_sample`` and
``Renderer``, on sphere_in_box (tests/test_integrator.py's
``small_scene``), the brute tracer, the same seed.

Tolerances, and why:
  * spp_batch against spp_batch=1: every pixel within rtol 1e-4, atol
    1e-5, the bound of tests/test_integrator.py's
    test_spp_batch_equivalent. Each lane takes the same sample as at
    spp_batch=1 (its own counter); the sums differ only by float
    reassociation.
  * against JAX: the same bound on at least 99% of the pixels, and the
    channel means within 1e-4 relative. The packages differ by float
    summation order in the shading (tests/test_torch_render.py), which
    can flip a grazing light sample's NEE decision: here one pixel of
    256 (index 55: a sample JAX lights with 0.0046 and the port with 0)
    at depth 1 already. The pixels beyond the bound at spp_batch=4 are
    among those beyond it at spp_batch=1: spp_batch adds none.
  * a spp_batch that does not divide the samples (or exceeds them) falls
    back as JAX's does, to the very same operations: bit for bit.
  * an (N,) tensor of equal sample indices against the int: bit for bit
    (the same uniforms, the same strata cell).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.core.options import Options as JOptions
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.integrator.path import trace_sample as j_trace_sample
from phosphorus_mk2_tpu.renderer import Renderer as JRenderer
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.renderer import Renderer
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box

# several pytest workers share few cores and the tensors are small
torch.set_num_threads(1)

RES = 16
SEED, SPP, DEPTH, STRATA = 3, 8, 3, 2
BOUND = dict(rtol=1e-4, atol=1e-5)


def _port():
    ts = sphere_in_box(RES, RES)
    td = ts.build(device="cpu")
    return td, t_cam_params(ts.camera, "cpu"), tpath.make_tracer(td, use_bvh=False)


def _port_pass(sb, film_strata=STRATA):
    td, cam, tracer = _port()
    with torch.no_grad():
        out = tpath.render_pass(td, cam, SEED, 0, SPP, width=RES, height=RES, max_depth=DEPTH,
                                tracer=tracer, film_strata=film_strata, spp_batch=sb)
    return {k: v.numpy() for k, v in out.items()}


def _assert_close(got, ref):
    assert np.isfinite(got["color"]).all() and ref["color"].max() > 0
    for k in ("color", "normal", "alpha"):
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **BOUND)


def _beyond(got, ref):
    """The pixels whose color is beyond BOUND."""
    return ~np.isclose(got["color"], ref["color"], **BOUND).reshape(-1, 3).all(axis=-1)


def _assert_matches_jax(got, ref):
    assert np.isfinite(got["color"]).all() and ref["color"].max() > 0
    for k in ("color", "normal", "alpha"):
        share = np.isclose(got[k], ref[k], **BOUND).reshape(RES * RES, -1).all(axis=-1).mean()
        assert share >= 0.99, (k, share)
        np.testing.assert_allclose(got[k].reshape(RES * RES, -1).mean(axis=0),
                                   ref[k].reshape(RES * RES, -1).mean(axis=0), rtol=1e-4,
                                   err_msg=k)


def test_spp_batch_matches_sb1_and_jax():
    js = j_sphere_in_box(width=RES, height=RES)
    jd = js.build()
    ref = {}
    for sb in (1, 4):
        out = jax.jit(
            functools.partial(j_render_pass, width=RES, height=RES, max_depth=DEPTH,
                              tracer=j_make_tracer(jd, use_bvh=False), film_strata=STRATA,
                              spp_batch=sb),
            static_argnames=("n_samples",),
        )(jd, j_cam_params(js.camera), jax.random.key(SEED), 0, SPP)
        ref[sb] = {k: np.asarray(v) for k, v in out.items()}
    sb4, sb1 = _port_pass(4), _port_pass(1)
    _assert_close(sb4, sb1)
    _assert_matches_jax(sb4, ref[4])
    assert not (_beyond(sb4, ref[4]) & ~_beyond(sb1, ref[1])).any()


@pytest.mark.parametrize("sb,same_as", [(3, 1), (5, 1), (16, 8)])
def test_spp_batch_fallback_is_bit_equal(sb, same_as):
    """3 and 5 do not divide 8 samples: spp_batch 1. 16 exceeds them:
    min(16, 8) = 8."""
    got, ref = _port_pass(sb, film_strata=1), _port_pass(same_as, film_strata=1)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_per_ray_sample_index_matches_jax():
    """trace_sample with an (N,) tensor of sample indices (a strata cell
    each) against the JAX package's with the same indices."""
    rng = np.random.default_rng(7)
    sidx = rng.integers(0, 1000, RES * RES)
    ids = np.arange(RES * RES)
    px, py = ids % RES, ids // RES
    js = j_sphere_in_box(width=RES, height=RES)
    jd = js.build()
    ref = jax.jit(functools.partial(
        j_trace_sample, max_depth=DEPTH, tracer=j_make_tracer(jd, use_bvh=False),
        film_strata=STRATA,
    ))(jd, j_cam_params(js.camera), jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
       jnp.asarray(sidx, jnp.int32), jax.random.key(SEED))
    td, cam, tracer = _port()
    with torch.no_grad():
        got = tpath.trace_sample(td, cam, torch.from_numpy(px), torch.from_numpy(py),
                                 torch.from_numpy(sidx), SEED, max_depth=DEPTH, tracer=tracer,
                                 film_strata=STRATA)
    for k, g, r in zip(("color", "normal", "alpha"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=k, **BOUND)


def test_equal_sample_indices_are_the_int():
    td, cam, tracer = _port()
    px, py = tpath.frame_pixels(RES, RES, "cpu")
    kw = dict(max_depth=DEPTH, tracer=tracer, film_strata=STRATA)
    with torch.no_grad():
        by_int = tpath.trace_sample(td, cam, px, py, 5, SEED, **kw)
        by_ray = tpath.trace_sample(td, cam, px, py, torch.full((RES * RES,), 5), SEED, **kw)
    for a, b in zip(by_int, by_ray):
        assert torch.equal(a, b)


def test_renderer_spp_batch_matches_jax_renderer():
    """Options.spp_batch through Renderer, make_sharded_render and
    ShardedRender, against the JAX Renderer at the same setting and the
    port's Renderer at spp_batch=1."""
    kw = dict(use_bvh=False, samples_per_pixel=4, samples_per_pass=4, path_depth=DEPTH,
              seed=SEED)
    ref = JRenderer(j_sphere_in_box(width=RES, height=RES), JOptions(spp_batch=2, **kw),
                    n_devices=1).render()
    r = Renderer(sphere_in_box(RES, RES), Options(spp_batch=2, **kw), device="cpu")
    assert r.fn.render_kw["spp_batch"] == 2
    got = r.render()
    base = Renderer(sphere_in_box(RES, RES), Options(**kw), device="cpu").render()
    _assert_matches_jax(got, {k: np.asarray(v) for k, v in ref.items()})
    _assert_close(got, base)

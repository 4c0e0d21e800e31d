"""``pipeline_shadow`` (bounce b's shadow rays traced in bounce b+1's
closest-hit trace, one any-hit trace after the loop) in the port, against
the JAX package's ``render_pass(pipeline_shadow=True)`` and its gradient,
and against the port's own immediate-occlusion NEE; plus the predicate
it rests on: a closest-hit "hit" within tmax is an any-hit occlusion, in
every tracer kind.

Tolerances, and why:
  * pipelined against non-pipelined, in the port: every pixel within
    rtol 1e-4, atol 1e-5, the bound of tests/test_integrator.py's
    test_pipeline_shadow_equivalent: the same contributions, added one
    bounce later (float summation order only).
  * port against JAX, both pipelined: the same bound on at least 99% of
    the pixels and the channel means within 1e-4 relative. The packages
    differ by float summation order in the shading, which can flip a
    grazing light sample's NEE decision (tests/test_torch_spp_batch.py);
    the pixels beyond the bound pipelined are among those beyond it
    without pipelining.
  * the gradient against jax.grad: max |g_port - g_jax| <= 2e-5 x the
    field's max |g_jax|, tests/test_torch_grad.py's bound for its
    reason (the same paths, float32 summation order).
  * a scene without lights, and the predicate: bit for bit (the same
    operations, or integer decisions).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from test_torch_cluster import _carry, _rays
from test_torch_render import _plane_scene

torch.set_num_threads(1)

BOUND = dict(rtol=1e-4, atol=1e-5)
# name -> (scene, resolution, tracer kind, mis, spp, depth); brute as
# tests/test_integrator.py's test_pipeline_shadow_equivalent
CASES = {
    "brute": ("sphere_in_box", 24, "brute", False, 4, 3),
    "cluster": ("multi_bsdf_scene", 16, "cluster", False, 2, 3),
    "cluster_mis": ("multi_bsdf_scene", 16, "cluster", True, 2, 3),
}


def _pair(name, res, kind):
    """The JAX scene data (with the JAX package's BVH for a cluster
    tracer) and the port's copy of it, with both packages' cameras."""
    js = getattr(jscenes, name)(res, res)
    jd = js.build()
    if kind == "brute":
        ts = getattr(tscenes, name)(res, res)
        td = ts.build(device="cpu")
    else:
        jd = j_attach_bvh(jd, cluster_mode="treelet")
        td = _carry(jd)
    return jd, td, j_cam_params(js.camera), t_cam_params(getattr(tscenes, name)(res, res).camera,
                                                        "cpu")


def _jax_film(jd, jcam, kind, res, spp, depth, **kw):
    out = jax.jit(
        functools.partial(j_render_pass, width=res, height=res, max_depth=depth,
                          tracer=j_make_tracer(jd, kind=kind), **kw),
        static_argnames=("n_samples",),
    )(jd, jcam, jax.random.key(0), 0, spp)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_film(td, tcam, tracer, res, spp, depth, **kw):
    with torch.no_grad():
        out = tpath.render_pass(td, tcam, 0, 0, spp, width=res, height=res, max_depth=depth,
                                tracer=tracer, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _beyond(got, ref):
    return ~np.isclose(got["color"], ref["color"], **BOUND).all(axis=-1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pipelined_matches_jax_and_unpipelined(case):
    name, res, kind, mis, spp, depth = CASES[case]
    jd, td, jcam, tcam = _pair(name, res, kind)
    assert td.num_lights > 0
    ref = {pipe: _jax_film(jd, jcam, kind, res, spp, depth, mis=mis, pipeline_shadow=pipe)
           for pipe in (True, False)}
    tracer = tpath.make_tracer(td, kind=kind)
    got = {pipe: _port_film(td, tcam, tracer, res, spp, depth, mis=mis, pipeline_shadow=pipe)
           for pipe in (True, False)}
    assert np.isfinite(got[True]["color"]).all() and got[True]["color"].max() > 0
    for k in ("color", "normal", "alpha"):
        np.testing.assert_allclose(got[True][k], got[False][k], err_msg=k, **BOUND)
        share = np.isclose(got[True][k], ref[True][k], **BOUND).reshape(res * res, -1)
        assert share.all(axis=-1).mean() >= 0.99, k
        np.testing.assert_allclose(got[True][k].reshape(res * res, -1).mean(axis=0),
                                   ref[True][k].reshape(res * res, -1).mean(axis=0),
                                   rtol=1e-4, err_msg=k)
    assert not (_beyond(got[True], ref[True]) & ~_beyond(got[False], ref[False])).any()


def test_one_trace_a_bounce_and_one_resolve_a_sample():
    """Pipelined, each bounce makes one closest-hit call of 2N rays (the
    shadow half's tmax finite: a NaN would hit in closest and miss in
    occluded) and each sample one any-hit call; without it, N rays and
    one any-hit call a bounce."""
    res, spp, depth = 8, 2, 3
    ts = tscenes.sphere_in_box(res, res)
    td = ts.build(device="cpu")
    closest, occluded = tpath.make_tracer(td, use_bvh=False)
    calls = []

    def counted_closest(p, d, tmax=None):
        calls.append(("closest", p.shape[0], bool(torch.isfinite(tmax).all())))
        return closest(p, d, tmax)

    def counted_occluded(p, d, tmax):
        calls.append(("occluded", p.shape[0], bool(torch.isfinite(tmax).all())))
        return occluded(p, d, tmax)

    n = res * res
    for pipe, want in ((True, [("closest", 2 * n, True)] * depth + [("occluded", n, True)]),
                       (False, [("closest", n, True), ("occluded", n, True)] * depth)):
        calls.clear()
        _port_film(td, t_cam_params(ts.camera, "cpu"), (counted_closest, counted_occluded), res,
                   spp, depth, pipeline_shadow=pipe)
        assert calls == want * spp, pipe


def test_no_lights_makes_it_a_no_op():
    """No light (an environment counts as one): nothing to pipeline, so
    the same N-ray traces, no any-hit trace, and the same (black) film."""
    scene = _plane_scene(with_env=False)
    td = scene.build(device="cpu")
    assert td.num_lights == 0
    cam = t_cam_params(scene.camera, "cpu")
    closest, occluded = tpath.make_tracer(td, use_bvh=False)
    calls = []

    def counted_closest(p, d, tmax=None):
        calls.append(("closest", p.shape[0]))
        return closest(p, d, tmax)

    def counted_occluded(p, d, tmax):
        calls.append(("occluded", p.shape[0]))
        return occluded(p, d, tmax)

    films = {}
    for pipe in (True, False):
        calls.clear()
        films[pipe] = _port_film(td, cam, (counted_closest, counted_occluded), 8, 4, 3,
                                 pipeline_shadow=pipe)
        assert calls == [("closest", 64)] * 12, pipe
    for k in films[False]:
        assert np.array_equal(films[True][k], films[False][k]), k
    assert films[True]["alpha"].max() > 0


@pytest.mark.parametrize("kind", ["brute", "cluster", "block", "per_ray"])
def test_closest_hit_within_tmax_is_occlusion(kind):
    """The pipelined shadow half reads closest()["hit"] where the other
    path calls occluded(): the two agree ray for ray, on zero, 1e-6 and
    mixed tmax (a zero or negative tmax is a miss for both)."""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    closest, occluded = tpath.make_tracer(_carry(jd), kind=kind)
    p, d, tmax = (torch.from_numpy(x) for x in _rays(11, n=512))
    tmax[5::7] = -1.0
    hit = closest(p, d, tmax)["hit"]
    occ = occluded(p, d, tmax)
    assert torch.equal(hit, occ)
    assert not hit[tmax <= 0].any() and hit.any() and not hit.all()


def test_pipelined_gradient_matches_jax():
    """d color.sum() / d (emission, lobe_weight, vertices), pipelined, on
    tests/test_torch_grad.py's sphere_in_box 16x16, 2 spp, depth 2; the
    deferred contribution carries its graph."""
    res, fields = 16, ("emission", "lobe_weight", "vertices")
    js = jscenes.sphere_in_box(res, res)
    jd = js.build()
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=False)

    def loss(params):
        out = j_render_pass(dataclasses.replace(jd, **params), jcam, jax.random.key(0), 0, 2,
                            width=res, height=res, max_depth=2, tracer=jtracer,
                            sorted_dispatch=False, pipeline_shadow=True)
        return out["color"].sum()

    ref = jax.jit(jax.grad(loss))({f: getattr(jd, f) for f in fields})
    ts = tscenes.sphere_in_box(res, res)
    td = ts.build(device="cpu")
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in fields}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), t_cam_params(ts.camera, "cpu"), 0,
                            0, 2, width=res, height=res, max_depth=2,
                            tracer=tpath.make_tracer(td, use_bvh=False), pipeline_shadow=True)
    out["color"].sum().backward()
    for f in fields:
        r, g = np.asarray(ref[f]), leaves[f].grad.numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0, f
        assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max(), f

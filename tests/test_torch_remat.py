"""``remat`` (each bounce through ``torch.utils.checkpoint``: the carry
kept, the bounce run again in the backward) in the port: gradients
against the port without it and against ``jax.grad`` of the JAX
package's ``render_pass(remat=True)``; the forward without autograd
untouched; together with ``pipeline_shadow``; through
``make_sharded_render``.

Tolerances, and why:
  * remat against no remat, in the port: bit for bit. The recompute runs
    the same operations on the same carry (every random number is a
    counter, the trace is primal), so the backward sees the same values.
  * against jax.grad: max |g_port - g_jax| <= 2e-5 x the field's max
    |g_jax|, tests/test_torch_grad.py's bound for its reason (the same
    paths, float32 summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.parallel.sharding import make_sharded_render, make_wave_mesh
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene, sphere_in_box

torch.set_num_threads(1)

RES, SPP, DEPTH = 16, 2, 4
FIELDS = ("emission", "lobe_weight", "vertices")


@pytest.fixture
def counted(monkeypatch):
    """Counts the bounces run through torch.utils.checkpoint and the
    tracer calls made, forward and backward."""
    n = {"checkpoints": 0, "traces": 0}
    real = tpath.checkpoint

    def checkpoint(*args, **kw):
        n["checkpoints"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(tpath, "checkpoint", checkpoint)
    return n


def _traced(tracer, n):
    closest, occluded = tracer

    def c(*a):
        n["traces"] += 1
        return closest(*a)

    def o(*a):
        n["traces"] += 1
        return occluded(*a)

    return c, o


def _setup(scene_name):
    ts = {"sphere_in_box": sphere_in_box, "multi_bsdf_scene": multi_bsdf_scene}[scene_name](
        RES, RES)
    td = ts.build(device="cpu")
    kind = "brute"
    if scene_name == "multi_bsdf_scene":
        td, kind = attach_bvh(td), "cluster"
    return td, t_cam_params(ts.camera, "cpu"), tpath.make_tracer(td, kind=kind)


def _grads(td, cam, tracer, fields=FIELDS, **kw):
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in fields}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), cam, 0, 0, SPP, width=RES,
                            height=RES, max_depth=DEPTH, tracer=tracer, **kw)
    out["color"].sum().backward()
    return out["color"].detach(), {f: leaves[f].grad for f in fields}


@pytest.mark.parametrize("scene_name,trainable", [
    ("sphere_in_box", None), ("sphere_in_box", ("emission", "lobe_weight")),
    ("multi_bsdf_scene", None)])
def test_remat_gradients_are_bit_equal(counted, scene_name, trainable):
    """The brute tracer, a scoped backward, and the cluster tracer (its
    host syncs and compaction reproduce the same shapes in the
    recompute: torch.utils.checkpoint's shape check stays on)."""
    td, cam, tracer = _setup(scene_name)
    fields = trainable or FIELDS
    film, ref = _grads(td, cam, tracer, fields, trainable=trainable)
    assert counted["checkpoints"] == 0
    got_film, got = _grads(td, cam, _traced(tracer, counted), fields, trainable=trainable,
                           remat=True)
    assert counted["checkpoints"] == SPP * DEPTH
    # one closest and one any-hit trace a bounce, then the recompute's
    assert counted["traces"] > 2 * SPP * DEPTH
    assert torch.equal(got_film, film)
    for f in fields:
        assert ref[f].abs().max() > 0, f
        assert torch.equal(got[f], ref[f]), f


def test_remat_gradient_matches_jax():
    js = j_sphere_in_box(width=RES, height=RES)
    jd = js.build()
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=False)

    def loss(params):
        out = j_render_pass(dataclasses.replace(jd, **params), jcam, jax.random.key(0), 0, SPP,
                            width=RES, height=RES, max_depth=DEPTH, tracer=jtracer,
                            sorted_dispatch=False, remat=True)
        return out["color"].sum()

    ref = jax.jit(jax.grad(loss))({f: getattr(jd, f) for f in FIELDS})
    td, cam, tracer = _setup("sphere_in_box")
    _, got = _grads(td, cam, tracer, remat=True)
    for f in FIELDS:
        r, g = np.asarray(ref[f]), got[f].numpy()
        assert np.isfinite(g).all() and np.abs(r).max() > 0, f
        assert np.abs(g - r).max() <= 2e-5 * np.abs(r).max(), f


def test_remat_without_autograd_is_the_default_path(counted):
    """Under no_grad, or with nothing that requires grad, remat runs no
    checkpoint and the film is the default's bit for bit."""
    td, cam, tracer = _setup("sphere_in_box")
    kw = dict(width=RES, height=RES, max_depth=DEPTH, tracer=tracer)
    with torch.no_grad():
        ref = tpath.render_pass(td, cam, 0, 0, SPP, **kw)
        got = tpath.render_pass(td, cam, 0, 0, SPP, remat=True, **kw)
    plain = tpath.render_pass(td, cam, 0, 0, SPP, remat=True, **kw)
    assert counted["checkpoints"] == 0
    for k in ref:
        assert torch.equal(got[k], ref[k]) and torch.equal(plain[k], ref[k]), k


def test_remat_with_pipeline_shadow(counted):
    """Both at once: the pending shadow rays ride in the checkpointed
    carry; the gradients are those of pipeline_shadow alone."""
    td, cam, tracer = _setup("sphere_in_box")
    film, ref = _grads(td, cam, tracer, pipeline_shadow=True)
    got_film, got = _grads(td, cam, tracer, pipeline_shadow=True, remat=True)
    assert counted["checkpoints"] == SPP * DEPTH
    assert torch.equal(got_film, film)
    for f in FIELDS:
        assert torch.equal(got[f], ref[f]), f


def test_sharded_render_passes_remat(counted):
    """make_sharded_render(remat=True) reaches every shard's pass: two
    CPU shards, a gradient through the replicas, bit-equal to remat=False."""
    ts = sphere_in_box(RES, RES)
    td = ts.build(device="cpu")
    grads = {}
    for remat in (False, True):
        fn, *_ = make_sharded_render(make_wave_mesh(2, device="cpu"), td, ts.camera,
                                     max_depth=DEPTH, use_bvh=False, remat=remat)
        leaf = td.emission.detach().clone().requires_grad_()
        out = fn(dataclasses.replace(td, emission=leaf), 0, 0, SPP)
        sum(s["color"].sum() for s in out).backward()
        grads[remat] = leaf.grad
    assert counted["checkpoints"] == 2 * SPP * DEPTH
    assert grads[False].abs().max() > 0
    assert torch.equal(grads[True], grads[False])

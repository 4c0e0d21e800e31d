"""Gradients through the cluster tracer: the port's multi_bsdf_scene
72x60 with use_bvh=True (BVH attached, cluster tracer, dense lobe
dispatch) against jax.grad of the JAX package's same render, as in
tests/test_grad.py::test_grad_multi_type_scene_dense_dispatch. A file
of its own: the JAX gradient takes about 80 s to compile on a CPU.

Tolerance: max |g_port - g_jax| <= 2e-5 x the field's max |g_jax| (the
bound of tests/test_torch_grad.py, for its reason: the same paths, float32
summation order only; both cluster tracers pick the same triangles).
"""
import dataclasses

import jax
import numpy as np
import torch

from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.scenes import multi_bsdf_scene as j_multi_bsdf_scene
from phosphorus_mk2_tpu_torch.accel import cluster_traverse
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh as t_attach_bvh
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.scenes import multi_bsdf_scene

torch.set_num_threads(1)

W, H = 72, 60
NAMES = ("emission", "lobe_weight", "lobe_param")


def test_bvh_grads_match_jax():
    js = j_multi_bsdf_scene(width=W, height=H)
    jd = j_attach_bvh(js.build())
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=True)
    assert len(jd.lobe_types_present) > 2

    def loss(e, w, p):
        d2 = dataclasses.replace(jd, emission=e, lobe_weight=w, lobe_param=p)
        out = j_render_pass(d2, jcam, jax.random.key(2), 0, 1, width=W, height=H,
                            max_depth=2, tracer=jtracer, sorted_dispatch=False)
        return out["color"].mean()

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jd.emission, jd.lobe_weight, jd.lobe_param)

    ts = multi_bsdf_scene(W, H)
    td = t_attach_bvh(ts.build(device="cpu"))
    tracer = tpath.make_tracer(td, use_bvh=True)
    assert tracer[0].func is cluster_traverse.intersect_clusters
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in NAMES}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), t_cam_params(ts.camera, "cpu"),
                            2, 0, 1, width=W, height=H, max_depth=2, tracer=tracer)
    out["color"].mean().backward()
    for f, r in zip(NAMES, ref):
        g, r = leaves[f].grad.numpy(), np.asarray(r)
        assert np.isfinite(g).all(), f
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= 2e-5, (f, err)
    assert np.abs(leaves["lobe_param"].grad.numpy()).max() > 0

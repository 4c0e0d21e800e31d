"""Films through the oracle tracer kinds: cornell_box 16x16, 2 spp,
depth 3, traced with make_tracer(kind="block") and kind="per_ray" in the
port and in the JAX package, on the JAX package's BVH tables.

Tolerances are tests/test_torch_cluster_render.py's at depth > 1, for
its reasons: at least 99% of the pixels within rtol 1e-3 (atol 1e-6),
the image and channel means within 1e-3 relative (past the first bounce
a last-place difference can flip a triangle-edge decision).
"""
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
from phosphorus_mk2_tpu_torch.integrator.path import make_tracer, render_pass
from test_torch_cluster import _carry
from test_torch_cluster_render import _assert_films_close

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

W = H = 16
SPP, DEPTH = 2, 3


@pytest.mark.parametrize("kind", ["block", "per_ray"])
def test_oracle_kind_film_matches_jax(kind):
    js = jscenes.cornell_box(W, H)
    jd = j_attach_bvh(js.build(), cluster_mode="treelet")
    ref = jax.jit(
        functools.partial(j_render_pass, width=W, height=H, max_depth=DEPTH,
                          tracer=j_make_tracer(jd, kind=kind)),
        static_argnames=("n_samples",),
    )(jd, j_cam_params(js.camera), jax.random.key(0), 0, SPP)
    td = _carry(jd)
    got = render_pass(td, t_cam_params(tscenes.cornell_box(W, H).camera, "cpu"), 0, 0, SPP,
                      width=W, height=H, max_depth=DEPTH, tracer=make_tracer(td, kind=kind))
    ref = {k: np.asarray(v).reshape(H, W, -1) / SPP for k, v in ref.items()}
    got = {k: v.reshape(H, W, -1).numpy() / SPP for k, v in got.items()}
    _assert_films_close(ref, got, DEPTH)
    # the same film as the brute tracer's, the port's oracle of record
    brute = render_pass(td, t_cam_params(tscenes.cornell_box(W, H).camera, "cpu"), 0, 0, SPP,
                        width=W, height=H, max_depth=DEPTH, tracer=make_tracer(td, kind="brute"))
    assert np.isclose(got["color"], brute["color"].reshape(H, W, -1).numpy() / SPP,
                      rtol=1e-5, atol=1e-7).all(axis=-1).mean() >= 0.99

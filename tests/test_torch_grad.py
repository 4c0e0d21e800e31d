"""Pixel-loss gradients of the port (brute tracer, sphere_in_box 16x16 as
in tests/test_grad.py) against ``jax.grad`` of the JAX package on the
same scene and seed, against finite differences, and the gradient
scoping (``trainable=``); plus the tracer contract of the gradient
slice: a render traces the scene it is given, and no tracer input
requires grad.

Tolerances, and why:
  * port against jax.grad, every SCOPABLE field: max |g_port - g_jax|
    <= 2e-5 x the field's max |g_jax| (a field whose JAX gradient is all
    zero must be all zero in the port). The same samples take the same
    paths; the gradients differ only by float32 summation order over a
    few thousand contributions per entry (measured 1.9e-8 for emission,
    4.2e-6 for vertices, 9.4e-6 for vertices with an environment light).
  * finite differences: test_grad.py's eps and tolerances (emission eps
    1e-2 at rtol 5e-3; albedo eps 1e-3 at rtol 2e-2; a lamp vertex eps
    3e-4 at rtol 0.05, atol 1e-3: interior gradients only, so eps stays
    below any visibility flip).
  * scoped against unscoped: rtol 1e-5, atol 1e-7 (test_grad.py's
    bound); the same operations on the same values give the same
    gradients.
  * moved vertices: the depth-1 film against the JAX package's film of
    the moved scene per pixel at rtol 1e-4, atol 1e-6 (the bound of
    tests/test_torch_render.py).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.accel.pallas_mt import (
    intersect_pallas_brute,
    occluded_pallas_brute,
)
from phosphorus_mk2_tpu.core.camera import camera_to_params as j_cam_params
from phosphorus_mk2_tpu.core.material import Material as JMaterial
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu.integrator.path import render_pass as j_render_pass
from phosphorus_mk2_tpu.scenes import sphere_in_box as j_sphere_in_box
from phosphorus_mk2_tpu_torch.accel import front, mt, wave
from phosphorus_mk2_tpu_torch.core.camera import camera_to_params as t_cam_params
from phosphorus_mk2_tpu_torch.core.material import Material as TMaterial
from phosphorus_mk2_tpu_torch.integrator import path as tpath
from phosphorus_mk2_tpu_torch.scenes import sphere_in_box as t_sphere_in_box

# several pytest workers share few cores and the tensors are small
torch.set_num_threads(1)

RES = 16
FIELDS = tpath.SCOPABLE_FIELDS


def _scenes(with_env=False):
    js, ts = j_sphere_in_box(width=RES, height=RES), t_sphere_in_box(width=RES, height=RES)
    if with_env:
        js.set_environment(JMaterial.background((0.4, 0.5, 0.6), power=0.5, name="sky"))
        ts.set_environment(TMaterial.background((0.4, 0.5, 0.6), power=0.5, name="sky"))
    return js, ts


def _port_setup(ts):
    td = ts.build(device="cpu")
    return td, t_cam_params(ts.camera, "cpu"), tpath.make_tracer(td, use_bvh=False)


def _port_grads(td, cam, tracer, seed, fields, *, spp=2, depth=2, trainable=None):
    """d color.sum() / d fields, each field a fresh leaf."""
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in fields}
    out = tpath.render_pass(dataclasses.replace(td, **leaves), cam, seed, 0, spp,
                            width=RES, height=RES, max_depth=depth, tracer=tracer,
                            trainable=trainable)
    out["color"].sum().backward()
    return {f: leaves[f].grad for f in fields}


def _assert_grads_close(got, ref, field, rel=2e-5):
    ref = np.asarray(ref)
    got = got.numpy()
    assert np.isfinite(got).all(), field
    scale = np.abs(ref).max()
    if scale == 0.0:
        assert not got.any(), field
        return
    err = np.abs(got - ref).max() / scale
    assert err <= rel, (field, err)


@pytest.mark.parametrize("with_env,depth", [(False, 2), (True, 2), (False, 4)])
def test_grads_match_jax(with_env, depth):
    """Depth 2 as in tests/test_grad.py; depth 4 reaches Russian
    roulette, whose survival weight is a constant (q from the detached
    throughput) in both packages."""
    js, ts = _scenes(with_env)
    jd = js.build()
    jcam, jtracer = j_cam_params(js.camera), j_make_tracer(jd, use_bvh=False)

    def loss(params):
        out = j_render_pass(dataclasses.replace(jd, **params), jcam, jax.random.key(0), 0, 2,
                            width=RES, height=RES, max_depth=depth, tracer=jtracer,
                            sorted_dispatch=False)
        return out["color"].sum()

    ref = jax.jit(jax.grad(loss))({f: getattr(jd, f) for f in FIELDS})
    td, cam, tracer = _port_setup(ts)
    got = _port_grads(td, cam, tracer, 0, FIELDS, depth=depth)
    for f in FIELDS:
        _assert_grads_close(got[f], ref[f], f)
    assert got["emission"].abs().max() > 0 and got["vertices"].abs().max() > 0
    assert got["lobe_weight"].abs().max() > 0


def _render_mean(td, cam, tracer):
    out = tpath.render_pass(td, cam, 0, 0, 2, width=RES, height=RES, max_depth=2,
                            tracer=tracer)
    return out["color"].mean() / 2.0


def _fd(td, cam, tracer, field, idx, eps):
    """Central difference on one scalar entry of a field (the moved
    geometry is traced: the brute tracer rebinds to it)."""
    arr = getattr(td, field)

    def at(x):
        a = arr.clone()
        a[idx] = x
        return float(_render_mean(dataclasses.replace(td, **{field: a}), cam, tracer))

    x0 = float(arr[idx])
    return (at(x0 + eps) - at(x0 - eps)) / (2 * eps)


def test_gradients_match_finite_differences():
    _, ts = _scenes()
    td, cam, tracer = _port_setup(ts)
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in FIELDS}
    _render_mean(dataclasses.replace(td, **leaves), cam, tracer).backward()
    grads = {f: leaves[f].grad.numpy() for f in FIELDS}

    g = grads["emission"][3, 1]  # the lamp (material 3), green
    np.testing.assert_allclose(g, _fd(td, cam, tracer, "emission", (3, 1), 1e-2),
                               rtol=5e-3, atol=1e-6)
    assert g > 0.0
    g = grads["lobe_weight"][0, 0, 0]  # white diffuse albedo, red
    np.testing.assert_allclose(g, _fd(td, cam, tracer, "lobe_weight", (0, 0, 0), 1e-3),
                               rtol=2e-2, atol=1e-6)
    assert g > 0.0
    v_idx = int(td.faces.numpy()[td.tri_mat.numpy() == 3][0, 0])  # a lamp vertex
    g = grads["vertices"][v_idx, 1]
    assert np.isfinite(g)
    np.testing.assert_allclose(g, _fd(td, cam, tracer, "vertices", (v_idx, 1), 3e-4),
                               rtol=0.05, atol=1e-3)
    for f in FIELDS:
        assert np.isfinite(grads[f]).all(), f
    for f in ("emission", "lobe_weight", "vertices"):
        assert np.abs(grads[f]).sum() > 0, f


def test_trainable_scoping_grads_identical():
    _, ts = _scenes()
    td, cam, tracer = _port_setup(ts)
    pair = ("emission", "lobe_weight")
    full = _port_grads(td, cam, tracer, 1, pair, depth=3)
    scoped = _port_grads(td, cam, tracer, 1, pair, depth=3, trainable=pair)
    for f in pair:
        np.testing.assert_allclose(scoped[f].numpy(), full[f].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
        assert scoped[f].abs().max() > 0
    # the attribute block: vertices alone
    full = _port_grads(td, cam, tracer, 1, ("vertices",), depth=3)
    scoped = _port_grads(td, cam, tracer, 1, ("vertices",), depth=3, trainable=("vertices",))
    np.testing.assert_allclose(scoped["vertices"].numpy(), full["vertices"].numpy(),
                               rtol=1e-5, atol=1e-7)
    # a field outside trainable gets no gradient at all
    cut = _port_grads(td, cam, tracer, 1, ("emission", "lobe_weight", "vertices"), depth=3,
                      trainable=("emission",))
    assert cut["emission"].abs().max() > 0
    assert cut["lobe_weight"] is None and cut["vertices"] is None
    with pytest.raises(ValueError, match="unknown trainable"):
        _port_grads(td, cam, tracer, 1, ("emission",), trainable=("emision",))


@pytest.mark.parametrize("columns", [("emission",), ("lobe_param", "normals"), None])
def test_gather_hit_rows_scoped_columns(columns):
    """Column-scoped gather: the same rows; gradient only in the
    trainable fields' column blocks."""
    _, ts = _scenes()
    td = ts.build(device="cpu")
    tables = tpath.make_scene_tables(td)
    layout = tables["hit_layout"]
    hit_f = tables["hit_f"].detach().requires_grad_()
    idx = torch.tensor([0, 5, 5, 17, 3])
    from phosphorus_mk2_tpu_torch.bsdf.bsdf import gather_hit_rows

    rows = gather_hit_rows(hit_f, idx, layout, columns)
    assert torch.equal(rows, hit_f.detach()[idx])
    rows.sum().backward()
    aw, lu, p = layout["attr_w"], layout["lu"], layout["p"]
    blocks = {"vertices": (0, aw), "normals": (0, aw), "emission": (aw, aw + 3),
              "lobe_weight": (aw + 3, aw + 3 + 3 * lu),
              "lobe_param": (aw + 3 + 3 * lu, aw + 3 + lu * (3 + p))}
    live = torch.zeros(hit_f.shape[1], dtype=torch.bool)
    for f, (c0, c1) in blocks.items():
        if columns is None or f in columns:
            live[c0:c1] = True
    if columns is None:
        live[:] = True
    used = torch.zeros(hit_f.shape[0])
    used.index_add_(0, idx, torch.ones(idx.shape[0]))
    want = used[:, None] * live[None, :].float()
    assert torch.equal(hit_f.grad, want)


def test_moved_vertices_are_traced():
    """A tracer made before the vertices moved traces the moved scene,
    as the JAX package's tracers (which take the scene at every call) do:
    after dataclasses.replace and after an in-place write."""
    js, ts = _scenes()
    td, cam, tracer = _port_setup(ts)
    jd = js.build()
    sphere = np.asarray(jd.tri_mat) == np.asarray(jd.tri_mat).max()  # the last material
    move = np.zeros(np.asarray(jd.vertices).shape, np.float32)
    verts_moved = np.unique(np.asarray(jd.faces)[sphere])
    move[verts_moved, 0] = 0.15
    moved_np = np.asarray(jd.vertices) + move

    pallas = (functools.partial(intersect_pallas_brute, interpret=True),
              functools.partial(occluded_pallas_brute, interpret=True))
    ref = jax.jit(functools.partial(j_render_pass, width=RES, height=RES, max_depth=1,
                                    tracer=pallas),
                  static_argnames=("n_samples",))(
        dataclasses.replace(jd, vertices=jax.numpy.asarray(moved_np)),
        j_cam_params(js.camera), jax.random.key(0), 0, 2)["color"]

    def film(scene):
        return tpath.render_pass(scene, cam, 0, 0, 2, width=RES, height=RES, max_depth=1,
                                 tracer=tracer)["color"].numpy()

    still = film(td)
    replaced = film(dataclasses.replace(td, vertices=torch.from_numpy(moved_np)))
    assert np.abs(replaced - still).max() > 1e-2  # the move shows
    np.testing.assert_allclose(replaced, np.asarray(ref), rtol=1e-4, atol=1e-6)
    in_place = ts.build(device="cpu")
    with torch.no_grad():
        in_place.vertices += torch.from_numpy(move)
    np.testing.assert_array_equal(film(in_place), replaced)
    # the geometry of the tracer's own scene is still the unmoved one
    np.testing.assert_array_equal(film(td), still)


def test_tracer_inputs_never_require_grad():
    """The hand kernels are primal: every wrapper refuses a tensor that
    requires grad (plain versions included, so the CPU shows it), and a
    gradient render through the brute and the cluster tracer never
    hands one over."""
    _, ts = _scenes()
    td = ts.build(device="cpu")
    table = mt.tri_table(td)
    g = torch.Generator().manual_seed(0)
    p = torch.rand(8, 3, generator=g)
    d = torch.nn.functional.normalize(torch.randn(8, 3, generator=g), dim=-1)
    tmax = torch.full((8,), 5.0)
    pg = p.clone().requires_grad_()
    with pytest.raises(ValueError, match="primal"):
        mt.mt_closest_plain(table, pg, d)
    with pytest.raises(ValueError, match="primal"):
        mt.mt_anyhit(table, p, d, tmax.clone().requires_grad_())
    with pytest.raises(ValueError, match="primal"):
        front.front_full_plain(torch.zeros(2, 3), torch.ones(2, 3), torch.zeros(2, 4, 3),
                               torch.ones(2, 4, 3), pg, d, tmax, 1)
    rows = torch.zeros(1, 9, wave.ROW_C)
    state = (torch.full((8,), 5.0), torch.full((8,), -1, dtype=torch.int32),
             torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="primal"):
        wave.wave_sweep_plain(pg, d, rows, torch.arange(8, dtype=torch.int32), *state)

    # whole gradient renders: the wrappers' checks would raise
    from phosphorus_mk2_tpu_torch.scenes import terrain_scene
    from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh

    cam = t_cam_params(ts.camera, "cpu")
    for scene, kind in ((td, "brute"), (None, "cluster")):
        if scene is None:
            tsc = terrain_scene(grid=24, width=RES, height=RES)
            scene, cam = attach_bvh(tsc.build(device="cpu")), t_cam_params(tsc.camera, "cpu")
        tracer = tpath.make_tracer(scene, use_bvh=True, kind=kind,
                                   tracer_tune={"dense_k": 1} if kind == "cluster" else None)
        leaves = {f: getattr(scene, f).detach().clone().requires_grad_() for f in FIELDS}
        out = tpath.render_pass(dataclasses.replace(scene, **leaves), cam, 0, 0, 1,
                                width=RES, height=RES, max_depth=2, tracer=tracer)
        out["color"].sum().backward()
        assert leaves["emission"].grad.abs().max() > 0, kind
        assert torch.isfinite(leaves["vertices"].grad).all(), kind


def test_clamp_ties_take_half_the_gradient():
    """At a clamp's bound the port's gradient is the JAX package's
    (jnp.maximum / minimum / clip give half to each side; torch.clamp
    would give all of it): vec's helpers, and every lobe evaluated with
    its parameters exactly on the clamp bounds (sheen's roughness at 1
    and 5e-3, where lobes.sheen_f clips). rtol 1e-5, atol 1e-7: one
    lobe evaluation, float32 rounding only."""
    import jax.numpy as jnp

    from phosphorus_mk2_tpu.bsdf import lobes as jlobes
    from phosphorus_mk2_tpu_torch.bsdf import lobes as tlobes
    from phosphorus_mk2_tpu_torch.math import vec

    x = torch.tensor([0.5, 1.0, 2.0, 3.0], requires_grad=True)
    (vec.maximum(x, 1.0) + vec.minimum(x, 2.0) + vec.clip(x, 1.0, 3.0)).sum().backward()
    ref = jax.grad(lambda v: (jnp.maximum(v, 1.0) + jnp.minimum(v, 2.0)
                              + jnp.clip(v, 1.0, 3.0)).sum())(jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))

    rng = np.random.default_rng(4)
    n = 64
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wi = (nrm + 0.6 * rng.normal(size=(n, 3))).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo = (nrm + 0.6 * rng.normal(size=(n, 3))).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    params = rng.uniform(0.1, 0.9, size=(n, 6)).astype(np.float32)
    params[::2, 0] = 1.0   # sheen roughness on clip's upper bound
    params[1::4, 0] = 5e-3  # and on its lower bound
    for lobe in tlobes.EVALS:
        t = np.full(n, lobe, np.int32)

        def jf(p):
            f, pdf = jlobes.eval_lobe(jnp.asarray(t), p, jnp.asarray(nrm), jnp.asarray(wi),
                                      jnp.asarray(wo), present=(lobe,))
            return (f + pdf).sum()

        ref = np.asarray(jax.grad(jf)(jnp.asarray(params)))
        p = torch.from_numpy(params.copy()).requires_grad_()
        f, pdf = tlobes.eval_lobe(torch.from_numpy(t).long(), p, torch.from_numpy(nrm),
                                  torch.from_numpy(wi), torch.from_numpy(wo), present=(lobe,))
        out = (f + pdf).sum()
        got = (torch.autograd.grad(out, p)[0] if out.requires_grad  # diffuse: no parameter
               else torch.zeros_like(p))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7, err_msg=str(lobe))

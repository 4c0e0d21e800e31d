"""The un-consolidated shading path: above HIT_ROW_MAX_TRIS triangles
neither package builds the per-triangle hit rows, and trace_sample
shades from the attribute table, scene.tri_mat and the material tables.
Here the threshold is set to 0 in both packages (as the JAX package's
tests/test_integrator.py and tests/test_grad.py do), so that scenes of
a few triangles take that branch.

  * the port's two branches: films bit-equal (the same values gathered
    from other tables, the same arithmetic on them);
  * the port's branch against the JAX package's branch (its XLA brute
    tracer), at the tolerances of tests/test_torch_cluster_render.py:
    depth 1 per pixel rtol 1e-4, atol 1e-6 (the normal AOV atol 1e-5);
    deeper, at least 99% of the pixels within rtol 1e-3 (atol 1e-6) and
    the image and channel means within 1e-3 relative (a last-place
    difference can flip a Russian-roulette or a triangle-edge decision
    past the first bounce);
  * gradients of (emission, lobe_weight, vertices) against jax.grad:
    max |g_port - g_jax| <= 2e-5 x the field's max |g_jax|, the bound of
    tests/test_torch_grad.py for its reason (float32 summation order over
    a few thousand contributions an entry); scoped against full: rtol
    1e-5, atol 1e-7 (tests/test_grad.py's bound);
  * the gate: at HIT_ROW_MAX_TRIS triangles the rows are built, one more
    and they are not.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.core import camera as jcamera
from phosphorus_mk2_tpu.core import material as jmaterial
from phosphorus_mk2_tpu.core import mesh as jmesh
from phosphorus_mk2_tpu.core import scene as jscene
from phosphorus_mk2_tpu.core import texture as jtexture
from phosphorus_mk2_tpu.integrator import path as jpath
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.core import camera as tcamera
from phosphorus_mk2_tpu_torch.core import material as tmaterial
from phosphorus_mk2_tpu_torch.core import mesh as tmesh
from phosphorus_mk2_tpu_torch.core import scene as tscene
from phosphorus_mk2_tpu_torch.core import texture as ttexture
from phosphorus_mk2_tpu_torch.integrator import path as tpath

# several pytest workers share few cores and the tensors are small
torch.set_num_threads(1)

FIELDS = ("emission", "lobe_weight", "vertices")


class _Mods:
    def __init__(self, scene, material, mesh, texture, camera, scenes):
        self.Scene, self.Material, self.Mesh = scene.Scene, material.Material, mesh.Mesh
        self.Texture, self.checkerboard = texture.Texture, texture.checkerboard
        self.Camera, self.scenes = camera.Camera, scenes


J = _Mods(jscene, jmaterial, jmesh, jtexture, jcamera, jscenes)
T = _Mods(tscene, tmaterial, tmesh, ttexture, tcamera, tscenes)


def _quad(m, a, b, c, d, mat, uv_scale=1.0):
    return m.Mesh(vertices=np.array([a, b, c, d], np.float32),
                  faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                  uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale,
                  material=mat, smooth=False)


def shaded_scene(m, res=24):
    """Every id the hit side reads through the material: a normal-mapped
    floor with a musgrave lobe texture, a checker wall (mip levels: the
    ray cone's footprint), a lamp with an emission texture, and a sky."""
    scene = m.Scene()
    mus = scene.add_texture(m.Texture.musgrave(5.0, octaves=6, lacunarity=3.0, gain=0.7))
    checker = scene.add_texture(m.checkerboard(n=4, size=16, a=(1, 1, 1), b=(0.2, 0.3, 0.4)))
    bumps = scene.add_texture(m.Texture(np.full((4, 4, 3), [0.6, 0.5, 0.9], np.float32),
                                        name="bumps"))
    floor = m.Material.diffuse((0.9, 0.8, 0.7), name="floor")
    floor.lobes[0].texture = mus
    floor.normal_texture = bumps
    wall = m.Material.diffuse((0.7, 0.8, 0.9), name="wall")
    wall.lobes[0].texture = checker
    lamp = m.Material.emitter((1.0, 1.0, 1.0), power=8.0, name="lamp")
    lamp.emission_texture = checker
    f, w, l = (scene.add_material(x) for x in (floor, wall, lamp))
    scene.set_environment(m.Material.background((0.3, 0.4, 0.5), power=0.5, name="sky"))
    scene.add_mesh(_quad(m, [-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2], f, 2.0))
    scene.add_mesh(_quad(m, [-2, 0, -2], [2, 0, -2], [2, 2, -2], [-2, 2, -2], w, 3.0))
    scene.add_mesh(_quad(m, [-0.5, 1.8, -0.5], [0.5, 1.8, -0.5], [0.5, 1.8, 0.5],
                         [-0.5, 1.8, 0.5], l))
    scene.camera = m.Camera.look_at((0, 1.5, 3.0), (0, 0.5, 0), width=res, height=res)
    return scene


SCENES = {
    # 32x32 at spp_batch 4: 4,096 lanes, so the JAX side takes its
    # type-sorted dispatch, against the port's one dense dispatch
    "multi_bsdf_scene": lambda m: m.scenes.multi_bsdf_scene(32, 32),
    "shaded": shaded_scene,
}
# case: (scene, depth, spp, keywords of render_pass)
FILMS = {
    "multi_bsdf_sorted": ("multi_bsdf_scene", 3, 4, {"spp_batch": 4}),
    "shaded_depth1": ("shaded", 1, 2, {}),
    "shaded_mis": ("shaded", 3, 2, {"mis": True}),
    "shaded_pipeline_shadow": ("shaded", 3, 2, {"pipeline_shadow": True}),
    "shaded_spp_batch2": ("shaded", 3, 4, {"spp_batch": 2}),
}


@pytest.fixture
def attribute_branch(monkeypatch):
    """Both packages shade without hit rows."""
    monkeypatch.setattr(jpath, "HIT_ROW_MAX_TRIS", 0)
    monkeypatch.setattr(tpath, "HIT_ROW_MAX_TRIS", 0)


def _port_film(ts, depth, spp, seed=1, **kw):
    td = ts.build(device="cpu")
    w, h = ts.camera.width, ts.camera.height
    with torch.no_grad():
        out = tpath.render_pass(td, tcamera.camera_to_params(ts.camera, "cpu"), seed, 0, spp,
                                width=w, height=h, max_depth=depth,
                                tracer=tpath.make_tracer(td, use_bvh=False), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax_film(js, depth, spp, seed=1, **kw):
    jd = js.build()
    w, h = js.camera.width, js.camera.height
    fn = jax.jit(functools.partial(jpath.render_pass, width=w, height=h, max_depth=depth,
                                   tracer=jpath.make_tracer(jd, use_bvh=False), **kw),
                 static_argnames=("n_samples",))
    out = fn(jd, jcamera.camera_to_params(js.camera), jax.random.key(seed), 0, spp)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_films_close(ref, got, depth):
    r, g = ref["color"], got["color"]
    assert np.isfinite(g).all() and r.max() > 0
    if depth == 1:
        for k in ("color", "alpha"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["normal"], ref["normal"], rtol=0, atol=1e-5)
    else:
        per_pixel = np.isclose(g, r, rtol=1e-3, atol=1e-6).all(axis=-1)
        assert per_pixel.mean() >= 0.99, per_pixel.mean()
        np.testing.assert_allclose(g.mean(), r.mean(), rtol=1e-3)
        np.testing.assert_allclose(g.mean(axis=0), r.mean(axis=0), rtol=1e-3)


@pytest.mark.parametrize("case", sorted(FILMS))
def test_port_branches_bit_equal(case, monkeypatch):
    name, depth, spp, kw = FILMS[case]
    rows = _port_film(SCENES[name](T), depth, spp, **kw)
    monkeypatch.setattr(tpath, "HIT_ROW_MAX_TRIS", 0)
    attr = _port_film(SCENES[name](T), depth, spp, **kw)
    for k in rows:
        np.testing.assert_array_equal(attr[k], rows[k], err_msg=k)
    assert rows["color"].max() > 0


@pytest.mark.parametrize("case", sorted(FILMS))
def test_film_matches_jax_branch(case, attribute_branch):
    name, depth, spp, kw = FILMS[case]
    js, ts = SCENES[name](J), SCENES[name](T)
    assert "hit_f" not in jpath.make_scene_tables(js.build())
    assert "hit_f" not in tpath.make_scene_tables(ts.build(device="cpu"))
    _assert_films_close(_jax_film(js, depth, spp, **kw), _port_film(ts, depth, spp, **kw), depth)


def test_gate_boundary(monkeypatch):
    """num_tris equal to the threshold keeps the rows, one more drops them,
    in both packages."""
    jd = jscenes.cornell_box(8, 8).build()
    td = tscenes.cornell_box(8, 8).build(device="cpu")
    assert tpath.HIT_ROW_MAX_TRIS == jpath.HIT_ROW_MAX_TRIS == 1 << 18
    for limit, rows in ((td.num_tris, True), (td.num_tris - 1, False)):
        monkeypatch.setattr(jpath, "HIT_ROW_MAX_TRIS", limit)
        monkeypatch.setattr(tpath, "HIT_ROW_MAX_TRIS", limit)
        t_tables = tpath.make_scene_tables(td)
        assert {"hit_f", "hit_i", "hit_layout"} <= set(t_tables) if rows else \
            not {"hit_f", "hit_i", "hit_layout"} & set(t_tables)
        assert ("hit_f" in jpath.make_scene_tables(jd)) is rows
        assert set(t_tables) >= {"attr", "mat", "light", "light_tri"}


@pytest.mark.parametrize("grid,rows", [(357, True), (358, False)])
def test_terrain_across_the_threshold(grid, rows):
    """terrain_scene at grid 357 has 261,522 triangles, at grid 358
    262,952: the first is shaded from hit rows, the second not (the
    full-size terrain has 530,912, the BMW 887,604)."""
    td = tscenes.terrain_scene(grid=grid, width=4, height=4).build(device="cpu")
    assert (td.num_tris <= tpath.HIT_ROW_MAX_TRIS) is rows
    assert ("hit_f" in tpath.make_scene_tables(td)) is rows


def test_cases_reach_every_lookup():
    """The shaded scene reaches every id the hit side reads through the
    material (lobe and emission textures, a procedural, a normal map, the
    footprint), and the multi_bsdf case JAX's type-sorted dispatch, which
    the port's one dense dispatch is held against."""
    ts = shaded_scene(T)
    td = ts.build(device="cpu")
    assert td.has_textures and td.has_procedural and td.has_normal_maps
    assert tpath.cone_spread(td, tcamera.camera_to_params(ts.camera, "cpu")) is not None
    assert td.num_lights == 2  # the lamp and the sky
    md = tscenes.multi_bsdf_scene(32, 32).build(device="cpu")
    assert len(md.lobe_types_present) > 2 and 32 * 32 * FILMS["multi_bsdf_sorted"][3][
        "spp_batch"] >= 4096


def test_trace_sample_without_light_rows(attribute_branch):
    """Tables without light_tri: sample_lights reads the light triangles
    through scene.light_tris and the emission through emission_at, in
    both packages."""
    js, ts = shaded_scene(J, 16), shaded_scene(T, 16)
    jd, td = js.build(), ts.build(device="cpu")
    n = 16 * 16
    ids = np.arange(n, dtype=np.int32)
    px, py = ids % 16, ids // 16

    def jfn(scene, cam):
        tables = jpath.make_scene_tables(scene)
        del tables["light_tri"]
        return jpath.trace_sample(scene, cam, px, py, 0, jax.random.key(2), max_depth=3,
                                  tracer=jpath.make_tracer(jd, use_bvh=False), mis=True,
                                  tables=tables)

    ref = jax.jit(jfn)(jd, jcamera.camera_to_params(js.camera))
    tables = tpath.make_scene_tables(td)
    del tables["light_tri"]
    with torch.no_grad():
        got = tpath.trace_sample(td, tcamera.camera_to_params(ts.camera, "cpu"),
                                 torch.from_numpy(px).long(), torch.from_numpy(py).long(), 0, 2,
                                 max_depth=3, tracer=tpath.make_tracer(td, use_bvh=False),
                                 mis=True, tables=tables)
        full = tpath.trace_sample(td, tcamera.camera_to_params(ts.camera, "cpu"),
                                  torch.from_numpy(px).long(), torch.from_numpy(py).long(), 0,
                                  2, max_depth=3, tracer=tpath.make_tracer(td, use_bvh=False),
                                  mis=True)
    _assert_films_close({"color": np.asarray(ref[0]).reshape(16, 16, 3)},
                        {"color": got[0].numpy().reshape(16, 16, 3)}, 3)
    # the same lights and emission as through the light-triangle rows
    np.testing.assert_allclose(got[0].numpy(), full[0].numpy(), rtol=1e-6, atol=1e-7)


def _jax_grads(js, depth, spp=2, **kw):
    jd = js.build()
    w, h = js.camera.width, js.camera.height
    jcam, jtracer = jcamera.camera_to_params(js.camera), jpath.make_tracer(jd, use_bvh=False)

    def loss(params):
        out = jpath.render_pass(dataclasses.replace(jd, **params), jcam, jax.random.key(0), 0,
                                spp, width=w, height=h, max_depth=depth, tracer=jtracer,
                                sorted_dispatch=False, **kw)
        return out["color"].sum()

    return jax.jit(jax.grad(loss))({f: getattr(jd, f) for f in FIELDS})


def _port_grads(ts, depth, fields=FIELDS, spp=2, **kw):
    td = ts.build(device="cpu")
    w, h = ts.camera.width, ts.camera.height
    leaves = {f: getattr(td, f).detach().clone().requires_grad_() for f in fields}
    out = tpath.render_pass(dataclasses.replace(td, **leaves),
                            tcamera.camera_to_params(ts.camera, "cpu"), 0, 0, spp, width=w,
                            height=h, max_depth=depth,
                            tracer=tpath.make_tracer(td, use_bvh=False), **kw)
    out["color"].sum().backward()
    return {f: leaves[f].grad for f in fields}


def _sphere(m, env):
    scene = m.scenes.sphere_in_box(width=16, height=16)
    if env:
        scene.set_environment(m.Material.background((0.4, 0.5, 0.6), power=0.5, name="sky"))
    return scene


@pytest.mark.parametrize("env,depth,remat", [(False, 2, False), (True, 4, False),
                                             (True, 3, True)])
def test_grads_match_jax_branch(env, depth, remat, attribute_branch):
    """sphere_in_box 16x16 (tests/test_torch_grad.py's scene); depth 4
    reaches Russian roulette; remat recomputes each bounce in the
    backward (jax.checkpoint in JAX)."""
    ref = _jax_grads(_sphere(J, env), depth, remat=remat)
    got = _port_grads(_sphere(T, env), depth, remat=remat)
    for f in FIELDS:
        g, r = got[f].numpy(), np.asarray(ref[f])
        assert np.isfinite(g).all(), f
        scale = np.abs(r).max()
        assert scale > 0 and np.abs(g).max() > 0, f
        assert np.abs(g - r).max() <= 2e-5 * scale, (f, np.abs(g - r).max() / scale)


def test_scoped_grads_equal_full(attribute_branch):
    """JAX tests/test_grad.py:156-203 on the branch without hit rows: the
    scope rests on scope_scene alone."""
    ts = _sphere(T, False)
    pair = ("emission", "lobe_weight")
    full = _port_grads(ts, 3, pair)
    scoped = _port_grads(ts, 3, pair, trainable=pair)
    for f in pair:
        np.testing.assert_allclose(scoped[f].numpy(), full[f].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
        assert scoped[f].abs().max() > 0
    full = _port_grads(ts, 3, ("vertices",))
    scoped = _port_grads(ts, 3, ("vertices",), trainable=("vertices",))
    np.testing.assert_allclose(scoped["vertices"].numpy(), full["vertices"].numpy(),
                               rtol=1e-5, atol=1e-7)
    assert scoped["vertices"].abs().max() > 0
    cut = _port_grads(ts, 3, FIELDS, trainable=("emission",))
    assert cut["emission"].abs().max() > 0
    assert cut["lobe_weight"] is None and cut["vertices"] is None


def test_grads_of_the_two_branches_agree(monkeypatch):
    """The same values through other gathers: the port's gradients under
    the two branches within 1e-5 of each field's scale (the backward sums
    into other tables, so in another order)."""
    ts = _sphere(T, True)
    rows = _port_grads(ts, 3)
    monkeypatch.setattr(tpath, "HIT_ROW_MAX_TRIS", 0)
    attr = _port_grads(ts, 3)
    for f in FIELDS:
        scale = float(rows[f].abs().max())
        assert scale > 0, f
        assert float((attr[f] - rows[f]).abs().max()) <= 1e-5 * scale, f

"""Textured renders: the port's render_pass against the JAX package's
render_pass with the same seed, on scenes with image, procedural,
environment and emission textures, with and without MIS and anisotropic
filtering; and the pieces of the textured hit side (the footprint, the
hit rows with texture columns) on shared inputs.

The JAX side runs as its own tests run it: the brute Pallas tracer in
interpret mode, and the cluster tracer (textured_terrain_scene, above
1,024 triangles) as XLA.

Tolerances are those of tests/test_torch_render.py, for its reasons:
  * depth 1: per pixel rtol 1e-4, atol 1e-6 (the normal AOV atol 1e-5).
    The same samples hit the same triangles; only float summation order
    differs. Texture lookups are continuous in uv and in lod, so a
    last-place difference in log2, atan2 or arccos moves a value by about
    an ulp, never by a texel.
  * depth 4: at least 99% of the pixels within rtol 1e-3 (atol 1e-6), and
    the image mean and each channel mean within 1e-3 relative. Past the
    first bounce a last-place difference can flip a Russian-roulette or
    a triangle-edge decision, which changes that path's whole
    contribution.
  * _footprint: rtol 1e-5 (atol 1e-6 for the uv vector, whose components
    pass through zero): the same formulas on the same inputs.
  * hit rows: equal (gathers and exact small-int floats).
"""
import dataclasses
import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.accel.pallas_mt import (
    intersect_pallas_brute,
    occluded_pallas_brute,
)
from phosphorus_mk2_tpu.bsdf import bsdf as jbsdf
from phosphorus_mk2_tpu.core import camera as jcamera
from phosphorus_mk2_tpu.core import lights as jlights
from phosphorus_mk2_tpu.core import material as jmaterial
from phosphorus_mk2_tpu.core import mesh as jmesh
from phosphorus_mk2_tpu.core import scene as jscene
from phosphorus_mk2_tpu.core import shading as jshading
from phosphorus_mk2_tpu.core import texture as jtexture
from phosphorus_mk2_tpu.integrator import path as jpath
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh as t_attach_bvh
from phosphorus_mk2_tpu_torch.bsdf import bsdf as tbsdf
from phosphorus_mk2_tpu_torch.core import camera as tcamera
from phosphorus_mk2_tpu_torch.core import lights as tlights
from phosphorus_mk2_tpu_torch.core import material as tmaterial
from phosphorus_mk2_tpu_torch.core import mesh as tmesh
from phosphorus_mk2_tpu_torch.core import scene as tscene
from phosphorus_mk2_tpu_torch.core import shading as tshading
from phosphorus_mk2_tpu_torch.core import texture as ttexture
from phosphorus_mk2_tpu_torch.integrator import path as tpath

torch.set_num_threads(1)

PALLAS_TRACER = (
    functools.partial(intersect_pallas_brute, interpret=True),
    functools.partial(occluded_pallas_brute, interpret=True),
)
J = types.SimpleNamespace(Scene=jscene.Scene, Material=jmaterial.Material, Mesh=jmesh.Mesh,
                          Texture=jtexture.Texture, checkerboard=jtexture.checkerboard,
                          Camera=jcamera.Camera, scenes=jscenes)
T = types.SimpleNamespace(Scene=tscene.Scene, Material=tmaterial.Material, Mesh=tmesh.Mesh,
                          Texture=ttexture.Texture, checkerboard=ttexture.checkerboard,
                          Camera=tcamera.Camera, scenes=tscenes)
RES = 24


def _quad(m, a, b, c, d, mat, uv_scale=1.0):
    return m.Mesh(vertices=np.array([a, b, c, d], np.float32),
                  faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                  uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale,
                  material=mat, smooth=False)


def textured_quad(m):
    """tests/test_texture.py's textured quad, tilted so the footprint is
    anisotropic, with a finer checker (mip levels to choose from)."""
    scene = m.Scene()
    checker = scene.add_texture(m.checkerboard(n=8, size=32, a=(1, 1, 1), b=(0.1, 0.2, 0.3)))
    mat = m.Material.diffuse((1.0, 1.0, 1.0), name="tex")
    mat.lobes[0].texture = checker
    mid = scene.add_material(mat)
    scene.set_environment(m.Material.background((1.0, 1.0, 1.0), name="sky"))
    scene.add_mesh(_quad(m, [-1, -1, 0], [1, -1, 0], [1, 1, -1.5], [-1, 1, -1.5], mid, 3.0))
    scene.camera = m.Camera.look_at((0, 0, 2.5), (0, 0, 0), width=RES, height=RES)
    return scene


def env_map_scene(m):
    """A lat-long environment (a seeded image) lighting a diffuse floor."""
    scene = m.Scene()
    img = np.random.default_rng(21).uniform(0.1, 2.0, (16, 32, 3)).astype(np.float32)
    env = m.Material.background((1.0, 0.9, 0.8), name="sky")
    env.emission_texture = scene.add_texture(m.Texture(img, name="env"))
    scene.set_environment(env)
    floor = scene.add_material(m.Material.diffuse((0.7, 0.7, 0.7), name="floor"))
    scene.add_mesh(_quad(m, [-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2], floor))
    scene.camera = m.Camera.look_at((0, 1.0, 3.0), (0, 0.3, 0), width=RES, height=RES)
    return scene


def procedural_scene(m):
    """A musgrave lobe texture and a random-noise one on two quads under
    a lamp."""
    scene = m.Scene()
    mus = scene.add_texture(m.Texture.musgrave(5.0, octaves=6, lacunarity=3.0, gain=0.7))
    rnd = scene.add_texture(m.Texture.random_noise(9.0))
    mats = []
    for tid, name in ((mus, "mus"), (rnd, "rnd")):
        mat = m.Material.diffuse((0.9, 0.8, 0.7), name=name)
        mat.lobes[0].texture = tid
        mats.append(scene.add_material(mat))
    lamp = scene.add_material(m.Material.emitter((1.0, 1.0, 1.0), power=6.0, name="lamp"))
    scene.add_mesh(_quad(m, [-2, 0, 1], [0, 0, 1], [0, 0, -1], [-2, 0, -1], mats[0], 2.0))
    scene.add_mesh(_quad(m, [0, 0, 1], [2, 0, 1], [2, 0, -1], [0, 0, -1], mats[1], 2.0))
    scene.add_mesh(_quad(m, [-0.5, 2, -0.5], [0.5, 2, -0.5], [0.5, 2, 0.5], [-0.5, 2, 0.5], lamp))
    scene.camera = m.Camera.look_at((0, 2.5, 2.5), (0, 0, 0), width=RES, height=RES)
    return scene


def textured_light_scene(m):
    """An area light with an emission texture above a diffuse floor: NEE
    samples the light's texture (the light rows' texture column)."""
    scene = m.Scene()
    floor = scene.add_material(m.Material.diffuse((0.8, 0.8, 0.8), name="floor"))
    lamp = m.Material.emitter((1.0, 1.0, 1.0), power=10.0, name="lamp")
    lamp.emission_texture = scene.add_texture(
        m.checkerboard(n=2, size=16, a=(1.0, 0.2, 0.1), b=(0.1, 0.3, 1.0)))
    lid = scene.add_material(lamp)
    scene.add_mesh(_quad(m, [-3, 0, 3], [3, 0, 3], [3, 0, -3], [-3, 0, -3], floor))
    scene.add_mesh(_quad(m, [-1, 1.5, -1], [1, 1.5, -1], [1, 1.5, 1], [-1, 1.5, 1], lid))
    scene.camera = m.Camera.look_at((0, 4.0, 4.0), (0, 0, 0), width=RES, height=RES)
    return scene


def terrain(m):
    return m.scenes.textured_terrain_scene()


BUILDERS = {"quad": textured_quad, "env_map": env_map_scene, "procedural": procedural_scene,
            "textured_light": textured_light_scene, "terrain": terrain}
# case: (scene, depth, spp, mis, aniso_taps)
CASES = {
    "terrain_depth1": ("terrain", 1, 2, False, 0),
    "terrain_mis_depth1": ("terrain", 1, 2, True, 0),
    "terrain_depth4": ("terrain", 4, 4, False, 0),
    "terrain_mis_depth4": ("terrain", 4, 4, True, 0),
    "quad_depth1": ("quad", 1, 2, False, 0),
    "quad_depth4": ("quad", 4, 4, False, 0),
    "quad_aniso4_depth1": ("quad", 1, 2, False, 4),
    "quad_aniso4_depth4": ("quad", 4, 4, True, 4),
    "env_map_depth1": ("env_map", 1, 2, False, 0),
    "env_map_depth4": ("env_map", 4, 4, True, 0),
    "procedural_depth1": ("procedural", 1, 2, False, 0),
    "procedural_depth4": ("procedural", 4, 4, False, 0),
    "textured_light_depth1": ("textured_light", 1, 2, True, 0),
    "textured_light_depth4": ("textured_light", 4, 4, False, 0),
}


def _both(name, depth, spp, mis, aniso_taps, seed=1):
    js, ts = BUILDERS[name](J), BUILDERS[name](T)
    jd, td = js.build(), ts.build(device="cpu")
    assert td.has_textures and jd.has_textures
    if td.num_tris > tpath.BRUTE_MAX_TRIS:
        jd, td = j_attach_bvh(jd), t_attach_bvh(td)
        jtracer = jpath.make_tracer(jd, use_bvh=True)
        ttracer = tpath.make_tracer(td, use_bvh=True)
    else:
        jtracer, ttracer = PALLAS_TRACER, tpath.make_tracer(td, use_bvh=False)
    w, h = ts.camera.width, ts.camera.height
    strata = max(1, round(math.sqrt(spp)))
    ref = jax.jit(
        functools.partial(jpath.render_pass, width=w, height=h, max_depth=depth,
                          tracer=jtracer, film_strata=strata, mis=mis, aniso_taps=aniso_taps),
        static_argnames=("n_samples",),
    )(jd, jcamera.camera_to_params(js.camera), jax.random.key(seed), 0, spp)
    got = tpath.render_pass(td, tcamera.camera_to_params(ts.camera, "cpu"), seed, 0, spp,
                            width=w, height=h, max_depth=depth, tracer=ttracer,
                            film_strata=strata, mis=mis, aniso_taps=aniso_taps)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_pass_matches_jax(case):
    name, depth, spp, mis, taps = CASES[case]
    ref, got = _both(name, depth, spp, mis, taps)
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


def _hits(seed, data, n=256):
    """Seeded hits on the scene's triangles: ids (some -1), barycentrics,
    directions toward the triangles and path lengths."""
    rs = np.random.RandomState(seed)
    tri = rs.randint(-1, data.num_tris, n).astype(np.int32)
    u = rs.uniform(0, 0.5, n).astype(np.float32)
    v = rs.uniform(0, 0.5, n).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:3] = [[0, 0, -1], [0, -1, 0], [1, 0, 0]]  # incl. normal incidence on the floor
    t_hit = rs.uniform(0.1, 5, n).astype(np.float32)
    plen = rs.uniform(0, 3, n).astype(np.float32)
    return tri, u, v, d, t_hit, plen


@pytest.mark.parametrize("taps", [0, 1, 4])
@pytest.mark.parametrize("name", ["quad", "terrain"])
def test_footprint_matches_jax(name, taps):
    js, ts = BUILDERS[name](J), BUILDERS[name](T)
    jd, td = js.build(), ts.build(device="cpu")
    tri, u, v, d, t_hit, plen = _hits(9, td)
    jsp = jshading.shading_parameters(jd, jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v),
                                      attr=jshading.triangle_attribute_table(jd))
    tsp = tshading.shading_parameters(td, torch.from_numpy(tri), torch.from_numpy(u),
                                      torch.from_numpy(v))
    jcam = jcamera.camera_to_params(js.camera)
    spread_j = 1.12 * jnp.tan(jcam["fov"] * 0.5) / jcam["height"]
    spread_t = tpath.cone_spread(td, tcamera.camera_to_params(ts.camera, "cpu"))
    np.testing.assert_allclose(spread_t.numpy(), np.asarray(spread_j), rtol=1e-6)
    ref = jpath._footprint({"plen": jnp.asarray(plen)}, jnp.asarray(t_hit), jsp,
                           jnp.asarray(d), spread_j, taps)
    got = tpath._footprint(torch.from_numpy(plen), torch.from_numpy(t_hit), tsp,
                           torch.from_numpy(d), spread_t, taps)
    if not taps:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
        return
    assert got["taps"] == ref["taps"] == taps
    np.testing.assert_allclose(got["minor"].numpy(), np.asarray(ref["minor"]), rtol=1e-5)
    np.testing.assert_allclose(got["major_uv"].numpy(), np.asarray(ref["major_uv"]),
                               rtol=1e-5, atol=1e-6)


def test_no_footprint_without_mip_levels():
    """An untextured scene, or a one-level atlas, computes no footprint."""
    cam = tcamera.camera_to_params(tscenes.cornell_box(8, 8).camera, "cpu")
    assert tpath.cone_spread(tscenes.cornell_box(8, 8).build(device="cpu"), cam) is None
    td = textured_quad(T).build(device="cpu")
    assert tpath.cone_spread(td, cam) is not None
    assert tpath.cone_spread(dataclasses.replace(td, tex_info=td.tex_info[:, :1]), cam) is None


def _normal_mapped_terrain(m):
    scene = m.scenes.textured_terrain_scene()
    scene.materials[0].normal_texture = scene.add_texture(
        m.Texture(np.full((4, 4, 3), [0.6, 0.5, 0.9], np.float32), name="bumps"))
    lamp = scene.material("lamp")
    lamp.emission_texture = 0
    return scene


@pytest.mark.parametrize("normal_maps", [False, True])
def test_hit_rows_with_texture_columns(normal_maps):
    build = _normal_mapped_terrain if normal_maps else terrain
    jd, td = build(J).build(), build(T).build(device="cpu")
    assert td.has_normal_maps == jd.has_normal_maps == normal_maps
    jattr = jshading.triangle_attribute_table(jd)
    tattr = tshading.triangle_attribute_table(td)
    assert tattr.shape[1] == (34 if normal_maps else 25)
    np.testing.assert_array_equal(tattr.numpy(), np.asarray(jattr))
    jf, ji, jl = jbsdf.hit_row_tables(jd, jattr)
    tf, ti, tl = tbsdf.hit_row_tables(td, tattr)
    assert tl == jl
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    idx = np.random.RandomState(3).randint(0, td.num_tris, 300)
    jm, je, jlobes, jnee, jtex = jbsdf.unpack_hit_rows(jd, jf[jnp.asarray(idx)], None, jl)
    tm, te, tlobes, tnee, ttex = tbsdf.unpack_hit_rows(td, tf[torch.from_numpy(idx)], None, tl)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tnee.numpy(), np.asarray(jnee))
    for k in ("type", "weight", "param", "flags", "n"):
        np.testing.assert_array_equal(tlobes[k].numpy(), np.asarray(jlobes[k]), err_msg=k)
    assert set(ttex) == set(jtex) == ({"emission_tex", "lobe_tex"}
                                      | ({"normal_tex"} if normal_maps else set()))
    for k in jtex:
        np.testing.assert_array_equal(ttex[k].numpy(), np.asarray(jtex[k]), err_msg=k)
    # the light rows' emission-texture column
    np.testing.assert_array_equal(tlights.light_tri_table(td, tattr).numpy(),
                                  np.asarray(jlights.light_tri_table(jd, jattr)))


@pytest.mark.parametrize("footprint", ["none", "trilinear", "aniso"])
def test_apply_textures_and_emission(footprint):
    """apply_textures, emission_at, emission_from_row and env_emission_at
    on a scene with image, procedural and environment textures."""
    def build(m):
        scene = procedural_scene(m)
        env = m.Material.background((0.5, 0.6, 0.7), name="sky")
        env.emission_texture = scene.add_texture(m.checkerboard(n=4, size=16))
        scene.set_environment(env)
        scene.material("lamp").emission_texture = scene.add_texture(
            m.Texture(np.random.default_rng(2).uniform(0, 1, (8, 8, 3)).astype(np.float32)))
        return scene
    jd, td = build(J).build(), build(T).build(device="cpu")
    assert td.has_procedural and td.tex_info.shape[1] > 1
    rs = np.random.RandomState(5)
    n = 200
    mat = rs.randint(0, td.emission.shape[0], n).astype(np.int32)
    st = rs.uniform(-1, 2, (n, 2)).astype(np.float32)
    fp = (2.0 ** rs.uniform(-8, 0, n)).astype(np.float32)
    major = rs.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    jfp = tfp = None
    if footprint == "trilinear":
        jfp, tfp = jnp.asarray(fp), torch.from_numpy(fp)
    elif footprint == "aniso":
        jfp = {"minor": jnp.asarray(fp), "major_uv": jnp.asarray(major), "taps": 4}
        tfp = {"minor": torch.from_numpy(fp), "major_uv": torch.from_numpy(major), "taps": 4}
    jl = jbsdf.gather_lobes(jd, jnp.asarray(mat))
    tl = tbsdf.gather_lobes(td, torch.from_numpy(mat))
    ref = jbsdf.apply_textures(jd, jl, jnp.asarray(mat), jnp.asarray(st), footprint=jfp)
    got = tbsdf.apply_textures(td, tl, torch.from_numpy(mat), torch.from_numpy(st),
                               footprint=tfp)
    np.testing.assert_allclose(got["weight"].numpy(), np.asarray(ref["weight"]),
                               rtol=1e-5, atol=1e-6)
    je = jbsdf.emission_at(jd, jnp.asarray(mat), jnp.asarray(st), footprint=jfp)
    te = tbsdf.emission_at(td, torch.from_numpy(mat), torch.from_numpy(st), footprint=tfp)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    etex = td.emission_tex[torch.from_numpy(mat).long()]
    np.testing.assert_allclose(
        tbsdf.emission_from_row(td, td.emission[torch.from_numpy(mat).long()], etex,
                                torch.from_numpy(st), footprint=tfp).numpy(),
        np.asarray(je), rtol=1e-5, atol=1e-6)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(tbsdf.env_emission_at(td, torch.from_numpy(d)).numpy(),
                               np.asarray(jbsdf.env_emission_at(jd, jnp.asarray(d))),
                               rtol=1e-5, atol=1e-6)

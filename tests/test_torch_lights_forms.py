"""Every form of sample_lights against the JAX package's on seeded
uniforms: per-field light gathers (meta=None), the light rows gathered
(the port at every light count; the JAX package broadcast-selects them
for 1-4 lights, the same values), the light
triangles through scene.light_tris (lt_table=None) with the attribute
table or from faces and vertices, and the light-triangle rows; on scenes
with 1, 2 (an environment light), 4 and 6 lights, one lamp with an
emission texture.

Tolerance: rtol 1e-5, atol 1e-6 for p, n, pdf and st (tests/
test_torch_bsdf.py's, for its reason: the same float32 operations, a
last-place difference in a fused product); mat, valid and etex exactly.
Within the port, the forms read the same values, so they agree bit for
bit.

Without attr_w the JAX package takes the light-triangle row's width less
3 as the attribute width, which in a textured scene (these lamps) reads
the emission one column late; the port subtracts the texture column too.
So the JAX side of the "rows_default_width" form is given attr_w.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.core import lights as jlights
from phosphorus_mk2_tpu.core import material as jmaterial
from phosphorus_mk2_tpu.core import mesh as jmesh
from phosphorus_mk2_tpu.core import scene as jscene
from phosphorus_mk2_tpu.core import shading as jshading
from phosphorus_mk2_tpu.core import texture as jtexture
from phosphorus_mk2_tpu.core.camera import Camera as JCamera
from phosphorus_mk2_tpu_torch.core import lights as tlights
from phosphorus_mk2_tpu_torch.core import material as tmaterial
from phosphorus_mk2_tpu_torch.core import mesh as tmesh
from phosphorus_mk2_tpu_torch.core import scene as tscene
from phosphorus_mk2_tpu_torch.core import shading as tshading
from phosphorus_mk2_tpu_torch.core import texture as ttexture
from phosphorus_mk2_tpu_torch.core.camera import Camera as TCamera

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
N = 4096
J = (jscene, jmaterial, jmesh, jtexture, JCamera)
T = (tscene, tmaterial, tmesh, ttexture, TCamera)
# name: (area lamps, environment light)
LIGHTS = {"one": (1, False), "two": (1, True), "four": (3, True), "six": (5, True)}
# form: keywords of sample_lights beyond the uniforms (which tables to pass)
FORMS = {
    "fields_faces": (),
    "fields_attr": ("attr",),
    "meta_attr": ("attr", "meta"),
    "meta_faces": ("meta",),
    "rows": ("attr", "meta", "lt_table", "attr_w"),
    "rows_default_width": ("meta", "lt_table"),
}


def lamps_scene(mods, lamps, env):
    """A floor under a row of small tilted, smooth-shaded lamps; the first
    lamp has an emission texture."""
    scene_m, mat_m, mesh_m, tex_m, cam_m = mods
    scene = scene_m.Scene()
    checker = scene.add_texture(tex_m.checkerboard(n=2, size=8, a=(1.0, 0.2, 0.1),
                                                   b=(0.1, 0.3, 1.0)))
    floor = scene.add_material(mat_m.Material.diffuse((0.8, 0.8, 0.8), name="floor"))
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    scene.add_mesh(mesh_m.Mesh(
        vertices=np.array([[-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4]], np.float32),
        faces=quad, uvs=uvs, material=floor, smooth=False))
    for i in range(lamps):
        lamp = mat_m.Material.emitter((1.0, 0.9 - 0.1 * i, 0.8), power=5.0 + i, name=f"lamp{i}")
        if i == 0:
            lamp.emission_texture = checker
        mid = scene.add_material(lamp)
        x = -3.0 + 1.5 * i
        v = np.array([[x, 2.0, -0.5], [x + 1, 2.2, -0.5], [x + 1, 2.4, 0.5], [x, 2.2, 0.5]],
                     np.float32)
        scene.add_mesh(mesh_m.Mesh(vertices=v, faces=quad, uvs=uvs, material=mid, smooth=True))
    if env:
        scene.set_environment(mat_m.Material.background((0.2, 0.3, 0.4), name="sky"))
    scene.camera = cam_m.look_at((0, 3, 6), (0, 0, 0), width=8, height=8)
    return scene


def _tables(pkg, data, which):
    if pkg == "jax":
        attr = jshading.triangle_attribute_table(data)
        all_ = {"attr": attr, "meta": jlights.light_meta_table(data),
                "lt_table": jlights.light_tri_table(data, attr), "attr_w": attr.shape[1]}
        if "lt_table" in which:  # JAX's default width is right only without textures
            which = (*which, "attr_w")
    else:
        attr = tshading.triangle_attribute_table(data)
        all_ = {"attr": attr, "meta": tlights.light_meta_table(data),
                "lt_table": tlights.light_tri_table(data, attr), "attr_w": attr.shape[1]}
    return {k: all_[k] for k in which}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("lights", sorted(LIGHTS))
def test_sample_lights_form_matches_jax(lights, form):
    lamps, env = LIGHTS[lights]
    jd = lamps_scene(J, lamps, env).build()
    td = lamps_scene(T, lamps, env).build(device="cpu")
    assert td.num_lights == jd.num_lights == lamps + env
    u = np.random.RandomState(31).uniform(size=(3, N)).astype(np.float32)
    ref = jlights.sample_lights(jd, *map(jnp.asarray, u), **_tables("jax", jd, FORMS[form]))
    got = tlights.sample_lights(td, *map(torch.from_numpy, u), **_tables("torch", td, FORMS[form]))
    assert set(got) == set(ref)
    assert ("e" in got) is ("lt_table" in FORMS[form])
    for k in ("p", "n", "pdf", "st") + (("e",) if "e" in got else ()):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL, err_msg=k)
    for k in ("mat", "valid") + (("etex",) if "e" in got else ()):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert got["valid"].any() and (got["valid"].all() != env)
    if lamps > 1:  # every lamp drawn
        assert len(np.unique(got["mat"].numpy()[got["valid"].numpy()])) == lamps


@pytest.mark.parametrize("lights", sorted(LIGHTS))
def test_forms_agree_bit_for_bit(lights):
    """Within the port every form reads the same values: the gathered
    light rows equal the per-field gathers, the light-triangle rows equal
    the light_tris indirection."""
    lamps, env = LIGHTS[lights]
    td = lamps_scene(T, lamps, env).build(device="cpu")
    u = [torch.from_numpy(x) for x in
         np.random.RandomState(32).uniform(size=(3, N)).astype(np.float32)]
    base = tlights.sample_lights(td, *u)
    for form, which in FORMS.items():
        got = tlights.sample_lights(td, *u, **_tables("torch", td, which))
        for k in base:
            assert torch.equal(got[k], base[k]), (form, k)

"""The slice as a whole: the port's Renderer with use_bvh=True (cluster
tracer, dense and hierarchical front table) against the JAX package's
Renderer on the same scene, seed and options, at 16x16.

Tolerances are those of tests/test_torch_render.py, for its reasons:
  * depth 1: per pixel rtol 1e-4, atol 1e-6 (the same samples hit the
    same triangles; only float summation order differs), the normal AOV
    at atol 1e-5;
  * depth 2: at least 99% of the pixels within rtol 1e-3 (atol 1e-6) and
    the image and channel means within 1e-3 relative: past the first
    bounce a last-place difference can flip a triangle-edge decision,
    which changes that path's whole contribution.
"""
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.core.options import Options as JOptions
from phosphorus_mk2_tpu.integrator import path as jpath
from phosphorus_mk2_tpu.renderer import Renderer as JRenderer
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.renderer import Renderer

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

W = H = 16
FILMS = {
    # scene, JAX and port tracer_tune, path depth, spp
    "multi_bsdf_dense_depth1": ("multi_bsdf_scene", None, 1, 2),
    "multi_bsdf_hier_depth2": ("multi_bsdf_scene", {"dense_k": 1}, 2, 4),
    "terrain48_dense_depth2": ("terrain48", None, 2, 4),
    "terrain48_hier_depth1": ("terrain48", {"dense_k": 1}, 1, 2),
}


def _scene(mod, name):
    if name == "terrain48":
        return mod.terrain_scene(grid=48, width=W, height=H)
    return getattr(mod, name)(W, H)


def _films(name, tune, depth, spp):
    kw = dict(samples_per_pixel=spp, samples_per_pass=spp, path_depth=depth, seed=3,
              use_bvh=True, tracer_tune=tune)
    ref = JRenderer(_scene(jscenes, name), JOptions(**kw), n_devices=1).render()
    got = Renderer(_scene(tscenes, name), Options(**kw), device="cpu").render()
    return {k: np.asarray(v) for k, v in ref.items()}, got


def _assert_films_close(ref, got, depth):
    r, g = ref["color"], got["color"]
    assert g.shape == (H, W, 3) and np.isfinite(g).all() and r.max() > 0
    if depth == 1:
        for k in ("color", "alpha"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["normal"], ref["normal"], rtol=0, atol=1e-5)
    else:
        per_pixel = np.isclose(g, r, rtol=1e-3, atol=1e-6).all(axis=-1)
        assert per_pixel.mean() >= 0.99, per_pixel.mean()
        np.testing.assert_allclose(g.mean(), r.mean(), rtol=1e-3)
        np.testing.assert_allclose(g.mean(axis=(0, 1)), r.mean(axis=(0, 1)), rtol=1e-3)


@pytest.mark.parametrize("case", sorted(FILMS))
def test_renderer_film_matches_jax_renderer(case):
    name, tune, depth, spp = FILMS[case]
    ref, got = _films(name, tune, depth, spp)
    _assert_films_close(ref, got, depth)


def test_film_matches_jax_without_hit_rows(monkeypatch):
    """Above HIT_ROW_MAX_TRIS both packages shade from the attribute
    table and scene.tri_mat instead of consolidated hit rows. Here only
    the JAX threshold is set to 0, so its branch without rows meets the
    port's hit rows: both read the same values, so the films agree
    (tests/test_torch_shading_path.py holds the two packages' branches
    without rows against each other)."""
    monkeypatch.setattr(jpath, "HIT_ROW_MAX_TRIS", 0)
    jd = jscenes.multi_bsdf_scene(W, H).build()
    assert "hit_f" not in jpath.make_scene_tables(jd)
    ref, got = _films("terrain48", {"dense_k": 1}, 2, 4)
    _assert_films_close(ref, got, 2)

"""Built-in procedural test scenes (BASELINE.json configs 1-3 and the
large-mesh terrain that stands in for config 4, and its textured variant)."""

from phosphorus_mk2_tpu_torch.scenes.builders import (
    cornell_box,
    make_param_surface,
    make_quad,
    make_torus,
    make_uv_sphere,
    multi_bsdf_scene,
    sphere_in_box,
    terrain_scene,
    textured_terrain_scene,
)

__all__ = [
    "cornell_box",
    "make_param_surface",
    "make_quad",
    "make_torus",
    "make_uv_sphere",
    "multi_bsdf_scene",
    "sphere_in_box",
    "terrain_scene",
    "textured_terrain_scene",
]

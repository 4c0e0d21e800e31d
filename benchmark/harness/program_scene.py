"""The program's scene, made from the benchmark's arrays through the
program's scene API, as a script that builds a scene does."""
from __future__ import annotations

import numpy as np


def _material(m: dict):
    from phosphorus_mk2_tpu_torch.core.material import Material

    kind, color = m["kind"], tuple(m.get("color", (1.0, 1.0, 1.0)))
    if kind == "diffuse":
        return Material.diffuse(color, roughness=m.get("roughness", 0.0), name=m["name"])
    if kind == "glossy":
        return Material.glossy(color, roughness=m.get("roughness", 0.0), name=m["name"])
    if kind == "glass":
        return Material.glass(color, ior=m["ior"], roughness=m.get("roughness", 0.0),
                              name=m["name"])
    if kind == "emitter":
        return Material.emitter(color, power=m["power"], name=m["name"])
    if kind == "background":
        return Material.background(color, power=m["power"], name=m["name"])
    raise ValueError(f"material kind {kind!r}")


def build(cfg: dict, arrays: dict):
    """A ``phosphorus_mk2_tpu_torch`` Scene of the configuration."""
    from phosphorus_mk2_tpu_torch.core.camera import Camera
    from phosphorus_mk2_tpu_torch.core.mesh import Mesh
    from phosphorus_mk2_tpu_torch.core.scene import Scene

    scene = Scene()
    for m in cfg["materials"]:
        scene.add_material(_material(m))
    if cfg.get("background"):
        scene.set_environment(_material(cfg["background"]))
    meshes = [Mesh(vertices=m["vertices"], faces=m["faces"], normals=m["normals"],
                   uvs=m["uvs"], material=m["material"], smooth=m["smooth"], name=m["name"])
              for m in arrays["meshes"]]
    for mesh in meshes:
        scene.add_mesh(mesh)
    cam = arrays["camera"]
    scene.camera = Camera(to_world=np.asarray(cam["to_world"], np.float32),
                          focal_length=cam["focal_length"], sensor_width=cam["sensor_width"],
                          width=cam["width"], height=cam["height"])
    return scene

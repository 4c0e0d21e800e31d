"""BMW-class benchmark asset: a ~1M-triangle multi-mesh "car" archive.

The reference's headline render is the Blender BMW scene imported from
Alembic (reference README.md "Example Renders"; importer
src/codecs/scene/alembic.hpp). That archive isn't distributable here, so
this builds an asset of the same SHAPE of difficulty — multiple smooth
high-poly meshes (body, canopy, four wheels, mirrors), mixed
glossy/dielectric/diffuse materials, a ground plane and an area light —
writes it to a REAL .abc (io/alembic.write_alembic) and re-imports it
through the native Ogawa reader, so BASELINE configs 4-5 exercise the
same import -> BVH -> render path the reference uses for the BMW.

Counterpart of the repo's ``tools/bmw_asset.py`` in the port: the same
meshes, materials and camera at every ``scale``, written and read back by
the port's own Alembic code (io/alembic.py).

    python -m phosphorus_mk2_tpu_torch.tools.bmw_asset [out.abc]
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from phosphorus_mk2_tpu_torch.core.camera import Camera
from phosphorus_mk2_tpu_torch.core.material import Material
from phosphorus_mk2_tpu_torch.core.scene import Scene
from phosphorus_mk2_tpu_torch.scenes import make_param_surface, make_quad, make_torus

DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "bmw_class.abc")


def _body(n_u, n_v):
    """Rounded car-body superellipsoid: |x/a|^p + |y/b|^p + |z/c|^p = 1,
    squashed toward the ground and tapered toward the rear."""

    def f(u, v):
        th = np.pi * np.clip(v, 1e-4, 1 - 1e-4)
        ph = 2 * np.pi * u
        # superellipsoid exponent 0.4 -> boxy with rounded edges
        e = 0.55

        def spow(x, m):
            return np.sign(x) * np.abs(x) ** m

        sx = spow(np.sin(th), e) * spow(np.cos(ph), e)
        sy = spow(np.cos(th), e)
        sz = spow(np.sin(th), e) * spow(np.sin(ph), e)
        # taper: narrower + lower at the rear (x < 0)
        taper = 1.0 - 0.18 * np.clip(-sx, 0, 1)
        x = 2.15 * sx
        y = 0.62 * sy * taper + 0.55
        z = 1.05 * sz * taper
        return np.stack([x, y, z], axis=-1)

    return make_param_surface(f, n_u, n_v, material="body", name="body", wrap_u=True)


def _canopy(n_u, n_v):
    """Glass cabin: a squashed half-ellipsoid set on the body."""

    def f(u, v):
        th = 0.5 * np.pi * np.clip(v, 1e-4, 1.0)
        ph = 2 * np.pi * u
        x = 1.05 * np.sin(th) * np.cos(ph) - 0.25
        y = 0.55 * np.cos(th) + 1.05
        z = 0.78 * np.sin(th) * np.sin(ph)
        return np.stack([x, y, z], axis=-1)

    return make_param_surface(
        f, n_u, n_v, material="glass", name="canopy", wrap_u=True
    )


def build_meshes(scale: float = 1.0):
    """All meshes of the asset (~1M tris at scale=1)."""
    s = max(0.05, scale)

    def n(base):
        return max(8, int(base * np.sqrt(s)))

    meshes = [
        _body(n(700), n(350)),
        _canopy(n(340), n(170)),
    ]
    for i, (wx, wz) in enumerate([(1.3, 1.05), (1.3, -1.05), (-1.3, 1.05), (-1.3, -1.05)]):
        meshes.append(
            make_torus(
                (wx, 0.42, wz), 0.42, 0.16, n_u=n(230), n_v=n(115),
                material="tire", name=f"wheel{i}", axis="x",
            )
        )
        meshes.append(
            make_torus(
                (wx, 0.42, wz * 1.02), 0.21, 0.07, n_u=n(120), n_v=n(60),
                material="hub", name=f"hub{i}",
                axis="x",
            )
        )
    for i, zm in enumerate((1.0, -1.0)):
        meshes.append(
            make_torus(
                (0.85, 1.15, zm * 0.95), 0.09, 0.035, n_u=n(80), n_v=n(40),
                material="hub", name=f"mirror{i}", axis="z",
            )
        )
    meshes.append(
        make_quad(
            [-12, 0, 12], [12, 0, 12], [12, 0, -12], [-12, 0, -12],
            material="ground", name="ground",
        )
    )
    meshes.append(
        make_quad(
            # area light panel above, facing down
            [-2.5, 4.2, 2.0], [-2.5, 4.2, -2.0], [2.5, 4.2, -2.0], [2.5, 4.2, 2.0],
            material="lamp", name="lamp",
        )
    )
    return meshes


def add_materials(scene: Scene) -> None:
    scene.add_material(Material.glossy((0.55, 0.05, 0.04), roughness=0.25, name="body"))
    scene.add_material(Material.glass((0.9, 0.95, 0.9), ior=1.45, name="glass"))
    scene.add_material(Material.diffuse((0.04, 0.04, 0.045), roughness=0.6, name="tire"))
    scene.add_material(Material.glossy((0.8, 0.8, 0.85), roughness=0.12, name="hub"))
    scene.add_material(Material.diffuse((0.45, 0.45, 0.48), name="ground"))
    scene.add_material(Material.emitter((1.0, 0.96, 0.9), power=14.0, name="lamp"))
    scene.set_environment(Material.background((0.35, 0.45, 0.6), power=0.35))


def make_camera(width=1024, height=1024, eye=(4.6, 2.3, 4.8),
                target=(0.0, 0.7, 0.0)) -> Camera:
    to_world = np.eye(4, dtype=np.float32)
    eye = np.array(eye, np.float32)
    target = np.array(target, np.float32)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    to_world[0, :3] = right
    to_world[1, :3] = up
    to_world[2, :3] = -fwd  # camera looks down -Z
    to_world[3, :3] = eye
    return Camera(
        to_world=to_world, focal_length=40.0, sensor_width=36.0,
        width=width, height=height,
    )


def write_asset(path: str = DEFAULT_PATH, scale: float = 1.0) -> str:
    from phosphorus_mk2_tpu_torch.io.alembic import write_alembic

    meshes = build_meshes(scale)
    write_alembic(path, meshes)
    n_tris = sum(m.faces.shape[0] for m in meshes)
    print(f"wrote {path}: {len(meshes)} meshes, {n_tris} tris,"
          f" {os.path.getsize(path)/1e6:.1f} MB", flush=True)
    return path


def load_scene(path: str, width=1024, height=1024) -> Scene:
    """Import the archive through the native Ogawa reader + bind
    materials by face-set name (the reference importer's binding path,
    alembic.hpp:156-257)."""
    from phosphorus_mk2_tpu_torch.io.alembic import import_alembic

    scene = Scene()
    add_materials(scene)
    import_alembic(path, scene)
    scene.camera = make_camera(width, height)
    return scene


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_PATH
    write_asset(out)
    sc = load_scene(out, 64, 64)
    n = sum(m.faces.shape[0] for m in sc.meshes)
    print(f"re-imported: {len(sc.meshes)} meshes, {n} tris", flush=True)

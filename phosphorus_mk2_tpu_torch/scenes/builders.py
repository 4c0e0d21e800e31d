"""Procedural scene builders for the benchmark configurations.

Counterpart of ``phosphorus_mk2_tpu/scenes/builders.py`` (host-side
numpy, the same geometry bit for bit). These realize BASELINE.json's
matched scenes without external assets:
  1. diffuse sphere in a box (direct lighting, 128x128)
  2. Cornell box (2-bounce PT + NEE, 256x256)
  3. multi-mesh glossy/dielectric scene (512x512)
and ``terrain_scene``, the large-mesh scene that stands in for config 4,
with ``textured_terrain_scene`` its textured variant.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from phosphorus_mk2_tpu_torch.core.camera import Camera
from phosphorus_mk2_tpu_torch.core.material import Material
from phosphorus_mk2_tpu_torch.core.mesh import Mesh
from phosphorus_mk2_tpu_torch.core.scene import Scene
from phosphorus_mk2_tpu_torch.core.texture import checkerboard


def make_quad(a, b, c, d, material=None, name="quad") -> Mesh:
    """Quad from 4 corners (counter-clockwise as seen against the normal)."""
    verts = np.array([a, b, c, d], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return Mesh(vertices=verts, faces=faces, material=material, smooth=False, name=name)


def make_param_surface(
    f, n_u: int, n_v: int, material=None, name="surface",
    wrap_u: bool = False, wrap_v: bool = False,
) -> Mesh:
    """Triangulated parametric surface (vectorized) with analytic-ish
    per-vertex normals from the parameter-space tangents and uv coords.

    f: (U, V) meshgrid arrays in [0,1] -> (..., 3) positions.
    wrap_u/wrap_v: close the seam (torus/cylinder topologies).
    """
    nu = n_u if wrap_u else n_u + 1
    nv = n_v if wrap_v else n_v + 1
    uu = (np.arange(nu, dtype=np.float64) / n_u)[:, None] * np.ones((1, nv))
    vv = np.ones((nu, 1)) * (np.arange(nv, dtype=np.float64) / n_v)[None, :]
    pos = np.asarray(f(uu, vv), np.float64)  # (nu, nv, 3)

    eps = 1e-4
    du = (np.asarray(f(uu + eps, vv)) - np.asarray(f(uu - eps, vv))) / (2 * eps)
    dv = (np.asarray(f(uu, vv + eps)) - np.asarray(f(uu, vv - eps))) / (2 * eps)
    nrm = np.cross(du, dv)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-12)

    verts = pos.reshape(-1, 3).astype(np.float32)
    normals = nrm.reshape(-1, 3).astype(np.float32)
    uvs = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)

    iu = np.arange(n_u)
    iv = np.arange(n_v)
    i0 = (iu[:, None] % nu) * nv + (iv[None, :] % nv)
    i1 = ((iu[:, None] + 1) % nu) * nv + (iv[None, :] % nv)
    i2 = (iu[:, None] % nu) * nv + ((iv[None, :] + 1) % nv)
    i3 = ((iu[:, None] + 1) % nu) * nv + ((iv[None, :] + 1) % nv)
    fa = np.stack([i0, i1, i2], axis=-1).reshape(-1, 3)
    fb = np.stack([i2, i1, i3], axis=-1).reshape(-1, 3)
    faces = np.concatenate([fa, fb], axis=0).astype(np.int32)
    # drop degenerate tris (poles of squashed spheres etc.)
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area2 = np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    faces = faces[area2 > 1e-12]
    return Mesh(
        vertices=verts, faces=faces, normals=normals, uvs=uvs,
        material=material, smooth=True, name=name,
    )


def make_torus(
    center, major: float, minor: float, n_u=64, n_v=32,
    material=None, name="torus", axis: str = "y",
) -> Mesh:
    """Torus around `axis` through center (smooth, uv-mapped)."""
    cx, cy, cz = center

    def f(u, v):
        a = 2 * np.pi * u
        b = 2 * np.pi * v
        r = major + minor * np.cos(b)
        if axis == "y":
            x, y, z = r * np.cos(a), minor * np.sin(b), r * np.sin(a)
        elif axis == "x":
            y, z, x = r * np.cos(a), r * np.sin(a), minor * np.sin(b)
        else:
            x, y, z = r * np.cos(a), r * np.sin(a), minor * np.sin(b)
        return np.stack([cx + x, cy + y, cz + z], axis=-1)

    return make_param_surface(
        f, n_u, n_v, material=material, name=name, wrap_u=True, wrap_v=True
    )


def make_uv_sphere(center, radius, n_theta=16, n_phi=32, material=None, name="sphere") -> Mesh:
    """UV sphere with per-vertex normals (smooth shaded)."""
    cx, cy, cz = center
    verts = []
    normals = []
    for i in range(n_theta + 1):
        theta = np.pi * i / n_theta
        for j in range(n_phi):
            phi = 2.0 * np.pi * j / n_phi
            n = np.array(
                [
                    np.sin(theta) * np.cos(phi),
                    np.cos(theta),
                    np.sin(theta) * np.sin(phi),
                ]
            )
            normals.append(n)
            verts.append(np.array([cx, cy, cz]) + radius * n)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            v00 = i * n_phi + j
            v01 = i * n_phi + j2
            v10 = (i + 1) * n_phi + j
            v11 = (i + 1) * n_phi + j2
            if i > 0:
                faces.append([v00, v01, v10])
            if i < n_theta - 1:
                faces.append([v01, v11, v10])
    return Mesh(
        vertices=np.array(verts, np.float32),
        faces=np.array(faces, np.int32),
        normals=np.array(normals, np.float32),
        material=material,
        smooth=True,
        name=name,
    )


def _box_walls(scene: Scene, size: float, mats: dict):
    """Interior of a box [-s, s]^3 with the opening toward +z camera."""
    s = size
    # floor (y = -s, normal +y)
    scene.add_mesh(
        make_quad([-s, -s, s], [s, -s, s], [s, -s, -s], [-s, -s, -s], mats["white"], "floor")
    )
    # ceiling (y = +s, normal -y)
    scene.add_mesh(
        make_quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s], mats["white"], "ceiling")
    )
    # back wall (z = -s, normal +z)
    scene.add_mesh(
        make_quad([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], mats["white"], "back")
    )
    # left wall (x = -s, normal +x) — red
    scene.add_mesh(
        make_quad([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s], mats["red"], "left")
    )
    # right wall (x = +s, normal -x) — green
    scene.add_mesh(
        make_quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s], mats["green"], "right")
    )


def _add_top_light(scene: Scene, size: float, mat, frac=0.4):
    s = size * frac
    y = size * 0.999
    scene.add_mesh(
        make_quad([-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s], mat, "light")
    )


def _front_camera(size: float, width: int, height: int) -> Camera:
    return Camera.look_at(
        position=(0.0, 0.0, size * 3.4),
        target=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0),
        width=width,
        height=height,
    )


def sphere_in_box(width=128, height=128) -> Scene:
    """BASELINE config 1: diffuse sphere in a box, direct lighting."""
    scene = Scene()
    mats = {
        "white": scene.add_material(Material.diffuse((0.73, 0.73, 0.73), name="white")),
        "red": scene.add_material(Material.diffuse((0.61, 0.06, 0.06), name="red")),
        "green": scene.add_material(Material.diffuse((0.12, 0.45, 0.15), name="green")),
    }
    emit = scene.add_material(Material.emitter((1.0, 0.96, 0.88), power=40.0, name="lamp"))
    _box_walls(scene, 1.0, mats)
    _add_top_light(scene, 1.0, emit)
    scene.add_mesh(make_uv_sphere((0.0, -0.5, 0.0), 0.45, material=mats["white"]))
    scene.camera = _front_camera(1.0, width, height)
    return scene


def cornell_box(width=256, height=256) -> Scene:
    """BASELINE config 2: Cornell box with two diffuse boxes."""
    scene = Scene()
    mats = {
        "white": scene.add_material(Material.diffuse((0.73, 0.73, 0.73), name="white")),
        "red": scene.add_material(Material.diffuse((0.61, 0.06, 0.06), name="red")),
        "green": scene.add_material(Material.diffuse((0.12, 0.45, 0.15), name="green")),
    }
    emit = scene.add_material(Material.emitter((1.0, 0.84, 0.67), power=60.0, name="lamp"))
    _box_walls(scene, 1.0, mats)
    _add_top_light(scene, 1.0, emit, frac=0.3)

    def add_box(center, half, yaw, mat):
        cx, cy, cz = center
        hx, hy, hz = half
        corners = []
        for dy in (-hy, hy):
            for dx, dz in ((-hx, -hz), (hx, -hz), (hx, hz), (-hx, hz)):
                x = dx * np.cos(yaw) - dz * np.sin(yaw)
                z = dx * np.sin(yaw) + dz * np.cos(yaw)
                corners.append([cx + x, cy + dy, cz + z])
        v = np.array(corners, np.float32)
        quads = [
            (0, 3, 2, 1),  # bottom
            (4, 5, 6, 7),  # top
            (0, 1, 5, 4),
            (1, 2, 6, 5),
            (2, 3, 7, 6),
            (3, 0, 4, 7),
        ]
        faces = []
        for q in quads:
            faces.append([q[0], q[1], q[2]])
            faces.append([q[0], q[2], q[3]])
        faces = np.array(faces, np.int32)
        # orient every face outward (flat-shaded geometric normals drive
        # the lighting; inward normals would kill NEE like the reference,
        # which never flips backfacing normals — mesh.cpp:209-215)
        ctr = np.array(center, np.float32)
        for i, (a, b, c) in enumerate(faces):
            n = np.cross(v[b] - v[a], v[c] - v[a])
            if np.dot(n, (v[a] + v[b] + v[c]) / 3.0 - ctr) < 0:
                faces[i] = [a, c, b]
        scene.add_mesh(
            Mesh(vertices=v, faces=faces, material=mat, smooth=False)
        )

    add_box((-0.33, -0.4, -0.3), (0.28, 0.6, 0.28), np.deg2rad(18), mats["white"])
    add_box((0.35, -0.7, 0.28), (0.28, 0.3, 0.28), np.deg2rad(-17), mats["white"])
    scene.camera = _front_camera(1.0, width, height)
    return scene


def multi_bsdf_scene(width=512, height=512) -> Scene:
    """BASELINE config 3: multiple meshes with glossy/dielectric BSDFs."""
    scene = Scene()
    mats = {
        "white": scene.add_material(Material.diffuse((0.73, 0.73, 0.73), name="white")),
        "red": scene.add_material(Material.diffuse((0.61, 0.06, 0.06), name="red")),
        "green": scene.add_material(Material.diffuse((0.12, 0.45, 0.15), name="green")),
    }
    emit = scene.add_material(Material.emitter((1.0, 0.92, 0.80), power=50.0, name="lamp"))
    glossy = scene.add_material(Material.glossy((0.95, 0.93, 0.88), roughness=0.2, name="glossy"))
    mirror = scene.add_material(Material.glossy((0.98, 0.98, 0.98), roughness=0.0, name="mirror"))
    glass = scene.add_material(Material.glass((1.0, 1.0, 1.0), ior=1.45, name="glass"))
    sheen = scene.add_material(Material.sheen((0.9, 0.4, 0.7), roughness=0.4, name="sheen"))
    rough_diffuse = scene.add_material(
        Material.diffuse((0.5, 0.5, 0.8), roughness=30.0, name="oren")
    )

    _box_walls(scene, 1.0, mats)
    _add_top_light(scene, 1.0, emit, frac=0.35)
    scene.add_mesh(make_uv_sphere((-0.55, -0.65, -0.25), 0.33, material=glossy))
    scene.add_mesh(make_uv_sphere((0.0, -0.62, 0.25), 0.36, material=glass))
    scene.add_mesh(make_uv_sphere((0.58, -0.68, -0.3), 0.3, material=mirror))
    scene.add_mesh(make_uv_sphere((-0.1, -0.8, 0.75), 0.18, material=sheen))
    scene.add_mesh(make_uv_sphere((0.5, -0.84, 0.62), 0.15, material=rough_diffuse))
    scene.camera = _front_camera(1.0, width, height)
    return scene


def terrain_scene(grid: int = 512, width=256, height=256, seed: int = 7) -> Scene:
    """Large-mesh benchmark scene: a value-noise displaced terrain grid
    (2*grid^2 triangles: grid=707 gives ~1M) under a sky light, with a
    few glossy spheres. Stands in for the BMW-scale Alembic asset
    (BASELINE config 4) in an environment without Alembic."""
    rng = np.random.default_rng(seed)
    scene = Scene()
    ground = scene.add_material(Material.diffuse((0.45, 0.4, 0.35), name="ground"))
    glossy = scene.add_material(Material.glossy((0.9, 0.9, 0.95), roughness=0.15, name="g"))
    scene.set_environment(Material.background((0.7, 0.8, 1.0), power=1.2, name="sky"))

    # fractal height field
    n = grid + 1
    xs = np.linspace(-4, 4, n, dtype=np.float32)
    zs = np.linspace(-4, 4, n, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    h = np.zeros((n, n), np.float32)
    amp, freq = 1.0, 1.0
    for o in range(6):
        phase = rng.uniform(0, 2 * np.pi, 4)
        h += amp * (
            np.sin(freq * xx * 1.7 + phase[0]) * np.cos(freq * zz * 1.3 + phase[1])
            + 0.5 * np.sin(freq * (xx + zz) * 0.9 + phase[2])
        )
        amp *= 0.45
        freq *= 2.1
    h = (h * 0.25 - 1.0).astype(np.float32)

    verts = np.stack([xx, h, zz], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    v00 = (i * n + j).reshape(-1)
    v10 = ((i + 1) * n + j).reshape(-1)
    v01 = (i * n + j + 1).reshape(-1)
    v11 = ((i + 1) * n + j + 1).reshape(-1)
    faces = np.concatenate(
        [
            np.stack([v00, v10, v11], axis=-1),
            np.stack([v00, v11, v01], axis=-1),
        ]
    ).astype(np.int32)
    scene.add_mesh(
        Mesh(vertices=verts, faces=faces, material=ground, smooth=True, name="terrain")
    )
    for k in range(3):
        scene.add_mesh(
            make_uv_sphere(
                (-1.5 + 1.5 * k, 0.1 + 0.2 * k, -0.5 + 0.4 * k),
                0.35,
                n_theta=24,
                n_phi=48,
                material=glossy,
            )
        )
    scene.camera = Camera.look_at(
        (0.0, 1.2, 4.5), (0.0, -0.4, 0.0), width=width, height=height
    )
    return scene


def textured_terrain_scene(grid: int = 24, width=24, height=24) -> Scene:
    """Terrain variant with a checker texture on the ground and an area
    light: the smallest scene that exercises the full production render
    path — cluster BVH traversal, texture atlas gathers, NEE/MIS against
    area and infinite lights."""
    scene = terrain_scene(grid=grid, width=width, height=height)
    terrain = scene.meshes[0]
    v = terrain.vertices
    terrain.uvs = np.stack(
        [(v[:, 0] + 4.0) / 8.0, (v[:, 2] + 4.0) / 8.0], axis=-1
    ).astype(np.float32)  # planar map over the [-4,4]^2 grid
    tex = scene.add_texture(checkerboard(n=4, size=16, a=(1.0, 0.9, 0.8),
                                         b=(0.2, 0.25, 0.3)))
    ground = scene.materials[0]  # "ground" diffuse
    scene.materials[0] = dataclasses.replace(
        ground, lobes=[dataclasses.replace(ground.lobes[0], texture=tex)]
    )
    lamp = scene.add_material(
        Material.emitter((1.0, 0.9, 0.7), power=40.0, name="lamp")
    )
    scene.add_mesh(
        make_quad(
            (-0.6, 2.2, -0.6), (0.6, 2.2, -0.6), (0.6, 2.2, 0.6),
            (-0.6, 2.2, 0.6), material=lamp, name="lamp_quad",
        )
    )
    return scene

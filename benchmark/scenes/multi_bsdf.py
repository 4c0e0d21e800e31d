"""The multi-mesh glossy and glass scene (BASELINE config 3): the walls of a
box of side 2 open toward the camera (white, red left, green right), a
ceiling lamp at 0.35 of the width, and five smooth UV spheres of 16 x 32
facets (960 triangles each) in glossy, glass, mirror, sheen and
Oren-Nayar materials; 4,812 triangles."""
from __future__ import annotations

import numpy as np

from .geometry import look_at, quad

# (centre, radius, material) of each sphere, in the order they are added
SPHERES = (
    ((-0.55, -0.65, -0.25), 0.33, "glossy"),
    ((0.0, -0.62, 0.25), 0.36, "glass"),
    ((0.58, -0.68, -0.3), 0.3, "mirror"),
    ((-0.1, -0.8, 0.75), 0.18, "sheen"),
    ((0.5, -0.84, 0.62), 0.15, "oren"),
)


def uv_sphere(center, radius, material, n_theta=16, n_phi=32):
    """A sphere of rings by latitude, its vertex normals the unit radii
    (smooth-shaded); a cap ring's degenerate half of each quad left out.
    Each vertex is computed one at a time in float64, then stored float32."""
    cx, cy, cz = center
    verts, normals = [], []
    for i in range(n_theta + 1):
        theta = np.pi * i / n_theta
        for j in range(n_phi):
            phi = 2.0 * np.pi * j / n_phi
            n = np.array([np.sin(theta) * np.cos(phi), np.cos(theta),
                          np.sin(theta) * np.sin(phi)])
            normals.append(n)
            verts.append(np.array([cx, cy, cz]) + radius * n)
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            v00, v01 = i * n_phi + j, i * n_phi + j2
            v10, v11 = (i + 1) * n_phi + j, (i + 1) * n_phi + j2
            if i > 0:
                faces.append([v00, v01, v10])
            if i < n_theta - 1:
                faces.append([v01, v11, v10])
    return {"name": "sphere", "vertices": np.array(verts, np.float32),
            "faces": np.array(faces, np.int32), "normals": np.array(normals, np.float32),
            "uvs": None, "smooth": True, "material": material}


def build(width: int, height: int, scale: float = 1.0) -> dict:
    del scale  # the scene has one size
    s, ls, y = 1.0, 0.35, 0.999
    meshes = [
        quad([-s, -s, s], [s, -s, s], [s, -s, -s], [-s, -s, -s], "white", "floor"),
        quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s], "white", "ceiling"),
        quad([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], "white", "back"),
        quad([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s], "red", "left"),
        quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s], "green", "right"),
        quad([-ls, y, -ls], [ls, y, -ls], [ls, y, ls], [-ls, y, ls], "lamp", "light"),
    ]
    meshes += [uv_sphere(c, r, m) for c, r, m in SPHERES]
    return {"meshes": meshes,
            "camera": look_at((0.0, 0.0, 3.4), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), width, height)}

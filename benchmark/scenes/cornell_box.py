"""The Cornell box (Cornell Program of Computer Graphics): a unit box open
toward the camera, red left and green right walls, a ceiling lamp at 0.3 of
the width and two rotated white boxes; 36 triangles, flat-shaded."""
from __future__ import annotations

import numpy as np

from .geometry import look_at, quad


def _box(center, half, yaw, material, name):
    cx, cy, cz = center
    hx, hy, hz = half
    corners = []
    for dy in (-hy, hy):
        for dx, dz in ((-hx, -hz), (hx, -hz), (hx, hz), (-hx, hz)):
            x = dx * np.cos(yaw) - dz * np.sin(yaw)
            z = dx * np.sin(yaw) + dz * np.cos(yaw)
            corners.append([cx + x, cy + dy, cz + z])
    v = np.array(corners, np.float32)
    faces = []
    for q in ((0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)):
        faces += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
    faces = np.array(faces, np.int32)
    ctr = np.array(center, np.float32)
    for i, (a, b, c) in enumerate(faces):  # every face outward
        n = np.cross(v[b] - v[a], v[c] - v[a])
        if np.dot(n, (v[a] + v[b] + v[c]) / 3.0 - ctr) < 0:
            faces[i] = [a, c, b]
    return {"name": name, "vertices": v, "faces": faces, "normals": None, "uvs": None,
            "smooth": False, "material": material}


def build(width: int, height: int, scale: float = 1.0) -> dict:
    del scale  # the box has one size
    s, ls, y = 1.0, 0.3, 0.999
    meshes = [
        quad([-s, -s, s], [s, -s, s], [s, -s, -s], [-s, -s, -s], "white", "floor"),
        quad([-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s], "white", "ceiling"),
        quad([-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s], "white", "back"),
        quad([-s, -s, s], [-s, -s, -s], [-s, s, -s], [-s, s, s], "red", "left"),
        quad([s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s], "green", "right"),
        quad([-ls, y, -ls], [ls, y, -ls], [ls, y, ls], [-ls, y, ls], "lamp", "light"),
        _box((-0.33, -0.4, -0.3), (0.28, 0.6, 0.28), np.deg2rad(18), "white", "tall"),
        _box((0.35, -0.7, 0.28), (0.28, 0.3, 0.28), np.deg2rad(-17), "white", "short"),
    ]
    return {"meshes": meshes,
            "camera": look_at((0.0, 0.0, 3.4), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), width, height)}

"""Mesh generators shared by the benchmark's scenes, in NumPy.

A mesh is a dict: name, vertices (V, 3) float32, faces (F, 3) int32,
normals (V, 3) float32 or None, uvs (V, 2) float32 or None, smooth (bool)
and material (the name of a material of the configuration file).
"""
from __future__ import annotations

import numpy as np


def quad(a, b, c, d, material, name):
    """Two triangles from four corners, counter-clockwise against the normal."""
    return {"name": name, "vertices": np.array([a, b, c, d], np.float32),
            "faces": np.array([[0, 1, 2], [0, 2, 3]], np.int32), "normals": None,
            "uvs": None, "smooth": False, "material": material}


def look_at(position, target, up, width, height, focal_length=35.0, sensor_width=36.0):
    """A pinhole camera dict: row-vector to_world (camera looks down -z)."""
    position = np.asarray(position, np.float32)
    fwd = np.asarray(target, np.float32) - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3], m[3, :3] = right, np.cross(right, fwd), -fwd, position
    return {"to_world": m, "focal_length": float(focal_length),
            "sensor_width": float(sensor_width), "width": int(width), "height": int(height)}

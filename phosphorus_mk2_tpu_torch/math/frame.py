"""Orthonormal tangent frames and y-up tangent-space trigonometry.

Counterpart of ``phosphorus_mk2_tpu/math/frame.py`` (reference
src/math/orthogonal_base.hpp and src/math/vector.hpp:24-72). A frame is
a tuple of three ``(..., 3)`` world-space basis vectors ``(a, b, c)``
with ``b == n``; the shading normal maps to the local +Y axis.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.math.vec import clip, cross, dot, maximum, normalize, safe_sqrt


def make_frame(n: torch.Tensor):
    """Orthonormal frame from a normal, with the reference's fallback
    when n.x == n.y == n.z."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    degenerate = (nx == ny) & (nx == nz)
    ax = nz - ny
    ay = torch.where(degenerate, nx + nz, nx - nz)
    az = torch.where(degenerate, -ny - nx, ny - nx)
    a = normalize(torch.stack([ax, ay, az], dim=-1))
    c = normalize(cross(a, n))
    return a, n, c


def make_frame_with_tangent(t: torch.Tensor, n: torch.Tensor):
    """Frame from an explicit tangent (reference orthogonal_base_t(tangent,
    n)): (normalize(t x n), normalize(n), t). The reference calls
    ``invertible_base_t(n, t)`` from ``mesh_t::shading_parameters``
    (src/mesh.cpp:232), normal first; this keeps the constructor's
    (tangent, normal) order, as the JAX package does."""
    return normalize(cross(t, n)), normalize(n), t


def to_world(frame, v: torch.Tensor) -> torch.Tensor:
    a, b, c = frame
    return v[..., 0:1] * a + v[..., 1:2] * b + v[..., 2:3] * c


def to_local(frame, v: torch.Tensor) -> torch.Tensor:
    a, b, c = frame
    return torch.stack([dot(v, a), dot(v, b), dot(v, c)], dim=-1)


def ts_in_same_hemisphere(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 1] * b[..., 1]) > 0.0


def cos_theta(v: torch.Tensor) -> torch.Tensor:
    return v[..., 1]


def cos2_theta(v: torch.Tensor) -> torch.Tensor:
    return v[..., 1] * v[..., 1]


def sin2_theta(v: torch.Tensor) -> torch.Tensor:
    return maximum(1.0 - cos2_theta(v), 0.0)


def sin_theta(v: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(1.0 - cos2_theta(v))


def tan_theta(v: torch.Tensor) -> torch.Tensor:
    return sin_theta(v) / v[..., 1]


def tan2_theta(v: torch.Tensor) -> torch.Tensor:
    # inf where cos2 == 0; callers mask it like the reference's isinf checks
    return sin2_theta(v) / cos2_theta(v)


def cos_phi(v: torch.Tensor) -> torch.Tensor:
    s = sin_theta(v)
    zero = s == 0.0
    return torch.where(
        zero, 1.0, clip(v[..., 0] / torch.where(zero, 1.0, s), -1.0, 1.0)
    )


def sin_phi(v: torch.Tensor) -> torch.Tensor:
    s = sin_theta(v)
    zero = s == 0.0
    return torch.where(
        zero, 0.0, clip(v[..., 2] / torch.where(zero, 1.0, s), -1.0, 1.0)
    )


def cos2_phi(v: torch.Tensor) -> torch.Tensor:
    x = cos_phi(v)
    return x * x


def sin2_phi(v: torch.Tensor) -> torch.Tensor:
    x = sin_phi(v)
    return x * x

"""Sampling warps with the reference's conventions and quirks.

Counterpart of ``phosphorus_mk2_tpu/math/sampling.py`` (reference
src/math/sampling.hpp): a **y-up** hemisphere, ``uniform_hemisphere``
reporting pdf = 1/pi, and ``concentric_disc`` warping the raw sample
instead of the centred offset (positive quadrant only).

All functions take uniform samples ``u`` of shape ``(..., 2)``.
"""
from __future__ import annotations

import math

import torch

from phosphorus_mk2_tpu_torch.device import resolve_device
from phosphorus_mk2_tpu_torch.math import rng
from phosphorus_mk2_tpu_torch.math.vec import maximum, minimum

UNIFORM_DISC_PDF = 1.0 / math.pi
ONE_MINUS_EPS = 1.0 - 2.0 ** -23  # float32(1) - finfo(float32).eps


def uniform_hemisphere(u: torch.Tensor):
    """y-up uniform hemisphere warp; pdf replicates the reference's 1/pi."""
    u1, u2 = u[..., 0], u[..., 1]
    r = torch.sqrt(maximum(1.0 - u1 * u1, 0.0))
    phi = 2.0 * math.pi * u2
    out = torch.stack([torch.cos(phi) * r, u1, torch.sin(phi) * r], dim=-1)
    pdf = torch.full_like(u1, UNIFORM_DISC_PDF)
    return out, pdf


def cosine_hemisphere(u: torch.Tensor):
    """y-up cosine-weighted hemisphere warp; pdf = cos(theta)/pi."""
    u1, u2 = u[..., 0], u[..., 1]
    r = torch.sqrt(u1)
    theta = 2.0 * math.pi * u2
    x = r * torch.cos(theta)
    z = r * torch.sin(theta)
    y = torch.sqrt(maximum(1.0 - u1, 0.0))
    return torch.stack([x, y, z], dim=-1), y * UNIFORM_DISC_PDF


def concentric_disc(u: torch.Tensor) -> torch.Tensor:
    """Concentric disc warp of the raw sample (reference quirk)."""
    sx, sy = u[..., 0], u[..., 1]
    pi_o_2 = 2.0 / math.pi
    pi_o_4 = 4.0 / math.pi
    use_x = sx.abs() > sy.abs()
    safe_sx = torch.where(sx == 0.0, 1.0, sx)
    safe_sy = torch.where(sy == 0.0, 1.0, sy)
    r = torch.where(use_x, sx, sy)
    theta = torch.where(
        use_x, pi_o_4 * (sy / safe_sx), pi_o_2 - pi_o_4 * (sx / safe_sy)
    )
    return r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def triangle_sample(u: torch.Tensor) -> torch.Tensor:
    """Unit square -> barycentric (u, v) by the sqrt warp
    (reference triangle_t::sample, src/mesh.cpp:318-324)."""
    x = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - x, u[..., 1] * x], dim=-1)


STRATIFIED_PURPOSE = 3  # the RNG purpose word of stratified_2d (0-2: camera, light, BSDF)


def stratify(u: torch.Tensor, n: int) -> torch.Tensor:
    """(n*n, 2) points, cell (i, j) of an n x n grid (row-major, i the
    first coordinate) offset by its row of u (n*n, 2) in [0, 1) scaled to
    the cell: the JAX package's ``ij * step + jitter``."""
    step = 1.0 / n
    i, j = torch.meshgrid(torch.arange(n, device=u.device), torch.arange(n, device=u.device),
                          indexing="ij")
    ij = torch.stack([i, j], dim=-1).reshape(n * n, 2)
    return ij * step + u * step


def stratified_2d(seed: int, n: int, device="cuda") -> torch.Tensor:
    """(n*n, 2) stratified jittered samples over the unit square
    (reference sample::stratified_2d, src/math/sampling.hpp:65-78). The
    jitter is the port's counter-based RNG under an integer seed, where
    the JAX package draws it from a ``jax.random`` key: the layout and the
    strata are the same, the random bits are not."""
    dev = resolve_device(device)
    cells = torch.arange(n * n, dtype=torch.int64, device=dev)
    u = rng.pixel_uniforms4(seed, cells, 0, 0, STRATIFIED_PURPOSE)[:, :2]
    return stratify(u, n)


def remap_index_sample(u: torch.Tensor, count):
    """Split one uniform into (index, remapped uniform) — the reference's
    idiom for lobe and light-triangle selection. ``count`` is an int or a
    tensor of positive ints broadcastable with ``u``."""
    if isinstance(count, torch.Tensor):
        count_f = count.to(u.dtype)
    else:
        count_f = torch.tensor(float(count), dtype=u.dtype, device=u.device)
    idx = torch.minimum(torch.floor(u * count_f), count_f - 1.0)
    remapped = minimum(u * count_f - idx, ONE_MINUS_EPS)
    return idx.to(torch.int64), remapped

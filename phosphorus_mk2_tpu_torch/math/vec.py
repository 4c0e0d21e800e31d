"""Vector helpers over batched ``(..., 3)`` tensors.

Counterpart of ``phosphorus_mk2_tpu/math/vec.py``. All functions
broadcast over leading batch dimensions.
"""
from __future__ import annotations

import functools

import torch

# Ray-origin epsilon push, matching the reference's offset()
# (reference src/math/vector.hpp:14-21).
RAY_EPSILON = 1e-4


@functools.lru_cache(maxsize=None)
def _const(c: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32, device=device)


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """max(x, c) for a constant c, with the JAX package's gradient: at a
    tie x == c, half of it reaches x (``jnp.maximum``). ``torch.clamp``
    passes all of it; the values are the same."""
    return torch.maximum(x, _const(float(c), x.device))


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """min(x, c) with ``jnp.minimum``'s gradient at a tie (see maximum)."""
    return torch.minimum(x, _const(float(c), x.device))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: minimum(maximum(x, lo), hi), half the gradient at
    either bound."""
    return minimum(maximum(x, lo), hi)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis."""
    return (a * b).sum(dim=-1)


def dot_keep(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product, keeping the last axis for broadcasting."""
    return (a * b).sum(dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(maximum(dot(a, a), 0.0))


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: a / |a| with a guard against |a| = 0."""
    return a * torch.rsqrt(maximum(dot_keep(a, a), eps))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at 0; the masked form keeps a later backward pass
    free of inf/NaN at x <= 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_pow(x: torch.Tensor, e) -> torch.Tensor:
    """x**e for x > 0, 0 elsewhere (zero gradient at x <= 0)."""
    pos = x > 0.0
    return torch.where(pos, torch.pow(torch.where(pos, x, 1.0), e), 0.0)


def offset(p: torch.Tensor, n: torch.Tensor, invert=None) -> torch.Tensor:
    """Push a point off the surface along the normal to avoid self-hits.

    ``invert`` may be a boolean tensor (True pushes against the normal).
    """
    if invert is None:
        return p + n * RAY_EPSILON
    sign = torch.where(invert, -RAY_EPSILON, RAY_EPSILON)
    return p + n * sign[..., None]


def in_same_hemisphere(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """World-space hemisphere test (reference src/math/vector.hpp:10)."""
    return dot(a, b) > 0.0


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma as used by the reference's Russian roulette
    (reference src/utils/color.hpp:13)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def is_black(c: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return (c <= eps).all(dim=-1)

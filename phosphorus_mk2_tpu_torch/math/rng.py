"""Counter-based RNG for the wavefront integrator, bit-exact with
``phosphorus_mk2_tpu/math/rng.py``.

Every random number is a pure function of (seed, pixel, sample index,
bounce, purpose), so results are deterministic, order-independent and
identical under any split of the pixel axis.

The generator is PCG4D (Jarzynski & Olano, "Hash Functions for GPU
Rendering", JCGT 2020) on uint32 words. PyTorch has no ``>>`` for
``torch.uint32`` on the CPU, and ``>>`` on int32 is arithmetic, so the
words live in int64 tensors holding values in [0, 2^32): every product,
sum and shift is masked with ``& 0xFFFFFFFF``. Products are split into
16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PCG_MUL = 1664525
_PCG_ADD = 1013904223


def _mul32(a, b):
    """(a * b) mod 2^32 for words in [0, 2^32), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def pcg4d(a, b, c, d):
    """4-way PCG hash on broadcastable int64 tensors of uint32 words;
    returns four int64 tensors of uint32 words."""
    x = (_mul32(a, _PCG_MUL) + _PCG_ADD) & _MASK
    y = (_mul32(b, _PCG_MUL) + _PCG_ADD) & _MASK
    z = (_mul32(c, _PCG_MUL) + _PCG_ADD) & _MASK
    w = (_mul32(d, _PCG_MUL) + _PCG_ADD) & _MASK
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + _mul32(y, w)) & _MASK
    y = (y + _mul32(z, x)) & _MASK
    z = (z + _mul32(x, y)) & _MASK
    w = (w + _mul32(y, z)) & _MASK
    return x, y, z, w


def _to_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> [0, 1) float32 via the mantissa trick."""
    mantissa = (bits & 0x007FFFFF) | 0x3F800000
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


def seed_word(seed: int) -> int:
    """The uint32 seed word: ``jax.random.key_data(jax.random.key(seed))[-1]``."""
    return int(seed) & _MASK


def pixel_uniforms4(seed: int, pix: torch.Tensor, sample, bounce, purpose: int):
    """Four independent uniforms per pixel from one PCG4D evaluation.

    seed: uint32 seed word (see ``seed_word``); pix: (N,) int64 pixel
    hash ``(y << 16) | x``; sample: int or (N,) int64 tensor; bounce:
    int. Returns (N, 4) float32 in [0, 1).
    """
    def word(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=pix.device, dtype=torch.int64) & _MASK
        return torch.tensor(int(v) & _MASK, dtype=torch.int64, device=pix.device)

    s = (word(sample) + _mul32(seed_word(seed), 0x9E3779B9)) & _MASK
    b = (_mul32(word(bounce), 0x85EBCA6B) + int(purpose)) & _MASK
    d = word(0x6C078965 + int(purpose))
    x, y, z, w = pcg4d(pix.to(torch.int64) & _MASK, s, b, d)
    x, y, z, w = torch.broadcast_tensors(x, y, z, w)
    return torch.stack(
        [_to_float(x), _to_float(y), _to_float(z), _to_float(w)], dim=-1
    )


# ---------------------------------------------------------------------------
# Threefry-2x32 keys, on the host: ``jax.random.key`` and
# ``jax.random.split`` of the JAX package's default key type, so that a
# chain of split keys, and the render seed each key gives
# (``key_data[-1]``), is the JAX package's.
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words x0, x1
    (uint32 arrays) under the key's two words; returns two uint32 arrays.
    The round schedule of jax's ``_threefry2x32_lowering``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key_data(seed: int) -> np.ndarray:
    """The two uint32 words of ``jax.random.key(seed)`` with jax's
    default 32-bit integers: 0, then the seed's word (``seed_word``)."""
    return np.array([0, seed_word(seed)], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` for a threefry key with
    ``jax_threefry_partitionable`` on (jax's default since 0.5): key i
    is the hash of the 64-bit counter i, high word 0. Returns (num, 2)
    uint32 key words."""
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(np.asarray(key, np.uint32),
                              np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=1)


def key_seed(key) -> int:
    """The render seed a key gives: its last word (the JAX package's
    ``key_data(key)[-1]``)."""
    return int(np.asarray(key, np.uint32)[-1])

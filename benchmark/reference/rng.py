"""The random numbers a render draws, written out in plain PyTorch and NumPy.

PCG4D (Jarzynski and Olano, "Hash Functions for GPU Rendering", JCGT 2020)
over uint32 words held in int64 tensors, keyed by (seed, pixel, sample,
bounce, purpose), and the Threefry-2x32 key split (Salmon et al., SC 2011)
that an optimizer run takes a new render seed from each step. The same
definitions as the program's, so that the reference draws the same samples.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
PCG_MUL = 1664525
PCG_ADD = 1013904223


def mul32(a, b):
    """(a * b) mod 2**32 for words in [0, 2**32), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & MASK


def pcg4d(a, b, c, d):
    x = (mul32(a, PCG_MUL) + PCG_ADD) & MASK
    y = (mul32(b, PCG_MUL) + PCG_ADD) & MASK
    z = (mul32(c, PCG_MUL) + PCG_ADD) & MASK
    w = (mul32(d, PCG_MUL) + PCG_ADD) & MASK
    for shift in (False, True, False):
        if shift:
            x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
            continue
        x = (x + mul32(y, w)) & MASK
        y = (y + mul32(z, x)) & MASK
        z = (z + mul32(x, y)) & MASK
        w = (w + mul32(y, z)) & MASK
    return x, y, z, w


def to_float(bits):
    """A uint32 word as a float32 in [0, 1): its 23 low bits as the mantissa."""
    return ((bits & 0x007FFFFF) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniforms4(seed: int, pix, sample, bounce: int, purpose: int):
    """(N, 4) float32 uniforms of pixel keys ``pix`` (int64 (y << 16) | x)
    at an int sample index."""
    def word(v):
        return torch.tensor(int(v) & MASK, dtype=torch.int64, device=pix.device)

    s = (word(sample) + mul32(int(seed) & MASK, 0x9E3779B9)) & MASK
    b = (mul32(word(bounce), 0x85EBCA6B) + int(purpose)) & MASK
    d = word(0x6C078965 + int(purpose))
    x, y, z, w = pcg4d(pix & MASK, s, b, d)
    x, y, z, w = torch.broadcast_tensors(x, y, z, w)
    return torch.stack([to_float(x), to_float(y), to_float(z), to_float(w)], dim=-1)


ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def first_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & MASK], np.uint32)


def split(key) -> tuple:
    """(next key, subkey): the two keys of a split of ``key`` into two."""
    b0, b1 = threefry2x32(np.asarray(key, np.uint32), np.zeros(2, np.uint32),
                          np.arange(2, dtype=np.uint32))
    keys = np.stack([b0, b1], axis=1)
    return keys[0], keys[1]


def step_seeds(seed: int, steps: int) -> list:
    """The render seed of each of an optimizer run's first ``steps`` steps:
    the last word of the subkey split off the run's key before each step."""
    key, out = first_key(seed), []
    for _ in range(steps):
        key, sub = split(key)
        out.append(int(sub[-1]))
    return out

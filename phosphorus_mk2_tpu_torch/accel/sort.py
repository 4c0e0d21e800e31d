"""Wavefront ray sorting for traversal coherence.

Counterpart of ``phosphorus_mk2_tpu/accel/sort.py``. A wavefront loses
coherence after the first bounce; the block tracer
(accel/block_traverse.py) pays for incoherence with the union of its
rays' node visits. Sorting the wavefront by (direction octant, Morton
code of the quantized origin) before the trace restores it: one stable
argsort a trace, the rays traced in sorted order and the results put
back through the inverse permutation.

The keys are uint32 words in the JAX package; here they are int64
tensors holding the same values (torch has no uint32 shifts on the CPU).
"""
from __future__ import annotations

import torch

MORTON_BITS = 6  # per axis -> 18-bit morton + 3-bit octant


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread MORTON_BITS bits out with 2 gaps (classic Morton spread)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def ray_sort_keys(p: torch.Tensor, d: torch.Tensor, lo, hi) -> torch.Tensor:
    """(N,) int64 coherence keys: octant (3 bits) above morton18(origin)."""
    octant = (
        (d[:, 0] >= 0).long()
        | ((d[:, 1] >= 0).long() << 1)
        | ((d[:, 2] >= 0).long() << 2)
    )
    scale = (1 << MORTON_BITS) - 1
    ext = torch.clamp(hi - lo, min=1e-8)
    q = (torch.clamp((p - lo) / ext, 0.0, 1.0) * scale).long()
    morton = (
        _expand_bits(q[:, 0])
        | (_expand_bits(q[:, 1]) << 1)
        | (_expand_bits(q[:, 2]) << 2)
    )
    return (octant << 18) | morton


def _permute(x, idx):
    """x indexed by idx along its leading axis: a tensor, a dict of
    tensors, or None (passed through, as ``tree_map`` passes it)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _permute(v, idx) for k, v in x.items()}
    return x[idx]


def sorted_trace(trace_fn, scene, p, d, *args):
    """Run ``trace_fn(scene, p, d, *args)`` on the coherence-sorted
    wavefront and return its result (a tensor or a dict of tensors with
    leading axis N) in the original ray order. ``None`` arguments pass
    through unchanged."""
    verts = scene.vertices.detach()
    keys = ray_sort_keys(p, d, verts.amin(dim=0), verts.amax(dim=0))
    order = torch.argsort(keys, stable=True)
    inv = torch.argsort(order, stable=True)
    out = trace_fn(scene, *(_permute(a, order) for a in (p, d, *args)))
    return _permute(out, inv)

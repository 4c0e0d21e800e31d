"""Row gather with a sort + segment-sum backward.

Counterpart of ``phosphorus_mk2_tpu/math/grad_gather.py``. The backward
of ``table[idx]`` is a scatter-add of the (N, W) cotangent rows into the
(F, W) table: the dominant primitive of a gradient step's backward.
PyTorch's index backward sorts the indices and then sums each row's
contributions serially; the alternative here sorts the contributions by
target row once and sums the runs of equal rows as segments, with no
atomics, so two backwards of the same inputs are bit-equal.

``gather_rows(table, idx, transpose="segsum")`` is ``table[idx]`` bit
for bit in the primal, and its gradient is the scatter-add's up to the
order of the sums. The JAX package wires none of it in, and the port
wires in only the "float64" backward (the port's own): the gathers of
the material rows by material id (bsdf.gather_lobes, bsdf.emission_at,
and bsdf.hit_row_tables' rows by triangle), where every lane of a
wavefront, or every triangle of a scene, sums into one of a few rows.
There one serial float32 sum of every lane into a row drifts: on the
CPU, a gradient step of 65,536 lanes on terrain_scene at grid 192 put
the lobe_weight gradient 4.1e-4 of its scale off a float64 sum of the
same contributions. The segment sum drifts alike (65,536 indices into
two rows on the CPU: 6.8e-5 off, the index backward 6.6e-5), so
"float64" sums in float64 and rounds once (2.7e-8).
"""
from __future__ import annotations

import torch

TRANSPOSES = ("segsum", "scatter", "float64")


def _segsum(idx: torch.Tensor, ct: torch.Tensor, rows: int) -> torch.Tensor:
    """Sum the cotangent rows ``ct`` (N, W) into ``rows`` table rows by
    index: a stable sort of idx, the rows in that order, one segmented
    sum over the runs of equal indices. A row no index names gets 0."""
    g = ct.new_zeros((rows,) + tuple(ct.shape[1:]))
    if idx.numel() == 0:
        return g
    sid, order = torch.sort(idx, stable=True)
    uniq, counts = torch.unique_consecutive(sid, return_counts=True)
    sums = torch.segment_reduce(ct[order], "sum", lengths=counts, axis=0)
    g[uniq] = sums
    return g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, transpose):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        ctx.transpose = transpose
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        if ctx.transpose == "segsum":
            return _segsum(idx, ct, ctx.rows), None, None
        if ctx.transpose == "float64":
            g = ct.new_zeros((ctx.rows,) + tuple(ct.shape[1:]), dtype=torch.float64)
            g.index_put_((idx,), ct.double(), accumulate=True)
            return g.to(ct.dtype), None, None
        g = ct.new_zeros((ctx.rows,) + tuple(ct.shape[1:]))
        return g.index_add_(0, idx, ct), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, transpose: str = "segsum"):
    """``table[idx]`` with the chosen backward.

    table: (F, ...) rows; idx: (N,) integer indices (the caller keeps
    them in range). transpose: "segsum" (sorted segment sums,
    deterministic), "scatter" (an ``index_add_`` scatter-add, with
    atomics on the card and so not bit-stable there) or "float64"
    (PyTorch's deterministic sort-based ``index_put_`` summed in float64,
    then rounded once to the cotangent's dtype: accurate where many
    indices name one row).
    """
    if transpose not in TRANSPOSES:
        raise ValueError(f"unknown transpose {transpose!r}; one of {TRANSPOSES}")
    return _GatherRows.apply(table, idx.long(), transpose)

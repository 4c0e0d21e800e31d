"""Row gathers with chosen backwards, and a CUDA kernel for the backward
of a gather from a small table.

Counterpart of ``phosphorus_mk2_tpu/math/grad_gather.py``. The backward
of ``table[idx]`` is a scatter-add of the (N, W) cotangent rows into the
(F, W) table: the dominant primitive of a gradient step's backward.
PyTorch's index backward sorts the indices and then sums each row's
contributions serially; the "segsum" alternative sorts the contributions
by target row once and sums the runs of equal rows as segments, with no
atomics, so two backwards of the same inputs are bit-equal. The JAX
package wires none of it in.

The port wires in two backwards of its own, at every differentiable
gather of the step's path: "index" at the hit rows
(bsdf.gather_hit_rows) and the light-triangle rows (core/lights:
sample_lights, light_tri_table's attribute rows), and "float64" at the
material rows by material id (bsdf.gather_lobes, bsdf.emission_at,
bsdf.hit_row_tables' rows by triangle, light_tri_table's emission
rows). There every lane of a wavefront, or every triangle of
a scene, sums into one of a few rows, and a serial float32 sum drifts:
on the CPU, a gradient step of 65,536 lanes on terrain_scene at grid 192
put the lobe_weight gradient 4.1e-4 of its scale off a float64 sum of
the same contributions; the segment sum drifts alike (65,536 indices
into two rows: 6.8e-5 off, the index backward 6.6e-5).

Where the table's rows x columns fit ROWS_BUDGET, both backwards are
``rows_backward``: the sum in float64, rounded once (2.7e-8 off), in a
fixed blocked order. On the card that is the kernel pair of
``csrc/rows_backward.cu``, which replaces PyTorch's index backward there:
that backward took 80% of a cornell_box gradient step on an H100 (6-13
ms a call for ~2 MB of cotangent), serialised along each row's run of
sorted indices. Above the budget (a gather by triangle on a large mesh)
each keeps what it was: "index" PyTorch's own index backward in the
cotangent's dtype, "float64" ``index_put_(accumulate=True)`` in float64.
``LAUNCHES`` counts each backward's route.
"""
from __future__ import annotations

import ctypes
import math

import torch

from phosphorus_mk2_tpu_torch.accel.build import CSRC, NVCC_FLAGS, find_nvcc, load_shared
from phosphorus_mk2_tpu_torch.utils.profiling import counted

TRANSPOSES = ("segsum", "scatter", "float64", "index")

# csrc/rows_backward.cu's BLOCKS and BUDGET: the blocked sum's fixed
# number of lane slices, and the most rows x columns a table may have
# for rows_backward (its outputs live in registers and its partial rows
# in a BLOCKS x budget float64 scratch)
ROWS_BLOCKS = 264
ROWS_BUDGET = 4096

# rows_backward: calls of the kernel pair; rows_backward_plain: calls of
# the plain version (CPU tensors); rows_backward_above_budget: backwards
# of "index" or "float64" above ROWS_BUDGET, left to PyTorch
LAUNCHES = counted("math.grad_gather.LAUNCHES",
                   {"rows_backward": 0, "rows_backward_plain": 0,
                    "rows_backward_above_budget": 0})

_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def build() -> ctypes.CDLL:
    """Compile csrc/rows_backward.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = load_shared(CSRC / "rows_backward.cu", find_nvcc(), NVCC_FLAGS,
                                 "rows_backward")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.indexing_backward_rows_geometry.argtypes = [vp, vp]
    lib.indexing_backward_rows_geometry.restype = None
    lib.indexing_backward_rows_launch.argtypes = [vp, vp, ctypes.c_longlong, i32, i32, i32, i32,
                                                  vp, vp, vp]
    lib.indexing_backward_rows_launch.restype = i32
    blocks, budget = ctypes.c_int(0), ctypes.c_int(0)
    lib.indexing_backward_rows_geometry(ctypes.byref(blocks), ctypes.byref(budget))
    if (blocks.value, budget.value) != (ROWS_BLOCKS, ROWS_BUDGET):
        raise RuntimeError(f"rows_backward.cu has BLOCKS {blocks.value}, BUDGET {budget.value}; "
                           f"this module {ROWS_BLOCKS}, {ROWS_BUDGET}")
    _lib = lib
    return lib


def _width(ct: torch.Tensor, idx: torch.Tensor) -> int:
    return math.prod(ct.shape[idx.dim():])


def rows_backward_plain(idx: torch.Tensor, ct: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel pair of ``rows_backward``: the
    lanes cut into slices of ceil(N / ROWS_BLOCKS), each slice's lanes
    added in lane order into its own float64 partial rows (one
    ``index_add_`` a lane position, every slice at once, no two adds to
    one value), the partials summed in slice order and rounded once to
    the cotangent's dtype. The kernel's adds, in the kernel's order."""
    w = _width(ct, idx)
    n = idx.numel()
    lanes = max(1, -(-n // ROWS_BLOCKS))
    nb = -(-n // lanes)  # slices that hold lanes (an empty one adds +0.0, a no-op)
    r = idx.reshape(-1)
    r = torch.where(r < 0, r + rows, r)
    pad = nb * lanes - n
    # the last slice's missing lanes: value 0 into a spare row, dropped below
    r = torch.cat([r, r.new_full((pad,), rows)])
    src = torch.cat([ct.reshape(n, w).double(), ct.new_zeros((pad, w), dtype=torch.float64)])
    dest = r.view(nb, lanes) + (rows + 1) * torch.arange(nb, device=r.device)[:, None]
    src = src.view(nb, lanes, w)
    partial = torch.zeros((nb * (rows + 1), w), dtype=torch.float64, device=ct.device)
    for j in range(lanes):
        partial.index_add_(0, dest[:, j], src[:, j])
    partial = partial.view(nb, rows + 1, w)[:, :rows]
    g = torch.zeros((rows, w), dtype=torch.float64, device=ct.device)
    for b in range(nb):
        g += partial[b]
    return g.to(ct.dtype).reshape((rows,) + tuple(ct.shape[idx.dim():]))


def rows_backward(idx: torch.Tensor, ct: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of ``table[idx]`` for a table of ``rows`` rows, given
    the cotangent ``ct`` (idx.shape + the row's shape): (rows, ...) in
    ct's dtype, each value a float64 sum rounded once, in a fixed order
    (bit-equal on a second call). CUDA tensors: the kernel pair of
    csrc/rows_backward.cu (float32 or float64 cotangents, int64 indices,
    rows x columns at most ROWS_BUDGET; anything else raises). CPU
    tensors: ``rows_backward_plain``."""
    if not ct.is_cuda:
        LAUNCHES["rows_backward_plain"] += 1
        return rows_backward_plain(idx, ct, rows)
    w = _width(ct, idx)
    if ct.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"rows_backward takes float32 or float64 cotangents, not {ct.dtype}")
    if idx.dtype != torch.int64 or idx.device != ct.device:
        raise ValueError(f"rows_backward takes int64 indices on {ct.device}, "
                         f"not {idx.dtype} on {idx.device}")
    if rows < 1 or w < 1 or rows * w > ROWS_BUDGET:
        raise ValueError(f"rows_backward takes 1 to {ROWS_BUDGET} rows x columns, "
                         f"not {rows} x {w}")
    lib = build()
    n = idx.numel()
    flat = ct.reshape(n, w)
    if flat.stride(1) != 1:
        flat = flat.contiguous()
    ld = flat.stride(0) if n > 1 else w
    grad = torch.empty((rows,) + tuple(ct.shape[idx.dim():]), dtype=ct.dtype, device=ct.device)
    idx = idx.reshape(-1).contiguous()
    partial = torch.empty((ROWS_BLOCKS, rows, w), dtype=torch.float64, device=ct.device)
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    err = lib.indexing_backward_rows_launch(
        idx.data_ptr(), flat.data_ptr(), ld, n, rows, w, int(ct.dtype == torch.float64),
        partial.data_ptr(), grad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rows_backward launch failed: cudaError {err}")
    LAUNCHES["rows_backward"] += 1
    return grad


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
        shape = (ctx.rows,) + tuple(ct.shape[idx.dim():])
        if ctx.transpose == "segsum":
            return _segsum(idx, ct, ctx.rows), None, None
        if ctx.transpose == "scatter":
            return ct.new_zeros(shape).index_add_(0, idx, ct), None, None
        if ctx.rows * _width(ct, idx) <= ROWS_BUDGET:
            return rows_backward(idx, ct, ctx.rows), None, None
        LAUNCHES["rows_backward_above_budget"] += 1
        if ctx.transpose == "index":  # what the autograd of table[idx] does
            return ct.new_zeros(shape).index_put_((idx,), ct, accumulate=True), None, None
        g = ct.new_zeros(shape, dtype=torch.float64)
        g.index_put_((idx,), ct.double(), accumulate=True)
        return g.to(ct.dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor, transpose: str = "segsum"):
    """``table[idx]`` with the chosen backward.

    table: (F, ...) rows; idx: integer indices (the caller keeps them in
    range; "segsum" and "scatter" take (N,) only). transpose: "segsum"
    (sorted segment sums, deterministic), "scatter" (an ``index_add_``
    scatter-add, with atomics on the card and so not bit-stable there),
    or the port's two: "float64" and "index", which are ``rows_backward``
    (a float64 sum rounded once, deterministic; the kernel on the card)
    where F times the row's width is at most ROWS_BUDGET, and above it
    ``index_put_(accumulate=True)`` summed in float64 ("float64") or
    PyTorch's own index backward ("index").

    Without a gradient to take (grad mode off, or a table that does not
    require grad) it is ``table[idx]`` itself.
    """
    if transpose not in TRANSPOSES:
        raise ValueError(f"unknown transpose {transpose!r}; one of {TRANSPOSES}")
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[idx]
    return _GatherRows.apply(table, idx.long(), transpose)


def block_of(row: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``row`` where ``source``, the tensor that one column block of it
    was built from, requires grad; else ``row`` detached. Every column of
    a row gathered from a concatenated table requires grad when one of
    its sources does; slicing a block from ``block_of(row, source)``
    makes its requires_grad say what the block depends on, and the BSDF
    container picks its route from that (bsdf/bsdf.py). No gradient
    changes: a detached block's could only reach a tensor that does not
    require grad."""
    return row if source.requires_grad else row.detach()

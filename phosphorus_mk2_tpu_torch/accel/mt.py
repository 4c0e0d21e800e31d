"""Brute-force Moller-Trumbore tracer: two hand-written CUDA kernels for
Hopper and their plain PyTorch versions.

Counterpart of ``phosphorus_mk2_tpu/accel/pallas_mt.py``:
  * ``mt_closest`` replaces ``_mt_kernel`` (closest hit of every ray
    against every triangle; min t, ties to the lowest column);
  * ``mt_anyhit`` replaces ``_anyhit_kernel`` (any valid hit with
    0 <= t < tmax, ANDed with tmax > 0).

The kernels are in ``csrc/mt.cu``. They are compiled with ``nvcc`` at
first use into ``build/torch_kernels/`` at the root of the checkout and
bound with ctypes. A wrapper given CPU tensors runs the plain version; a
wrapper given CUDA tensors launches the kernel, counts the launch in
``LAUNCHES`` and raises if the build or the launch fails. Nothing falls
back from one to the other.

The plain versions round after every operation, in the kernels' order,
so on the card the kernels match them bit for bit in t and tri. They
also cut the work as the kernels do: ``mt_closest_plain(splits=)``
merges per-range winners by the least (t, column), the kernel's
atomicMin, and ``mt_anyhit_plain`` walks the table with the live rays
compacted. ``closest_plan`` is the host's choice of that split on a card.

Both walk only the columns that can hold a triangle, ``cols`` (from
``live_columns``; every later column is a pad): the kernels stop at the
last tile that reaches into them, and the plain versions walk as far.
"""
from __future__ import annotations

import ctypes

import torch

from phosphorus_mk2_tpu_torch.accel.build import (
    BUILD_DIR,  # noqa: F401  (named by callers that report where the build went)
    CSRC,
    NVCC_FLAGS,
    find_nvcc,
    load_shared,
)
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, mt_intersect_soa, ray_soa
from phosphorus_mk2_tpu_torch.utils.profiling import counted

TRI_TILE = 512       # the table's column padding (the Pallas kernels' chunk)
RAY_CHUNK = 8192     # rays per step of the plain versions (bounds their (N, C) temporaries)

# csrc/mt.cu's geometry (CT, CB, CR there): mt_closest stages
# CLOSEST_TILE columns at a time and cuts the table into splits of whole
# tiles; a block of CLOSEST_THREADS threads holds CLOSEST_RAYS rays a thread
CLOSEST_TILE = 64
CLOSEST_THREADS = 128
CLOSEST_RAYS = 2
WAVES = 4            # waves of resident blocks the closest grid aims at
ANYHIT_TILE = 128    # csrc/mt.cu's AT: the columns mt_anyhit stages at a time
NO_HIT = (1 << 63) - 1  # the plain merge's key of a miss (the kernel's is all ones)

LAUNCHES = counted("accel.mt.LAUNCHES", {"mt_closest": 0, "mt_anyhit": 0})

_lib = None
_resident = {}   # device index -> (SMs, mt_closest blocks resident on an SM)
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def build() -> ctypes.CDLL:
    """Compile csrc/mt.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = load_shared(CSRC / "mt.cu", find_nvcc(), NVCC_FLAGS, "mt")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mt_closest_blocks_per_sm.argtypes = [vp]
    lib.mt_closest_launch.argtypes = [vp, i32, i32, vp, vp, i32, i32, i32, vp, vp, vp, vp, vp,
                                      vp]
    lib.mt_anyhit_launch.argtypes = [vp, i32, i32, vp, vp, vp, i32, vp, vp]
    for fn in (lib.mt_closest_blocks_per_sm, lib.mt_closest_launch, lib.mt_anyhit_launch):
        fn.restype = i32
    _lib = lib
    return lib


def closest_plan(n: int, cols: int, sms: int, blocks_per_sm: int) -> dict:
    """How ``mt_closest`` cuts its work: ray tiles of CLOSEST_THREADS x
    CLOSEST_RAYS rays, and the CLOSEST_TILE-column tiles that reach into
    the first ``cols`` columns (at least one) cut into ``splits`` ranges
    of ``tiles_per_split`` (none empty), as few as give WAVES waves of
    resident blocks (``resident`` = sms x blocks_per_sm) where those
    tiles allow; one split when the rays alone do. ``scratch_bytes``: the
    (n,) 64-bit keys the splits meet in."""
    ray_tile = CLOSEST_THREADS * CLOSEST_RAYS
    ray_tiles = max(1, -(-n // ray_tile))
    col_tiles = max(1, -(-cols // CLOSEST_TILE))
    resident = sms * blocks_per_sm
    splits = min(col_tiles, -(-WAVES * resident // ray_tiles))
    per = -(-col_tiles // splits)
    splits = -(-col_tiles // per)
    return {"ray_tile": ray_tile, "ray_tiles": ray_tiles, "col_tiles": col_tiles,
            "splits": splits, "tiles_per_split": per, "blocks": ray_tiles * splits,
            "resident": resident, "scratch_bytes": 8 * n}


def resident(lib, dev: torch.device):
    """(SMs, mt_closest blocks resident on an SM) of a CUDA device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _resident:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.mt_closest_blocks_per_sm(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"mt_closest occupancy query failed: cudaError {err}")
        _resident[idx] = (torch.cuda.get_device_properties(idx).multi_processor_count,
                          blocks.value)
    return _resident[idx]


# ---------------------------------------------------------------------------
# triangle table
# ---------------------------------------------------------------------------

def live_columns(table) -> int:
    """Columns of the table up to its last triangle (id >= 0): every later
    column is a pad, and the kernels walk no further. Reads the ids back
    to the host (one sync)."""
    live = torch.nonzero(table[9].view(torch.int32) >= 0)
    return int(live[-1, 0]) + 1 if live.numel() else 0


def tri_table(scene) -> torch.Tensor:
    """(10, Tp) float32 table, Tp = ceil(T/512)*512: rows a xyz, e0 xyz,
    e1 xyz and, in row 9, the int32 triangle id stored as its bits (-1 on
    the zero pad columns). The Pallas kernels' ``_tri_rows`` layout, with
    an int32 id in place of the id-as-float."""
    f = scene.faces.long()
    v = scene.vertices
    a = v[f[:, 0]]
    e0 = v[f[:, 1]] - a
    e1 = v[f[:, 2]] - a
    num = f.shape[0]
    tp = -(-num // TRI_TILE) * TRI_TILE
    # written through an int32 view so the id bits (small ids are float
    # denormals) never pass through a float operation
    bits = torch.zeros((10, tp), dtype=torch.int32, device=v.device)
    bits[9] = -1
    bits[9, :num] = torch.arange(num, dtype=torch.int32, device=v.device)
    table = bits.view(torch.float32)
    table[0:3, :num] = a.T
    table[3:6, :num] = e0.T
    table[6:9, :num] = e1.T
    return table


def _check(table, p, d, tmax=None, cols=None):
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] != 10:
        raise ValueError(f"table must be (10, Tp) float32, got {tuple(table.shape)} {table.dtype}")
    if table.shape[1] % TRI_TILE or table.shape[1] == 0:
        raise ValueError(f"table width {table.shape[1]} is not a positive multiple of {TRI_TILE}")
    if cols is not None and not 0 <= cols <= table.shape[1]:
        raise ValueError(f"cols {cols} is outside the table's {table.shape[1]} columns")
    n = p.shape[0]
    for name, x in (("p", p), ("d", d)):
        if x.dtype != torch.float32 or tuple(x.shape) != (n, 3):
            raise ValueError(f"{name} must be ({n}, 3) float32, got {tuple(x.shape)} {x.dtype}")
    tensors = [table, p, d]
    if tmax is not None:
        if tmax.dtype != torch.float32 or tuple(tmax.shape) != (n,):
            raise ValueError(f"tmax must be ({n},) float32, got {tuple(tmax.shape)} {tmax.dtype}")
        tensors.append(tmax)
    if any(x.device != table.device for x in tensors):
        raise ValueError("table, rays and tmax must lie on one device")
    if any(x.requires_grad for x in tensors):
        raise ValueError("the tracer kernels are primal: trace under torch.no_grad() "
                         "on detached tensors, not on tensors that require grad")
    if table.is_cuda:
        if not all(x.is_contiguous() for x in tensors):
            raise ValueError("the CUDA kernels take contiguous tensors")
        if table.data_ptr() % 16:
            raise ValueError("the CUDA kernels copy the table 16 bytes at a time: align it to 16")


def _cols_soa(table, c0, c1):
    rows = table[:, c0:c1]
    a = (rows[0:1], rows[1:2], rows[2:3])
    e0 = (rows[3:4], rows[4:5], rows[5:6])
    e1 = (rows[6:7], rows[7:8], rows[8:9])
    return a, e0, e1, table[9, c0:c1].view(torch.int32)


# ---------------------------------------------------------------------------
# closest hit
# ---------------------------------------------------------------------------

def _closest_key(table, rp, rd, c0, c1):
    """(m,) int64 keys (t bits << 32 | column) of the least (t, column)
    valid hit in columns [c0, c1), NO_HIT where none: walks 512-column
    chunks, inside a chunk takes tmin and then the lowest column at it,
    keeps it only if strictly closer than the earlier chunks' best, and
    stores a winning -0.0 as +0.0 (t + 0.0)."""
    m, dev = rp[0].shape[0], rp[0].device
    best_t = torch.full((m, 1), T_MAX, dtype=torch.float32, device=dev)
    best_c = torch.full((m, 1), -1, dtype=torch.int64, device=dev)
    for base in range(c0, c1, TRI_TILE):
        top = min(base + TRI_TILE, c1)
        a, e0, e1, ids = _cols_soa(table, base, top)
        t, _, _, valid = mt_intersect_soa(rp, rd, a, e0, e1)
        ok = valid & (t < best_t) & (ids >= 0)[None, :]
        t_m = torch.where(ok, t, T_MAX)
        t_new = t_m.min(dim=1, keepdim=True).values
        col = torch.arange(base, top, device=dev)[None, :]
        jsel = torch.where(ok & (t_m == t_new), col, top).min(dim=1, keepdim=True).values
        better = t_new < best_t
        best_c = torch.where(better, jsel, best_c)
        best_t = torch.where(better, t_new + 0.0, best_t)
    key = (best_t.view(torch.int32).long() << 32) | best_c
    return torch.where(best_c >= 0, key, NO_HIT)[:, 0]


def mt_closest_plain(table, p, d, splits: int = 1, cols: int | None = None):
    """Plain PyTorch version of ``mt_closest``: for every ray the valid
    hit of least t over the table, ties to the lowest column, tmax
    unapplied, a winning -0.0 stored as +0.0. Returns t (N,) (T_MAX on a
    miss), tri (N,) int32 (-1), u, v (N,) (0 on a miss).

    It walks the CLOSEST_TILE-column tiles that reach into the first
    ``cols`` columns (default ``live_columns(table)``), as the kernel
    does. ``splits`` cuts those tiles as the kernel's launch plan does,
    finds each range's winner and merges them by the least (t, column)
    key, as the kernel's atomicMin does; the result is the same to the
    bit for any splits. u and v are computed again at the winning column,
    as the kernel's finishing step does."""
    _check(table, p, d, cols=cols)
    n = p.shape[0]
    col_tiles = max(1, -(-(live_columns(table) if cols is None else cols) // CLOSEST_TILE))
    end = col_tiles * CLOSEST_TILE
    per = -(-col_tiles // max(1, min(splits, col_tiles))) * CLOSEST_TILE
    key = torch.empty((n,), dtype=torch.int64, device=p.device)
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(r0 + RAY_CHUNK, n)
        rp, rd = ray_soa(p[r0:r1], d[r0:r1])
        key[r0:r1] = NO_HIT
        for c0 in range(0, end, per):
            key[r0:r1] = torch.minimum(key[r0:r1], _closest_key(table, rp, rd, c0,
                                                                min(c0 + per, end)))
    hit = key != NO_HIT
    col = torch.where(hit, key & 0xFFFFFFFF, 0)
    cols = table[:, col].T  # (N, 10): the winning column of every ray
    rp, rd = ray_soa(p, d)
    _, u, v, _ = mt_intersect_soa(rp, rd, (cols[:, 0:1], cols[:, 1:2], cols[:, 2:3]),
                                  (cols[:, 3:4], cols[:, 4:5], cols[:, 5:6]),
                                  (cols[:, 6:7], cols[:, 7:8], cols[:, 8:9]))
    t = (key >> 32).to(torch.int32).view(torch.float32)
    tri = cols[:, 9].contiguous().view(torch.int32)
    return (torch.where(hit, t, T_MAX), torch.where(hit, tri, -1),
            torch.where(hit, u[:, 0], 0.0), torch.where(hit, v[:, 0], 0.0))


def mt_closest(table, p, d, cols: int | None = None):
    """Closest hit of every ray against the table's first ``cols`` columns
    (default ``live_columns(table)``; tmax unapplied): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Returns t, tri
    (int32), u, v as in ``mt_closest_plain``."""
    if not p.is_cuda:
        return mt_closest_plain(table, p, d, cols=cols)
    _check(table, p, d, cols=cols)
    lib = build()
    n, tp = p.shape[0], table.shape[1]
    cols = live_columns(table) if cols is None else cols
    t = torch.empty((n,), dtype=torch.float32, device=p.device)
    tri = torch.empty((n,), dtype=torch.int32, device=p.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, tri, u, v
    plan = closest_plan(n, cols, *resident(lib, p.device))
    keys = torch.empty((n,), dtype=torch.int64, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.mt_closest_launch(
        table.data_ptr(), tp, cols, p.data_ptr(), d.data_ptr(), n, plan["splits"],
        plan["tiles_per_split"], keys.data_ptr(), t.data_ptr(), tri.data_ptr(),
        u.data_ptr(), v.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"mt_closest launch failed: cudaError {err}")
    LAUNCHES["mt_closest"] += 1
    return t, tri, u, v


# ---------------------------------------------------------------------------
# any hit
# ---------------------------------------------------------------------------

def mt_anyhit_plain(table, p, d, tmax, cols: int | None = None):
    """Plain PyTorch version of ``mt_anyhit``: a ray is occluded when one
    of the first ``cols`` columns (default ``live_columns(table)``) holds
    a valid hit with t < tmax and an id >= 0; a ray with tmax <= 0 or NaN
    never is. Walks the ANYHIT_TILE-column tiles that reach into those
    columns (at least one), as the kernel does, in 512-column chunks with
    the kernel's compaction: only the rays still live (tmax > 0, not yet
    occluded) meet the next chunk, and the walk ends when none is.
    Returns (N,) bool."""
    _check(table, p, d, tmax, cols)
    n = p.shape[0]
    cols = live_columns(table) if cols is None else cols
    end = max(1, -(-cols // ANYHIT_TILE)) * ANYHIT_TILE
    occ = torch.zeros((n,), dtype=torch.bool, device=p.device)
    for r0 in range(0, n, RAY_CHUNK):
        live = torch.nonzero(tmax[r0 : r0 + RAY_CHUNK] > 0.0)[:, 0] + r0
        for base in range(0, end, TRI_TILE):
            if live.numel() == 0:
                break
            rp, rd = ray_soa(p[live], d[live])
            a, e0, e1, ids = _cols_soa(table, base, min(base + TRI_TILE, end))
            t, _, _, valid = mt_intersect_soa(rp, rd, a, e0, e1)
            hit = (valid & (t < tmax[live, None]) & (ids >= 0)[None, :]).any(dim=1)
            occ[live[hit]] = True
            live = live[~hit]
    return occ


def mt_anyhit(table, p, d, tmax, cols: int | None = None):
    """Any-hit occlusion of every ray within [0, tmax) by the table's first
    ``cols`` columns (default ``live_columns(table)``): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (N,)
    bool."""
    if not p.is_cuda:
        return mt_anyhit_plain(table, p, d, tmax, cols)
    _check(table, p, d, tmax, cols)
    lib = build()
    n = p.shape[0]
    cols = live_columns(table) if cols is None else cols
    occ = torch.empty((n,), dtype=torch.int32, device=p.device)
    if n == 0:
        return occ.bool()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.mt_anyhit_launch(
        table.data_ptr(), table.shape[1], cols, p.data_ptr(), d.data_ptr(),
        tmax.data_ptr(), n, occ.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"mt_anyhit launch failed: cudaError {err}")
    LAUNCHES["mt_anyhit"] += 1
    return occ.bool()


# ---------------------------------------------------------------------------
# the tracer pair
# ---------------------------------------------------------------------------

def brute_tracer(table, plain: bool = False):
    """(closest, occluded) over one triangle table, with the contracts of
    ``intersect_pallas_brute`` / ``occluded_pallas_brute``:

      closest(p, d, tmax=None) -> {"t", "tri", "u", "v", "hit"}, with
        tri = -1 where t >= tmax (tmax applied after the trace);
      occluded(p, d, tmax) -> (N,) bool.

    plain=True takes the plain versions on any device, so that a whole
    render can be held against the kernels on the card. The table's live
    columns are counted once, here.
    """
    closest_fn = mt_closest_plain if plain else mt_closest
    anyhit_fn = mt_anyhit_plain if plain else mt_anyhit
    cols = live_columns(table)

    def closest(p, d, tmax=None):
        t, tri, u, v = closest_fn(table, p.contiguous(), d.contiguous(), cols=cols)
        if tmax is not None:
            tri = torch.where(t >= tmax, -1, tri)
        return {"t": t, "tri": tri, "u": u, "v": v, "hit": tri >= 0}

    def occluded(p, d, tmax):
        return anyhit_fn(table, p.contiguous(), d.contiguous(), tmax.contiguous(), cols=cols)

    return closest, occluded

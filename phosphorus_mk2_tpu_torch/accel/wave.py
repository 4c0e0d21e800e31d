"""Wave-loop kernels of the cluster tracer: three hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

  * ``row_gather`` replaces the Pallas kernel of ``tools/tpu_r4q_dma.py``
    (the in-kernel row-copy probe): ``table[idx]`` for a (K, 9, 128)
    table of cluster rows, as a ``direct`` variant (a warp loads its row
    and stores it) and a ``staged`` one (rows pass through a ring of
    shared-memory slots filled by bulk asynchronous copies). The probe
    asked whether a kernel can fetch each ray's cluster row itself; the
    two kernels below are built on the routine it times.
  * ``wave_mt`` is the body of one wave of ``cluster_traverse._trace``
    (the JAX package's ``chunk_fn``: live gate, row gather, ``_mt_rows``,
    masked state update) over W front-table columns: W = 1 in the wave
    loop, W = W0 in the dense head. The JAX package has no Pallas kernel
    for it. The kernel gates G rays a warp, a lane a ray (G from
    ``gate_plan``), fetches each cluster's row once for the rays of a
    warp that want it in a column, and shares a block's groups out to
    all its warps; ``wave_mt_plain(gate=G)`` walks the same
    decomposition on any device.
  * ``wave_sweep`` is the exact fallback: every cluster of the table for
    a list of rays (the ``cand_base`` form of ``_mt_rows``). The kernel
    cuts the rays into tiles and the clusters into ranges (``sweep_plan``,
    from m and the SM count and occupancy, queried once per device), and
    each fetched row serves a whole tile: up to 16 rays in tiles of 4 a
    warp, from 17 on tiles of 32 with the rows staged in shared memory
    for a block, which skips the quads of a row that hold only pads
    (their first edge is zero, so no ray hits them); ``wave_sweep_plain(
    plan=)`` walks the same cut on any device.

The kernels are in ``csrc/wave.cu``, compiled with ``nvcc`` at first use
into ``build/torch_kernels/`` and bound with ctypes. A wrapper given CPU
tensors runs the plain version; a wrapper given CUDA tensors launches
the kernel, counts the launch in ``LAUNCHES`` and raises if the build or
the launch fails. Nothing falls back from one to the other.

``wave_mt`` and ``wave_sweep`` take a row table of float32 or of bf16
(the tracer's ``rows_bf16``): the kernels widen each bf16 value to
float32 as they load it and run the float32 arithmetic, and the plain
versions upcast the gathered rows before ``mt_rows``, so both compute
in float32 on the quantized values, as the JAX package does when it
promotes bf16 x float32. ``wave_mt(order=)`` meets the rays in the
order given (``dedup_order``: sorted by cluster, the tracer's
``wave_dedup`` on the card), with the same result. ``dedup_rows`` is the
JAX package's per-wave row dedup (``_dedup_rows``), the tracer's plain
``wave_dedup``. Each (kernel, row type, ordered) launch has its own key
in ``LAUNCHES``: ``wave_mt``, ``wave_mt_bf16``, ``wave_mt_ordered``,
``wave_mt_bf16_ordered``, ``wave_sweep``, ``wave_sweep_bf16``.

``wave_mt`` and ``wave_sweep`` update the state (best t, cluster, lane
of every ray) in place, and so do their plain versions. The plain
versions compact the rays that have work by index, which costs a host
sync; the kernels meet every ray and leave a dead one untouched, which
costs none. Both give the same state.

Why a wave may be grouped in any way. Every live column of a ray is
tested against the best t the ray had at the call, and among the hits
below it the winner is the least (t, w * C + lane) in lexicographic
order: ``mt_rows`` over all W columns at once takes the minimum t and
the first flat index at it. A minimum over a set does not depend on how
the set is cut: the kernel cuts a ray's pairs by column and, inside a
column, shares each fetched row among the rays of a warp that want that
cluster, takes each (ray, column) winner with a warp reduction in
whichever warp of the block took the group, and merges the winners in
the ray's slot. ``wave_mt_plain(gate=G)``
cuts them the same way (rays in warps of G, grouped by cluster per
column, a row gathered once a group, the minima merged) and equals the
uncut walk to the bit.

Why the fallback may be swept in any order. ``wave_sweep_plain`` walks
the clusters in ascending blocks of CC, the last block overlapping the
one before, and ``mt_rows`` takes a hit only on strict ``t < best_t``,
the first flat index winning inside a block. A later candidate so
replaces an earlier one only when strictly nearer, and a re-tested
candidate never replaces itself. The winner is therefore the candidate
with the least (t, cluster * C + lane), in lexicographic order, among
those below the ray's starting best t: a property of the set, not of the
walk. The kernel cuts the rays into tiles and the clusters into ranges,
one block each, and takes that minimum over a tile's ranges with a 64-bit
atomicMin of (t bits << 32 | flat index); ``wave_sweep_plain(plan=)``
takes each (tile, range) minimum against the best t of the call and
merges them by the same key, and equals the uncut walk to the bit.
"""
from __future__ import annotations

import ctypes

import torch

from phosphorus_mk2_tpu_torch.accel.build import CSRC, NVCC_FLAGS, find_nvcc, load_shared
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
from phosphorus_mk2_tpu_torch.utils.profiling import counted, tracing

ROW_C = 128          # triangles of a cluster row (csrc/wave.cu C)
WAVE_CHUNK = 1 << 17  # rays per step of wave_mt_plain unless the caller says
FB_RAYS = 2048       # most rays per step of wave_sweep_plain
FB_ELEMS = 1 << 24   # (ray, triangle) pairs per step of wave_sweep_plain:
                     # 64 MB a float32 temporary of the MT; 64 clusters a
                     # step at FB_RAYS rays, every cluster at once for a few
VARIANTS = ("direct", "staged")
GATES = (32, 16, 8)  # rays a warp that wave_mt's gate takes, the widest first
MT_WARPS = 8         # csrc/wave.cu MT_WARPS: warps a block of wave_mt
WARP_TILE = 4        # rays a tile of wave_sweep's kernel with a warp a tile
STAGED_TILE = 32     # and of its kernel with the rows staged for a block
SWEEP_WARPS = 8      # csrc/wave.cu SWEEP_WARPS: warps a block of wave_sweep, a warp a tile
SWEEP_WAVES = 4      # waves of resident blocks a sweep aims at
SWEEP_MIN_ROWS = 2   # rows a warp (a block, rows staged) takes at least, on average
NO_KEY = (1 << 63) - 1  # wave_sweep_plain's key of a ray without a hit
DEAD_CLUSTER = (1 << 31) - 1  # dedup_order's cluster of a dead ray: past every id

LAUNCHES = counted("accel.wave.LAUNCHES",
                   {"row_gather": 0, "wave_mt": 0, "wave_mt_bf16": 0, "wave_mt_ordered": 0,
                    "wave_mt_bf16_ordered": 0, "wave_sweep": 0, "wave_sweep_bf16": 0})
ROW_TYPES = (torch.float32, torch.bfloat16)  # what wave_mt and wave_sweep take
# What wave_mt's launches (and its plain version's calls) did, summed on
# their device while a torch.profiler session is active: under (LAUNCHES
# key, device) an int64 tensor of WORK_FIELDS, the live (ray, column)
# pairs the gate let through, the lanes (rays met), the rays whose winner
# changed and the distinct cluster rows of the live pairs. No host sync is
# added; a reader takes the tensors once, after its window
# (``RECORDER.read()["counters"]["accel.wave.WORK"]``).
WORK_FIELDS = ("pairs", "rays", "winners", "rows")
WORK = counted("accel.wave.WORK", {})

_lib = None
_resident = {}  # (device index, kernel) -> (SMs, blocks resident on an SM)
_scratch = {}   # device index -> wave_sweep's keys and per-tile counters
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def build() -> ctypes.CDLL:
    """Compile csrc/wave.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = load_shared(CSRC / "wave.cu", find_nvcc(), NVCC_FLAGS, "wave")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.row_gather_launch.argtypes = [vp, vp, i32, vp, i32, vp]
    lib.wave_mt_blocks_per_sm.argtypes = [i32, vp]
    lib.wave_mt_launch.argtypes = [vp, vp, vp, i32, i32, vp, vp, i64, i64, i32, i32, i32, i32,
                                   vp, vp, vp, vp, vp]
    lib.wave_sweep_blocks_per_sm.argtypes = [i32, i32, vp]
    lib.wave_sweep_launch.argtypes = [vp, vp, vp, i32, i32, vp, i32, i32, i32, i32, vp, vp,
                                      vp, vp, vp, vp]
    for fn in (lib.row_gather_launch, lib.wave_mt_blocks_per_sm, lib.wave_mt_launch,
               lib.wave_sweep_blocks_per_sm, lib.wave_sweep_launch):
        fn.restype = i32
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _want(name, x, shape, dtype):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(x.shape)} {x.dtype}")


def _check_table(table, packed, strided=(), dtypes=ROW_TYPES):
    """The (K, 9, C) row table and the (name, tensor) pairs that go with
    it: a row type of ``dtypes``, one device and a contiguous table (a
    slice of one is refused everywhere, so that a caller meets the
    kernels' rule on the CPU too); for the kernels a 16-byte aligned
    table of C = 128 (a bulk copy takes whole 16-byte units) and
    contiguous ``packed`` tensors (``strided`` ones carry their own
    strides)."""
    if table.dtype not in dtypes or table.dim() != 3 or table.shape[1] != 9:
        raise ValueError(f"table must be (K, 9, C) of {[str(t) for t in dtypes]}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if any(x.device != table.device for _, x in (*packed, *strided)):
        raise ValueError("the table and every other tensor must lie on one device")
    if table.requires_grad or any(x.requires_grad for _, x in (*packed, *strided)):
        raise ValueError("the tracer kernels are primal: trace under torch.no_grad() "
                         "on detached tensors, not on tensors that require grad")
    if not table.is_contiguous():
        raise ValueError("the row table must be contiguous")
    if table.is_cuda:
        if table.data_ptr() % 16:
            raise ValueError("the CUDA kernels take a 16-byte aligned table")
        if table.shape[2] != ROW_C:
            raise ValueError(f"the CUDA kernels take rows of {ROW_C} triangles, "
                             f"got {table.shape[2]}")
        if table.shape[0] * ROW_C >= 1 << 31:
            raise ValueError(f"K = {table.shape[0]} clusters: the flat index leaves int32")
        for name, x in packed:
            if not x.is_contiguous():
                raise ValueError(f"the CUDA kernels take a contiguous {name}")


def _check_state(p, d, best_t, best_c, best_l):
    n = p.shape[0]
    _want("p", p, (n, 3), torch.float32)
    _want("d", d, (n, 3), torch.float32)
    _want("best_t", best_t, (n,), torch.float32)
    _want("best_c", best_c, (n,), torch.int32)
    _want("best_l", best_l, (n,), torch.int32)
    return [("p", p), ("d", d), ("best_t", best_t), ("best_c", best_c), ("best_l", best_l)]


def _check_columns(col_t, col_c, n):
    if col_t.dim() != 2 or col_t.shape[0] != n or col_t.shape[1] < 1:
        raise ValueError(f"col_t must be ({n}, W >= 1), got {tuple(col_t.shape)}")
    _want("col_t", col_t, col_t.shape, torch.float32)
    _want("col_c", col_c, col_t.shape, torch.int32)
    if col_t.is_cuda:
        # a column range of a wider table: any row stride, unit column stride
        for name, x in (("col_t", col_t), ("col_c", col_c)):
            if x.shape[1] > 1 and x.stride(1) != 1:
                raise ValueError(f"the CUDA kernel takes {name} with unit column stride")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------------------
# row_gather
# ---------------------------------------------------------------------------

def _check_gather(idx, table, variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown row_gather variant {variant!r}; one of {VARIANTS}")
    if idx.dim() != 1:
        raise ValueError(f"idx must be (R,), got {tuple(idx.shape)}")
    _want("idx", idx, idx.shape, torch.int32)
    _check_table(table, [("idx", idx)], dtypes=(torch.float32,))


def row_gather_plain(idx, table, variant: str = "direct"):
    """Plain PyTorch version of ``row_gather``: indexing."""
    _check_gather(idx, table, variant)
    return table[idx.long()]


def row_gather(idx, table, variant: str = "direct"):
    """out[i] = table[idx[i]]: idx (R,) int32 in [0, K), table (K, 9, C)
    float32 -> (R, 9, C). The CUDA kernel (``direct`` or ``staged``) for
    CUDA tensors, indexing for CPU tensors."""
    if not table.is_cuda:
        return row_gather_plain(idx, table, variant)
    _check_gather(idx, table, variant)
    lib = build()
    r = idx.shape[0]
    out = torch.empty((r, 9, ROW_C), dtype=torch.float32, device=table.device)
    if r == 0:
        return out
    err = lib.row_gather_launch(idx.data_ptr(), table.data_ptr(), r, out.data_ptr(),
                                int(variant == "staged"), _stream(table))
    if err != 0:
        raise RuntimeError(f"row_gather ({variant}) launch failed: cudaError {err}")
    LAUNCHES["row_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# the dense Moller-Trumbore of rays against their own rows
# ---------------------------------------------------------------------------

def mt_rows(p, d, rows, best, live, cand_cids=None, cand_base=None):
    """Dense per-ray MT against each ray's own cluster row(s).

    p, d: (N, 3); rows: (N, W, 9, C) float32 component rows (a|e0|e1)
    (bf16 rows are upcast by the caller: the arithmetic is float32).
    best: (t, cid, lane), each (N,): the winner is a (cluster, lane)
    pair, mapped to a triangle id once per trace.
    live: (N,) ray mask or (N, W, C) candidate mask; dead rays and
    candidates keep their records.
    The winner's cluster id comes from exactly one of cand_cids (N, W)
    int32, the cluster of candidate block jc, or cand_base (N,) int32,
    when the candidates are the contiguous clusters cand_base + jc.
    A hit is taken only on t < best_t, and among equal t the first flat
    index (block-major, then lane) wins. A winning t of -0.0 (a ray that
    starts in a triangle's plane) is stored as +0.0, as the kernels do.
    """
    n, W, _, C = rows.shape
    t_m = _masked_t(p, d, rows, best[0], live).reshape(n, W * C)
    t_new = t_m.min(dim=1).values
    best_t, best_cid, best_lane = best
    better = t_new < best_t  # t_m is already gated on t < best_t
    # the first flat index at the minimum, by a masked-iota min
    col = torch.arange(W * C, dtype=torch.int32, device=p.device)[None, :]
    j = torch.where(t_m == t_new[:, None], col, 1 << 30).min(dim=1).values
    j = torch.where(better, j, 0)

    jc = j // C
    lane_new = j % C
    if cand_cids is not None:
        cid_new = cand_cids.gather(1, jc[:, None].long())[:, 0]
    else:
        cid_new = cand_base + jc
    return (
        torch.where(better, t_new + 0.0, best_t),  # -0.0 + 0.0 = +0.0
        torch.where(better, cid_new, best_cid),
        torch.where(better, lane_new, best_lane),
    )


def _masked_t(p, d, rows, best_t, live):
    """The Moller-Trumbore t of every (ray, row, lane) of ``mt_rows``,
    T_MAX where the hit is not valid, not below best_t or not live:
    (N, W, C)."""
    px, py, pz = p[:, 0, None, None], p[:, 1, None, None], p[:, 2, None, None]
    dx, dy, dz = d[:, 0, None, None], d[:, 1, None, None], d[:, 2, None, None]
    ax, ay, az = rows[:, :, 0], rows[:, :, 1], rows[:, :, 2]    # (N, W, C)
    e0x, e0y, e0z = rows[:, :, 3], rows[:, :, 4], rows[:, :, 5]
    e1x, e1y, e1z = rows[:, :, 6], rows[:, :, 7], rows[:, :, 8]

    pvx = dy * e1z - dz * e1y
    pvy = dz * e1x - dx * e1z
    pvz = dx * e1y - dy * e1x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    near0 = det.abs() < 1e-8
    ood = 1.0 / torch.where(near0, 1.0, det)
    tx = px - ax
    ty = py - ay
    tz = pz - az
    u = (tx * pvx + ty * pvy + tz * pvz) * ood
    qvx = ty * e0z - tz * e0y
    qvy = tz * e0x - tx * e0z
    qvz = tx * e0y - ty * e0x
    v = (dx * qvx + dy * qvy + dz * qvz) * ood
    t = (e1x * qvx + e1y * qvy + e1z * qvz) * ood
    ok = (
        ~near0
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
        & (t < best_t[:, None, None])
        & (live[:, None, None] if live.dim() == 1 else live)
    )
    return torch.where(ok, t, T_MAX)


# ---------------------------------------------------------------------------
# wave_mt
# ---------------------------------------------------------------------------

def live_columns(col_t, best_t, best_c, any_hit: bool):
    """The live gate of table entries col_t, (n,) or (n, w): nearer than
    the ray's best t, pending and, in an any-hit trace, of a ray without
    a hit."""
    if col_t.dim() == 2:
        best_t, best_c = best_t[:, None], best_c[:, None]
    live = (col_t < best_t) & (col_t < T_MAX)
    return live & (best_c < 0) if any_hit else live


def gate_plan(n: int, sms: int, blocks_per_sm: int) -> dict:
    """How ``wave_mt`` cuts n rays over warps: G rays a warp, the widest
    of GATES that still gives at least one wave of resident warps
    (``resident_warps`` = sms x blocks_per_sm x MT_WARPS), so that a
    dense wave keeps every SM busy; the narrowest when no width does. A
    wider gate makes a sparse wave cheaper (fewer warps meet it) and
    shares more rows."""
    resident_warps = sms * blocks_per_sm * MT_WARPS
    g = next((g for g in GATES if -(-n // g) >= resident_warps), GATES[-1])
    warps = -(-n // g)
    return {"g": g, "warps": warps, "blocks": -(-warps // MT_WARPS),
            "resident_warps": resident_warps}


def _occupancy(dev: torch.device, kernel: str, query):
    """(SMs, blocks of ``kernel`` resident on an SM) of a CUDA device;
    query(pointer to an int) asks the library, once a device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if (idx, kernel) not in _resident:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = query(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"{kernel} occupancy query failed: cudaError {err}")
        _resident[idx, kernel] = (torch.cuda.get_device_properties(idx).multi_processor_count,
                                  blocks.value)
    return _resident[idx, kernel]


def resident(lib, dev: torch.device, dtype=torch.float32):
    """(SMs, wave_mt blocks resident on an SM) of a CUDA device, for rows
    of ``dtype``."""
    bf16 = int(dtype == torch.bfloat16)
    return _occupancy(dev, f"wave_mt {dtype}",
                      lambda blocks: lib.wave_mt_blocks_per_sm(bf16, blocks))


def _gated_columns(col_t, col_c, best_t, best_c, any_hit, k):
    """wave_mt's gate, (n, w): a live column whose id also lies in
    [0, k), the only ids the kernel ever uses as an address."""
    return live_columns(col_t, best_t, best_c, any_hit) & (col_c >= 0) & (col_c < k)


def _lane_warps(n, g, order, device):
    """(rays the lanes take, each one's warp): lane ``at`` takes ray
    ``at``, or ``order[at]``, and lies in warp at // g."""
    if order is None:
        ray = torch.arange(n, device=device)
    else:
        ray = order.long()
    return ray, torch.arange(ray.shape[0], device=device) // g


def wave_groups(col_t, col_c, best_t, best_c, any_hit, k: int, g: int, order=None):
    """Rows ``wave_mt`` fetches with a gate of g rays a warp (meeting the
    rays in ``order`` when given): one for each (warp, column, cluster)
    that holds a live column."""
    lane_ray, lane_warp = _lane_warps(col_t.shape[0], g, order, col_t.device)
    live = _gated_columns(col_t, col_c, best_t, best_c, any_hit, k)[lane_ray]
    at, w = live.nonzero(as_tuple=True)
    keys = (lane_warp[at] * col_t.shape[1] + w) * k + col_c[lane_ray[at], w].long()
    return int(torch.unique(keys).numel())


def dedup_order(col_c, live):
    """The rays of a wave sorted by the cluster of their column (the live
    ones, each cluster's rays by index), then the dead ones: one device
    sort of (live ? cluster : 2^31 - 1) << 32 | ray, no host sync. col_c
    and live (n,); returns (n,) int32 for ``wave_mt(order=)``."""
    ray = torch.arange(col_c.shape[0], device=col_c.device)
    key = (torch.where(live, col_c.long(), DEAD_CLUSTER) << 32) | ray
    return (torch.sort(key).values & 0xFFFFFFFF).int()


def dedup_rows(rows_tbl, c1, live1, route: str, d_max: int):
    """The JAX package's ``_dedup_rows``: the rows of clusters c1 (ch,)
    for the rays of one wave, each DISTINCT cluster's row fetched once
    and routed to the rays that want it. route "gather": gathered again
    from the (ch,)-row compact buffer by each ray's rank; "onehot": a
    (ch, d_max) one-hot float32 product over the compact buffer (NaN and
    infinities zeroed first, one 1.0 term an output: exact, but a -0.0
    comes out as +0.0, as in JAX), or the direct gather when the wave
    holds more than d_max distinct clusters. A dead lane (live1 False)
    gets whatever row JAX gives it (zeros under the one-hot product); the
    caller masks it. Returns (ch, 9, C) in the table's type.

    The ray slot rides in the low bits of the cluster-id sort key, so
    the group ranks (a cumulative sum of first-of-group flags) scatter
    straight back to ray order. The keys are int64 here, so no scene is
    too large for them (JAX's int32 key gives up above 2^31 / 2^sbits
    clusters and gathers directly; the rows are the same either way)."""
    K = rows_tbl.shape[0]
    ch = c1.shape[0]
    dev = c1.device
    sbits = max(1, (ch - 1).bit_length())
    ids = torch.where(live1, c1.long(), K)  # dead lanes sort last, past every id
    key = (ids << sbits) | torch.arange(ch, device=dev)
    skey = torch.sort(key).values
    sid = skey >> sbits
    slot = skey & ((1 << sbits) - 1)
    prev = torch.cat([torch.full((1,), -1, dtype=sid.dtype, device=dev), sid[:-1]])
    uniq = (sid != prev) & (sid < K)
    # the cumulative sum of first-of-group flags is the group's ordinal for
    # every element of the group (later members add 0)
    rank = torch.cumsum(uniq.long(), 0) - 1
    rk_ray = torch.zeros((ch,), dtype=torch.long, device=dev)
    rk_ray[slot] = rank
    d_eff = ch if route == "gather" else min(d_max, ch)
    uniq_buf = torch.full((d_eff + 1,), K, dtype=torch.long, device=dev)
    uniq_buf[torch.where(uniq, rank, d_eff).clamp(max=d_eff)] = sid  # the last slot: the drops
    uniq_buf = uniq_buf[:d_eff]
    if route == "gather":
        return rows_tbl[uniq_buf.clamp(max=K - 1)][rk_ray]
    if int(uniq.sum()) > d_eff:  # the compact buffer overflows: gather directly
        return rows_tbl[torch.where(live1, c1.long(), 0)]
    crow = rows_tbl[uniq_buf.clamp(max=K - 1)]  # (d_eff, 9, C)
    flat = torch.nan_to_num(crow.reshape(d_eff, -1).float(), nan=0.0, posinf=0.0, neginf=0.0)
    oh = ((rk_ray[:, None] == torch.arange(d_eff, device=dev)[None, :])
          & live1[:, None]).float()
    return (oh @ flat).reshape((ch,) + tuple(rows_tbl.shape[1:])).to(rows_tbl.dtype)


def _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l, order=None):
    named = _check_state(p, d, best_t, best_c, best_l)
    _check_columns(col_t, col_c, p.shape[0])
    if order is not None:
        if order.dim() != 1 or order.shape[0] > p.shape[0]:
            raise ValueError(f"order must be (m <= {p.shape[0]},), got {tuple(order.shape)}")
        _want("order", order, order.shape, torch.int32)
        named.append(("order", order))
    _check_table(table, named, strided=[("col_t", col_t), ("col_c", col_c)])


def _work_begin(col_t, col_c, any_hit, best_t, best_c, k, order):
    """The part of a wave's WORK that its inputs decide, as device tensors
    ((pairs, distinct rows), the lanes, best t before the wave), or None
    when no torch.profiler session is active."""
    if not tracing():
        return None
    live = _gated_columns(col_t, col_c, best_t, best_c, any_hit, k)
    lanes = col_t.shape[0]
    if order is not None:
        listed = torch.zeros((lanes,), dtype=torch.bool, device=live.device)
        listed[order.long()] = True
        live = live & listed[:, None]
        lanes = order.shape[0]
    seen = torch.zeros((k + 1,), dtype=torch.int64, device=live.device)
    seen.scatter_(0, torch.where(live, col_c, k).long().reshape(-1), 1)  # k: no row
    return torch.stack([live.sum(), seen[:k].sum()]), lanes, best_t.clone()


def _work_end(begun, key, best_t):
    """Add a wave's counts to WORK[key, device] once the wave has run."""
    if begun is None:
        return
    (pairs, rows), lanes, before = begun
    acc = WORK.get((key, str(best_t.device)))
    if acc is None:
        acc = WORK[key, str(best_t.device)] = torch.zeros(
            (len(WORK_FIELDS),), dtype=torch.int64, device=best_t.device)
    acc[0] += pairs
    acc[1] += lanes
    acc[2] += (best_t < before).sum()
    acc[3] += rows


def _check_gate(gate):
    if gate is not None and gate not in GATES:
        raise ValueError(f"gate must be one of {GATES}, got {gate}")


def wave_mt_plain(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
                  chunk: int = WAVE_CHUNK, gate: int | None = None, order=None,
                  dedup: tuple | None = None):
    """Plain PyTorch version of ``wave_mt``: the rays with a live column,
    compacted by index (a host sync), ``chunk`` at a time: gate, masked
    row gather (a dead column reads row 0 and is masked), the rows upcast
    to float32, ``mt_rows``, and the winners written back by index.
    order: only the rays it lists (in any order) are met; the result does
    not depend on the order. dedup=(route, d_max), for one column (W = 1):
    the rows come through ``dedup_rows`` (the tracer's plain wave_dedup),
    fetched once a distinct cluster of the chunk; the same rows, so the
    same state.

    gate=G walks the kernel's decomposition instead: the lanes (rays in
    their order) in warps of G, per column the live rays of a warp
    grouped by cluster and each group's row gathered once, ``mt_rows`` of
    every (ray, column) against the best t of the call, and each ray's
    winners merged by the least (t, w * C + lane). It gives the same
    state (see the module's note)."""
    _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l, order)
    _check_gate(gate)
    if dedup is not None and (gate is not None or col_t.shape[1] != 1):
        raise ValueError("dedup takes one column and no gate")
    work = _work_begin(col_t, col_c, any_hit, best_t, best_c, table.shape[0], order)
    if gate is not None:
        _wave_mt_gated(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, gate, order)
    else:
        _wave_mt_compacted(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, chunk,
                           order, dedup)
    _work_end(work, _launch_key("wave_mt", table, order is not None), best_t)


def _wave_mt_compacted(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, chunk,
                       order, dedup):
    C = table.shape[2]
    live_ray = live_columns(col_t, best_t, best_c, any_hit).any(dim=1)
    if order is not None:  # only the listed rays
        live_ray = live_ray & torch.zeros_like(live_ray).index_fill_(0, order.long(), True)
    idx = live_ray.nonzero()[:, 0]
    for i0 in range(0, idx.shape[0], chunk):
        sel = idx[i0 : i0 + chunk]
        c = col_c[sel]
        cur = (best_t[sel], best_c[sel], best_l[sel])
        live = live_columns(col_t[sel], cur[0], cur[1], any_hit)
        if dedup is not None:
            rows = dedup_rows(table, c[:, 0], live[:, 0], *dedup)[:, None]
        else:
            rows = table[torch.where(live, c, 0).long()]  # (m, W, 9, C)
        new = mt_rows(p[sel], d[sel], rows.float(), cur, live[:, :, None].expand(-1, -1, C),
                      cand_cids=c)
        best_t[sel], best_c[sel], best_l[sel] = new


def _wave_mt_gated(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, g, order):
    K, _, C = table.shape
    n, W = col_t.shape
    lane_ray, lane_warp = _lane_warps(n, g, order, p.device)
    listed = torch.zeros((n,), dtype=torch.bool, device=p.device)
    listed[lane_ray] = True
    warp = torch.zeros((n,), dtype=torch.long, device=p.device)
    warp[lane_ray] = lane_warp
    live = _gated_columns(col_t, col_c, best_t, best_c, any_hit, K) & listed[:, None]
    start = best_t.clone()  # every column meets the best t of the call
    win_t = torch.full((n,), T_MAX, dtype=torch.float32, device=p.device)
    win_flat = torch.full((n,), 1 << 30, dtype=torch.int32, device=p.device)
    win_c = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    for w in range(W):
        sel = live[:, w].nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        cid = col_c[sel, w]
        groups, member = torch.unique(warp[sel] * K + cid.long(), return_inverse=True)
        rows = table[groups % K].float()              # one row a group
        m = sel.shape[0]
        fresh = (start[sel], torch.full((m,), -1, dtype=torch.int32, device=p.device),
                torch.zeros((m,), dtype=torch.int32, device=p.device))
        t, c, lane = mt_rows(p[sel], d[sel], rows[member][:, None], fresh,
                             torch.ones((m,), dtype=torch.bool, device=p.device),
                             cand_cids=cid[:, None])
        flat = w * C + lane
        take = (c >= 0) & ((t < win_t[sel]) | ((t == win_t[sel]) & (flat < win_flat[sel])))
        win_t[sel] = torch.where(take, t, win_t[sel])
        win_flat[sel] = torch.where(take, flat, win_flat[sel])
        win_c[sel] = torch.where(take, c, win_c[sel])
    won = win_c >= 0
    best_t.copy_(torch.where(won, win_t, best_t))
    best_c.copy_(torch.where(won, win_c, best_c))
    best_l.copy_(torch.where(won, win_flat % C, best_l))


def _launch_key(kernel, table, ordered=False):
    """The LAUNCHES key of a launch of ``kernel`` on ``table``'s row type."""
    return (kernel + ("_bf16" if table.dtype == torch.bfloat16 else "")
            + ("_ordered" if ordered else ""))


def wave_mt(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
            gate: int | None = None, order=None):
    """One wave over W front-table columns, the state updated in place.

    p, d (N, 3); table (K, 9, C) float32 or bf16; col_t (N, W) float32
    tnear and col_c (N, W) int32 cluster ids (a column range of the front
    table: any row stride); best_t (N,) float32, best_c and best_l (N,)
    int32. Every live column of a ray (col_t < best_t, col_t < T_MAX, and
    best_c < 0 when any_hit) is tested against the best t the ray had at
    the call; the minimum t wins, among equal t the lowest w * C + lane.
    order (m,) int32, m <= N distinct rays: the lanes meet those rays, in
    that order (``dedup_order``), and no other. The CUDA kernel for CUDA
    tensors, with G rays a warp from ``gate_plan`` unless ``gate`` names
    one of GATES; ``wave_mt_plain`` for CPU tensors."""
    if not p.is_cuda:
        return wave_mt_plain(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
                             gate=gate, order=order)
    _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l, order)
    _check_gate(gate)
    lib = build()
    n = p.shape[0] if order is None else order.shape[0]  # lanes
    if n == 0:
        return
    g = gate or gate_plan(n, *resident(lib, p.device, table.dtype))["g"]
    work = _work_begin(col_t, col_c, any_hit, best_t, best_c, table.shape[0], order)
    err = lib.wave_mt_launch(
        p.data_ptr(), d.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        table.shape[0], col_t.data_ptr(), col_c.data_ptr(), col_t.stride(0), col_c.stride(0),
        col_t.shape[1], int(bool(any_hit)), n, g,
        order.data_ptr() if order is not None else None,
        best_t.data_ptr(), best_c.data_ptr(), best_l.data_ptr(), _stream(p),
    )
    if err != 0:
        raise RuntimeError(f"wave_mt launch failed: cudaError {err}")
    key = _launch_key("wave_mt", table, order is not None)
    LAUNCHES[key] += 1
    _work_end(work, key, best_t)


# ---------------------------------------------------------------------------
# wave_sweep
# ---------------------------------------------------------------------------

def _check_sweep(p, d, table, idx, best_t, best_c, best_l):
    named = _check_state(p, d, best_t, best_c, best_l)
    if idx.dim() != 1:
        raise ValueError(f"idx must be (m,), got {tuple(idx.shape)}")
    _want("idx", idx, idx.shape, torch.int32)
    _check_table(table, named + [("idx", idx)])


def sweep_tile(m: int) -> int:
    """Rays a tile of ``wave_sweep`` for m listed rays, as the card timed
    them (PERF.md): a warp a tile of WARP_TILE rays up to 16 rays; then
    the rows staged for a block, tiles of STAGED_TILE rays."""
    return WARP_TILE if m <= 16 else STAGED_TILE


def sweep_plan(m: int, k: int, sms: int, blocks_per_sm: int) -> dict:
    """How ``wave_sweep`` cuts m listed rays x k clusters: ray tiles of
    ``sweep_tile(m)`` rays x ``splits`` cluster ranges of ``per_block``
    (the last may be short, none is empty), a block each. blocks_per_sm
    is the tile's kernel's occupancy. The
    splits aim at SWEEP_WAVES waves of resident blocks (``resident_blocks``
    = sms x blocks_per_sm), fewer when the sweep would give a block's
    warps (with the rows staged, a block) fewer than SWEEP_MIN_ROWS rows
    each on average, and never so many that they get fewer than that."""
    r = sweep_tile(m)
    tiles = -(-m // r)
    resident = sms * blocks_per_sm
    block_rows = (SWEEP_WARPS if r == WARP_TILE else 1) * SWEEP_MIN_ROWS
    waves = max(1, min(SWEEP_WAVES, tiles * k // (resident * block_rows)))
    splits = max(1, min(-(-resident * waves // tiles), -(-k // block_rows)))
    per_block = -(-k // splits)
    splits = -(-k // per_block)
    return {"tile": r, "tiles": tiles, "splits": splits, "per_block": per_block,
            "blocks": tiles * splits, "resident_blocks": resident}


def sweep_resident(lib, dev: torch.device, tile: int, dtype=torch.float32):
    """(SMs, wave_sweep blocks resident on an SM) of a CUDA device for a
    tile of ``tile`` rays and rows of ``dtype``."""
    bf16 = int(dtype == torch.bfloat16)
    return _occupancy(dev, f"wave_sweep tile {tile} {dtype}",
                      lambda blocks: lib.wave_sweep_blocks_per_sm(tile, bf16, blocks))


def _tile_keys(p, d, table, start, per):
    """The least (t bits << 32 | flat) key of each ray of a tile in each
    range of ``per`` clusters, among hits below ``start``, merged over
    the ranges by the minimum; NO_KEY without a hit. Whole ranges are
    taken a step at a time, at most about FB_ELEMS pairs a step (one
    range at least)."""
    K, _, C = table.shape
    n = p.shape[0]
    dev = p.device
    keys = torch.full((n,), NO_KEY, dtype=torch.int64, device=dev)
    step = max(1, FB_ELEMS // (n * per * C)) * per
    live = torch.ones((n,), dtype=torch.bool, device=dev)
    for a in range(0, K, step):
        rows = table[a : min(a + step, K)].float()
        t_m = _masked_t(p, d, rows[None].expand(n, -1, -1, -1), start, live)
        ranges = -(-rows.shape[0] // per)
        pad = ranges * per - rows.shape[0]  # a short last range
        t_m = torch.nn.functional.pad(t_m, (0, 0, 0, pad), value=T_MAX)
        t_r = t_m.reshape(n, ranges, per * C)
        t_min = t_r.min(dim=2).values
        col = torch.arange(per * C, dtype=torch.int64, device=dev)
        j = torch.where(t_r == t_min[:, :, None], col, 1 << 40).min(dim=2).values
        flat = (a + per * torch.arange(ranges, device=dev))[None, :] * C + j
        key = ((t_min + 0.0).view(torch.int32).long() << 32) | flat  # -0.0 -> +0.0
        key = torch.where(t_min < start[:, None], key, NO_KEY)
        keys = torch.minimum(keys, key.min(dim=1).values)
    return keys


def _wave_sweep_cut(p, d, table, idx, best_t, best_c, best_l, plan):
    K, _, C = table.shape
    m = idx.shape[0]
    r, splits, per = plan["tile"], plan["splits"], plan["per_block"]
    if not (splits >= 1 and per >= 1 and (splits - 1) * per < K <= splits * per):
        raise ValueError(f"the plan's {splits} ranges of {per} do not cut {K} clusters")
    sel = idx.long()
    start = best_t[sel]  # every range meets the best t of the call
    keys = torch.cat([_tile_keys(p[sel[j0 : j0 + r]], d[sel[j0 : j0 + r]], table,
                                 start[j0 : j0 + r], per) for j0 in range(0, m, r)])
    won = keys != NO_KEY
    ray, key = sel[won], keys[won]
    flat = (key & 0xFFFFFFFF).int()
    best_t[ray] = (key >> 32).int().view(torch.float32)
    best_c[ray] = flat // C
    best_l[ray] = flat % C


def wave_sweep_plain(p, d, table, idx, best_t, best_c, best_l, fb_cc: int = 0,
                     plan: dict | None = None):
    """Plain PyTorch version of ``wave_sweep``: up to FB_RAYS of the
    listed rays at a time against ascending blocks of CC clusters
    (fb_cc, or as many as FB_ELEMS pairs allow), the last block
    overlapping the one before; each block's rows upcast to float32.

    plan (from ``sweep_plan``) walks the kernel's decomposition instead:
    ray tiles x cluster ranges, each (tile, range) against the best t of
    the call, every ray's least (t, flat) key taken over the ranges. It
    gives the same state (see the module's note)."""
    _check_sweep(p, d, table, idx, best_t, best_c, best_l)
    if plan is not None:
        return _wave_sweep_cut(p, d, table, idx, best_t, best_c, best_l, plan)
    K, _, C = table.shape
    for i0 in range(0, idx.shape[0], FB_RAYS):
        sel = idx[i0 : i0 + FB_RAYS].long()
        m = sel.shape[0]
        CC = min(fb_cc or max(1, FB_ELEMS // (m * C)), K)
        rp, rd = p[sel], d[sel]
        cur = (best_t[sel], best_c[sel], best_l[sel])
        live = torch.ones((m,), dtype=torch.bool, device=p.device)
        for k in range(-(-K // CC)):
            cstart = min(k * CC, K - CC)
            rows = table[cstart : cstart + CC].float()[None].expand(m, -1, -1, -1)
            base = torch.full((m,), cstart, dtype=torch.int32, device=p.device)
            cur = mt_rows(rp, rd, rows, cur, live, cand_base=base)
        best_t[sel], best_c[sel], best_l[sel] = cur


def _sweep_scratch(dev: torch.device, m: int, tiles: int):
    """The kernel's keys (every one "none", ~0) and per-tile counters
    (every one 0) on dev, as every call leaves them; made anew, larger,
    when a call needs more than they hold. Shared by the calls on a
    device, so they must not overlap: calls on one stream do not."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    keys, done = _scratch.get(idx, (None, None))
    if keys is None or keys.shape[0] < m:
        keys = torch.full((max(m, 4096),), -1, dtype=torch.int64, device=dev)
    if done is None or done.shape[0] < tiles:
        done = torch.zeros((max(tiles, 4096),), dtype=torch.int32, device=dev)
    _scratch[idx] = keys, done
    return keys, done


def wave_sweep(p, d, table, idx, best_t, best_c, best_l):
    """The exact fallback for the rays idx (m,) int32: every cluster of
    the table (float32 or bf16 rows); the hit of least t below the ray's
    best t wins, among equal t the lowest cluster, then lane. The state
    is updated in place.
    The CUDA kernel for CUDA tensors, one launch cut as ``sweep_plan``
    says; ``wave_sweep_plain`` for CPU tensors."""
    if not p.is_cuda:
        return wave_sweep_plain(p, d, table, idx, best_t, best_c, best_l)
    _check_sweep(p, d, table, idx, best_t, best_c, best_l)
    lib = build()
    m, k = idx.shape[0], table.shape[0]
    if m == 0 or k == 0:
        return
    plan = sweep_plan(m, k, *sweep_resident(lib, p.device, sweep_tile(m), table.dtype))
    keys, done = _sweep_scratch(p.device, m, plan["tiles"])
    err = lib.wave_sweep_launch(
        p.data_ptr(), d.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16), k,
        idx.data_ptr(), m, plan["tile"], plan["splits"], plan["per_block"], best_t.data_ptr(),
        best_c.data_ptr(), best_l.data_ptr(), keys.data_ptr(), done.data_ptr(), _stream(p),
    )
    if err != 0:
        raise RuntimeError(f"wave_sweep launch failed: cudaError {err}")
    LAUNCHES[_launch_key("wave_sweep", table)] += 1

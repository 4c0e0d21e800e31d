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
    a list of rays (the ``cand_base`` form of ``_mt_rows``).

The kernels are in ``csrc/wave.cu``, compiled with ``nvcc`` at first use
into ``build/torch_kernels/`` and bound with ctypes. A wrapper given CPU
tensors runs the plain version; a wrapper given CUDA tensors launches
the kernel, counts the launch in ``LAUNCHES`` and raises if the build or
the launch fails. Nothing falls back from one to the other.

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
walk. The kernel cuts a ray's clusters over many blocks and takes that
minimum with an atomic.
"""
from __future__ import annotations

import ctypes

import torch

from phosphorus_mk2_tpu_torch.accel.build import CSRC, NVCC_FLAGS, compile_shared, find_nvcc
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX

ROW_C = 128          # triangles of a cluster row (csrc/wave.cu C)
WAVE_CHUNK = 1 << 17  # rays per step of wave_mt_plain unless the caller says
FB_RAYS = 2048       # most rays per step of wave_sweep_plain
FB_ELEMS = 1 << 24   # (ray, triangle) pairs per step of wave_sweep_plain:
                     # 64 MB a float32 temporary of the MT; 64 clusters a
                     # step at FB_RAYS rays, every cluster at once for a few
VARIANTS = ("direct", "staged")
GATES = (32, 16, 8)  # rays a warp that wave_mt's gate takes, the widest first
MT_WARPS = 8         # csrc/wave.cu MT_WARPS: warps a block of wave_mt

LAUNCHES = {"row_gather": 0, "wave_mt": 0, "wave_sweep": 0}

_lib = None
_resident = {}  # device index -> (SMs, wave_mt blocks resident on an SM)
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def build() -> ctypes.CDLL:
    """Compile csrc/wave.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    out, build_log = compile_shared(CSRC / "wave.cu", find_nvcc(), NVCC_FLAGS, "wave")
    lib = ctypes.CDLL(str(out))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.row_gather_launch.argtypes = [vp, vp, i32, vp, i32, vp]
    lib.wave_mt_blocks_per_sm.argtypes = [vp]
    lib.wave_mt_launch.argtypes = [vp, vp, vp, i32, vp, vp, i64, i64, i32, i32, i32, i32,
                                   vp, vp, vp, vp]
    lib.wave_sweep_launch.argtypes = [vp, vp, vp, i32, vp, i32, vp, vp, vp, vp, vp]
    for fn in (lib.row_gather_launch, lib.wave_mt_blocks_per_sm, lib.wave_mt_launch,
               lib.wave_sweep_launch):
        fn.restype = i32
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _want(name, x, shape, dtype):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(x.shape)} {x.dtype}")


def _check_table(table, packed, strided=()):
    """The (K, 9, C) row table and the (name, tensor) pairs that go with
    it: one device and a contiguous table (a slice of one is refused
    everywhere, so that a caller meets the kernels' rule on the CPU
    too); for the kernels a 16-byte aligned table of C = 128 (a bulk
    copy takes whole 16-byte units) and contiguous ``packed`` tensors
    (``strided`` ones carry their own strides)."""
    if table.dtype != torch.float32 or table.dim() != 3 or table.shape[1] != 9:
        raise ValueError(f"table must be (K, 9, C) float32, got {tuple(table.shape)} {table.dtype}")
    if any(x.device != table.device for _, x in (*packed, *strided)):
        raise ValueError("the table and every other tensor must lie on one device")
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
    _check_table(table, [("idx", idx)])


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

    p, d: (N, 3); rows: (N, W, 9, C) float32 component rows (a|e0|e1).
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

    best_t, best_cid, best_lane = best
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
    t_m = torch.where(ok, t, T_MAX).reshape(n, W * C)
    t_new = t_m.min(dim=1).values
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


def resident(lib, dev: torch.device):
    """(SMs, wave_mt blocks resident on an SM) of a CUDA device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _resident:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.wave_mt_blocks_per_sm(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"wave_mt occupancy query failed: cudaError {err}")
        _resident[idx] = (torch.cuda.get_device_properties(idx).multi_processor_count,
                          blocks.value)
    return _resident[idx]


def _gated_columns(col_t, col_c, best_t, best_c, any_hit, k):
    """wave_mt's gate, (n, w): a live column whose id also lies in
    [0, k), the only ids the kernel ever uses as an address."""
    return live_columns(col_t, best_t, best_c, any_hit) & (col_c >= 0) & (col_c < k)


def wave_groups(col_t, col_c, best_t, best_c, any_hit, k: int, g: int):
    """Rows ``wave_mt`` fetches with a gate of g rays a warp: one for each
    (warp, column, cluster) that holds a live column."""
    live = _gated_columns(col_t, col_c, best_t, best_c, any_hit, k)
    ray, w = live.nonzero(as_tuple=True)
    keys = ((ray // g) * col_t.shape[1] + w) * k + col_c[ray, w].long()
    return int(torch.unique(keys).numel())


def _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l):
    named = _check_state(p, d, best_t, best_c, best_l)
    _check_columns(col_t, col_c, p.shape[0])
    _check_table(table, named, strided=[("col_t", col_t), ("col_c", col_c)])


def _check_gate(gate):
    if gate is not None and gate not in GATES:
        raise ValueError(f"gate must be one of {GATES}, got {gate}")


def wave_mt_plain(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
                  chunk: int = WAVE_CHUNK, gate: int | None = None):
    """Plain PyTorch version of ``wave_mt``: the rays with a live column,
    compacted by index (a host sync), ``chunk`` at a time: gate, masked
    row gather (a dead column reads row 0 and is masked), ``mt_rows``,
    and the winners written back by index.

    gate=G walks the kernel's decomposition instead: rays in warps of G,
    per column the live rays of a warp grouped by cluster and each
    group's row gathered once, ``mt_rows`` of every (ray, column) against
    the best t of the call, and each ray's winners merged by the least
    (t, w * C + lane). It gives the same state (see the module's note)."""
    _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l)
    _check_gate(gate)
    if gate is not None:
        return _wave_mt_gated(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, gate)
    C = table.shape[2]
    idx = live_columns(col_t, best_t, best_c, any_hit).any(dim=1).nonzero()[:, 0]
    for i0 in range(0, idx.shape[0], chunk):
        sel = idx[i0 : i0 + chunk]
        c = col_c[sel]
        cur = (best_t[sel], best_c[sel], best_l[sel])
        live = live_columns(col_t[sel], cur[0], cur[1], any_hit)
        rows = table[torch.where(live, c, 0).long()]  # (m, W, 9, C)
        new = mt_rows(p[sel], d[sel], rows, cur, live[:, :, None].expand(-1, -1, C),
                      cand_cids=c)
        best_t[sel], best_c[sel], best_l[sel] = new


def _wave_mt_gated(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l, g):
    K, _, C = table.shape
    n, W = col_t.shape
    live = _gated_columns(col_t, col_c, best_t, best_c, any_hit, K)
    start = best_t.clone()  # every column meets the best t of the call
    win_t = torch.full((n,), T_MAX, dtype=torch.float32, device=p.device)
    win_flat = torch.full((n,), 1 << 30, dtype=torch.int32, device=p.device)
    win_c = torch.full((n,), -1, dtype=torch.int32, device=p.device)
    warp = torch.arange(n, device=p.device) // g
    for w in range(W):
        sel = live[:, w].nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        cid = col_c[sel, w]
        groups, member = torch.unique(warp[sel] * K + cid.long(), return_inverse=True)
        rows = table[groups % K]                      # one row a group
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


def wave_mt(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
            gate: int | None = None):
    """One wave over W front-table columns, the state updated in place.

    p, d (N, 3); table (K, 9, C); col_t (N, W) float32 tnear and col_c
    (N, W) int32 cluster ids (a column range of the front table: any row
    stride); best_t (N,) float32, best_c and best_l (N,) int32. Every
    live column of a ray (col_t < best_t, col_t < T_MAX, and best_c < 0
    when any_hit) is tested against the best t the ray had at the call;
    the minimum t wins, among equal t the lowest w * C + lane. The CUDA
    kernel for CUDA tensors, with G rays a warp from ``gate_plan`` unless
    ``gate`` names one of GATES; ``wave_mt_plain`` for CPU tensors."""
    if not p.is_cuda:
        return wave_mt_plain(p, d, table, col_t, col_c, any_hit, best_t, best_c, best_l,
                             gate=gate)
    _check_wave(p, d, table, col_t, col_c, best_t, best_c, best_l)
    _check_gate(gate)
    lib = build()
    n = p.shape[0]
    if n == 0:
        return
    g = gate or gate_plan(n, *resident(lib, p.device))["g"]
    err = lib.wave_mt_launch(
        p.data_ptr(), d.data_ptr(), table.data_ptr(), table.shape[0],
        col_t.data_ptr(), col_c.data_ptr(), col_t.stride(0), col_c.stride(0),
        col_t.shape[1], int(bool(any_hit)), n, g,
        best_t.data_ptr(), best_c.data_ptr(), best_l.data_ptr(), _stream(p),
    )
    if err != 0:
        raise RuntimeError(f"wave_mt launch failed: cudaError {err}")
    LAUNCHES["wave_mt"] += 1


# ---------------------------------------------------------------------------
# wave_sweep
# ---------------------------------------------------------------------------

def _check_sweep(p, d, table, idx, best_t, best_c, best_l):
    named = _check_state(p, d, best_t, best_c, best_l)
    if idx.dim() != 1:
        raise ValueError(f"idx must be (m,), got {tuple(idx.shape)}")
    _want("idx", idx, idx.shape, torch.int32)
    _check_table(table, named + [("idx", idx)])


def wave_sweep_plain(p, d, table, idx, best_t, best_c, best_l, fb_cc: int = 0):
    """Plain PyTorch version of ``wave_sweep``: up to FB_RAYS of the
    listed rays at a time against ascending blocks of CC clusters
    (fb_cc, or as many as FB_ELEMS pairs allow), the last block
    overlapping the one before."""
    _check_sweep(p, d, table, idx, best_t, best_c, best_l)
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
            rows = table[cstart : cstart + CC][None].expand(m, -1, -1, -1)
            base = torch.full((m,), cstart, dtype=torch.int32, device=p.device)
            cur = mt_rows(rp, rd, rows, cur, live, cand_base=base)
        best_t[sel], best_c[sel], best_l[sel] = cur


def wave_sweep(p, d, table, idx, best_t, best_c, best_l):
    """The exact fallback for the rays idx (m,) int32: every cluster of
    the table; the hit of least t below the ray's best t wins, among
    equal t the lowest cluster, then lane. The state is updated in place.
    The CUDA kernel for CUDA tensors, ``wave_sweep_plain`` for CPU
    tensors."""
    if not p.is_cuda:
        return wave_sweep_plain(p, d, table, idx, best_t, best_c, best_l)
    _check_sweep(p, d, table, idx, best_t, best_c, best_l)
    lib = build()
    m = idx.shape[0]
    if m == 0 or table.shape[0] == 0:
        return
    keys = torch.empty((m,), dtype=torch.int64, device=p.device)
    err = lib.wave_sweep_launch(
        p.data_ptr(), d.data_ptr(), table.data_ptr(), table.shape[0], idx.data_ptr(), m,
        best_t.data_ptr(), best_c.data_ptr(), best_l.data_ptr(), keys.data_ptr(), _stream(p),
    )
    if err != 0:
        raise RuntimeError(f"wave_sweep launch failed: cudaError {err}")
    LAUNCHES["wave_sweep"] += 1

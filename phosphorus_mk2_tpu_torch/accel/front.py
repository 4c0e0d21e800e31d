"""Front-table kernels of the cluster tracer: two hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Counterpart of ``phosphorus_mk2_tpu/accel/pallas_front.py``:
  * ``front_full`` replaces ``_kernel_full`` and the row sort that
    ``front_all_pallas`` runs on its output (the whole two-level front
    table of a ray: supercluster slab, the jj nearest parents as packed
    keys, member expansion, and the kk smallest packed candidate keys in
    ascending order, selected inside the kernel);
  * ``front_slab_extract`` replaces ``_kernel`` (the supercluster slab
    and the jj nearest parents only).
``front_all`` and ``slab_extract`` add what is left of the JAX wrappers
``front_all_pallas`` and ``slab_extract_pallas``: the decoding of keys
into (t, id).

The kernels are in ``csrc/front.cu``, compiled with ``nvcc`` at first use
into ``build/torch_kernels/`` and bound with ctypes. A wrapper given CPU
tensors runs the plain version; a wrapper given CUDA tensors launches
the kernel, counts the launch in ``LAUNCHES`` and raises if the build or
the launch fails. Nothing falls back from one to the other.

Packed keys. A key is an int32: the float bits of a non-negative tnear
with its low ``nbits`` mantissa bits replaced by a column id. Bit order
is float order for non-negative floats, so integer min and sort order
the keys front to back, ties to the lower column. The parent keys keep
the reference kernel's width, ``bit_length(K2p - 1)`` with K2p = K2
rounded up to 128, though nothing is padded here, so that keys equal the
reference kernel's. A key whose masked bits reach those of T_MAX decodes
to T_MAX (not pending). Keys never pass through a float operation: a key
of tnear = 0 is a float denormal.

NaN. Empty table slots hold NaN bounds and must miss: the plain versions
use ``torch.minimum``/``torch.maximum``, which propagate NaN (never
``fmin``/``fmax``), and the kernels make such a box a miss by
construction (the NaN rule of ``csrc/front.cu``). Member
slots keep their NaN; the JAX wrapper's far point boxes exist only
because its one-hot matmul cannot carry NaN. Both decode to T_MAX.

Selection. Keys are unique (the column rides in the low bits), so the kk
smallest candidate keys in ascending order are ``sort(keys)[:, :kk]`` to
the bit, whatever selects them: ``front_full_plain(kk=)`` sorts; the
kernel pops the pending keys from per-lane sorted windows and places the
far ones (3.4e38 with their column, in column order) by ballot. Given kk > jj * SC the
prefix is the whole sorted row, as in the JAX wrapper.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from phosphorus_mk2_tpu_torch.accel.build import CSRC, NVCC_FLAGS, find_nvcc, load_shared
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
from phosphorus_mk2_tpu_torch.utils.profiling import counted

RAY_CHUNK = 16384    # rays per step of the plain versions (bounds their temporaries)
DEAD_KEY = 0x7FFFFFFF
# dynamic shared memory a block may ask for on sm_90 (227 KB)
MAX_SHARED = 232448
_WARPS = 8           # csrc/front.cu WARPS
_T_MAX_BITS = struct.unpack("<i", struct.pack("<f", T_MAX))[0]  # of float32(3.4e38)

LAUNCHES = counted("accel.front.LAUNCHES", {"front_full": 0, "front_slab_extract": 0})

_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def build() -> ctypes.CDLL:
    """Compile csrc/front.cu (once per source and flags) and load it."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    lib, build_log = load_shared(CSRC / "front.cu", find_nvcc(), NVCC_FLAGS, "front")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.front_full_launch.argtypes = [vp] * 7 + [i32] * 7 + [vp, vp, vp]
    lib.front_full_launch.restype = i32
    lib.front_slab_extract_launch.argtypes = [vp] * 5 + [i32] * 4 + [vp, vp]
    lib.front_slab_extract_launch.restype = i32
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# packed keys
# ---------------------------------------------------------------------------

def key_bits(nvals: int) -> int:
    """Low mantissa bits that hold an id in [0, nvals)."""
    return max(1, (nvals - 1).bit_length())


def parent_key_bits(k2: int) -> int:
    """Key width of the parent keys: that of K2 rounded up to 128, the
    reference kernel's padded table width."""
    return key_bits(-(-k2 // 128) * 128)


def tmax_key(nbits: int) -> int:
    """The masked bits of T_MAX: a key at or above it is not pending."""
    return _T_MAX_BITS & -(1 << nbits)


def clamp0(t):
    """max(t, 0) whose zero is +0.0: ``torch.maximum`` may keep the sign
    of a -0.0 (a ray origin on the plane of a flat box, direction away),
    and the bits of -0.0 are a NEGATIVE int32 key that sorts before every
    +0.0 key whatever its column. -0.0 + 0.0 is +0.0; any other value,
    NaN included, passes the sum unchanged."""
    return torch.maximum(t, torch.zeros((), dtype=t.dtype, device=t.device)) + 0.0


def pack_keys(t, nbits: int, ids=None):
    """(float bits of t & mask) | id, as int32. t (..., M) non-negative
    float32; ids default to the column index."""
    if ids is None:
        ids = torch.arange(t.shape[-1], dtype=torch.int32, device=t.device)
    return (t.contiguous().view(torch.int32) & -(1 << nbits)) | ids


def decode_keys(keys, nbits: int):
    """Split packed int32 keys into (t float32, id int32)."""
    mask = -(1 << nbits)
    masked = keys & mask
    ids = keys & ((1 << nbits) - 1)
    t = torch.where(masked >= tmax_key(nbits), T_MAX, masked.view(torch.float32))
    return t, ids


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check(sc_bmin, sc_bmax, p, d, t_limit, jj, members=None, kk=None):
    k2 = sc_bmin.shape[0]
    n = p.shape[0]
    want = [("sc_bmin", sc_bmin, (k2, 3)), ("sc_bmax", sc_bmax, (k2, 3)),
            ("p", p, (n, 3)), ("d", d, (n, 3)), ("t_limit", t_limit, (n,))]
    if members is not None:
        sc = members[0].shape[1] if members[0].dim() == 3 else -1
        want += [("member bmin", members[0], (k2, sc, 3)),
                 ("member bmax", members[1], (k2, sc, 3))]
    for name, x, shape in want:
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(x.shape)} {x.dtype}")
    tensors = [x for _, x, _ in want]
    if any(x.device != p.device for x in tensors):
        raise ValueError("tables, rays and t_limit must lie on one device")
    if any(x.requires_grad for x in tensors):
        raise ValueError("the tracer kernels are primal: trace under torch.no_grad() "
                         "on detached tensors, not on tensors that require grad")
    if not 1 <= jj <= k2:
        raise ValueError(f"jj must be in [1, K2 = {k2}], got {jj}")
    if kk is not None and kk < 1:
        raise ValueError(f"kk must be >= 1, got {kk}")
    if p.is_cuda:
        if not all(x.is_contiguous() for x in tensors):
            raise ValueError("the CUDA kernels take contiguous tensors")
        shared = (6 * k2 + _WARPS * jj) * 4
        if shared > MAX_SHARED:
            raise ValueError(
                f"K2 = {k2} superclusters need {shared} bytes of shared memory per "
                f"block, more than the {MAX_SHARED} a block can have"
            )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _slab(bmin, bmax, p, inv):
    """Slab interval of rays (N, 3) against boxes bmin/bmax (..., 3) that
    broadcast against (N, ...): the running max of mins from -3.4e38 and
    min of maxes from +3.4e38, per axis, NaN propagating. Returns the raw
    (tn, tf)."""
    extra = (1,) * (bmin.dim() - 2)
    tn = tf = None
    for a in range(3):
        pa = p[:, a].reshape(-1, *extra)
        ia = inv[:, a].reshape(-1, *extra)
        t0 = (bmin[..., a] - pa) * ia
        t1 = (bmax[..., a] - pa) * ia
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tn = torch.maximum(torch.full_like(lo, -T_MAX), lo) if tn is None else torch.maximum(tn, lo)
        tf = torch.minimum(torch.full_like(hi, T_MAX), hi) if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _parents_plain(sc_bmin, sc_bmax, p, d, t_limit, jj, nbits_p):
    """Stages 1 and 2 for one ray chunk: packed parent keys (n, jj), and
    the reciprocal directions for stage 3."""
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    tn, tf = _slab(sc_bmin[None], sc_bmax[None], p, inv)
    tnc = clamp0(tn)  # the clamp comes BEFORE the limit test
    pending = (tn <= tf) & (tf >= 0.0) & (tnc < t_limit[:, None])
    keys = pack_keys(torch.where(pending, tnc, T_MAX), nbits_p)
    outs = []
    for _ in range(jj):
        m = keys.min(dim=1, keepdim=True).values
        outs.append(m)
        keys = torch.where(keys == m, DEAD_KEY, keys)
    return torch.cat(outs, dim=1), inv


def front_slab_extract_plain(sc_bmin, sc_bmax, p, d, t_limit, jj: int):
    """Plain PyTorch version of ``front_slab_extract``: packed parent
    keys (N, jj) int32, ascending."""
    _check(sc_bmin, sc_bmax, p, d, t_limit, jj)
    nbits_p = parent_key_bits(sc_bmin.shape[0])
    out = torch.empty((p.shape[0], jj), dtype=torch.int32, device=p.device)
    for r0 in range(0, p.shape[0], RAY_CHUNK):
        s = slice(r0, r0 + RAY_CHUNK)
        out[s], _ = _parents_plain(sc_bmin, sc_bmax, p[s], d[s], t_limit[s], jj, nbits_p)
    return out


def front_full_plain(sc_bmin, sc_bmax, mb_min, mb_max, p, d, t_limit, jj: int,
                     kk: int | None = None):
    """Plain PyTorch version of ``front_full``: (packed parent keys
    (N, jj), packed candidate keys), both int32. Without kk the candidate
    keys are (N, jj * SC), column = j * SC + s, unsorted; given kk, the
    min(kk, jj * SC) smallest of each row, ascending."""
    _check(sc_bmin, sc_bmax, p, d, t_limit, jj, members=(mb_min, mb_max), kk=kk)
    k2, sc = mb_min.shape[0], mb_min.shape[1]
    nbits_p = parent_key_bits(k2)
    nbits_c = key_bits(jj * sc)
    n = p.shape[0]
    out_p = torch.empty((n, jj), dtype=torch.int32, device=p.device)
    out_c = torch.empty((n, _cand_width(jj * sc, kk)), dtype=torch.int32, device=p.device)
    for r0 in range(0, n, RAY_CHUNK):
        s = slice(r0, r0 + RAY_CHUNK)
        pk, inv = _parents_plain(sc_bmin, sc_bmax, p[s], d[s], t_limit[s], jj, nbits_p)
        out_p[s] = pk
        valid = (pk & -(1 << nbits_p)) < tmax_key(nbits_p)            # (n, jj)
        pid = torch.where(valid, pk & ((1 << nbits_p) - 1), 0).long()
        tn, tf = _slab(mb_min[pid], mb_max[pid], p[s], inv)           # (n, jj, SC)
        # the RAW tn meets the limit here; the clamp comes AFTER
        hit = ((tn <= tf) & (tf >= 0.0) & valid[:, :, None]
               & (tn < t_limit[s][:, None, None]) & (tn < 1e37))
        cand = torch.where(hit, clamp0(tn), T_MAX)
        ck = pack_keys(cand.reshape(-1, jj * sc), nbits_c)
        if kk is not None:
            ck = torch.sort(ck, dim=1).values[:, : out_c.shape[1]]
        out_c[s] = ck
    return out_p, out_c


def _cand_width(width: int, kk: int | None) -> int:
    """Columns of the candidate keys: all of them, or the kk smallest."""
    return width if kk is None else min(kk, width)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def front_slab_extract(sc_bmin, sc_bmax, p, d, t_limit, jj: int):
    """Packed parent keys (N, jj) int32: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if not p.is_cuda:
        return front_slab_extract_plain(sc_bmin, sc_bmax, p, d, t_limit, jj)
    _check(sc_bmin, sc_bmax, p, d, t_limit, jj)
    lib = build()
    n, k2 = p.shape[0], sc_bmin.shape[0]
    out_p = torch.empty((n, jj), dtype=torch.int32, device=p.device)
    if n == 0:
        return out_p
    err = lib.front_slab_extract_launch(
        sc_bmin.data_ptr(), sc_bmax.data_ptr(), p.data_ptr(), d.data_ptr(),
        t_limit.data_ptr(), n, k2, jj, parent_key_bits(k2), out_p.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"front_slab_extract launch failed: cudaError {err}")
    LAUNCHES["front_slab_extract"] += 1
    return out_p


def front_full(sc_bmin, sc_bmax, mb_min, mb_max, p, d, t_limit, jj: int,
               kk: int | None = None):
    """(packed parent keys (N, jj), packed candidate keys): the candidate
    keys by column (N, jj * SC) without kk, or given kk the min(kk,
    jj * SC) smallest of each row, ascending. The CUDA kernel for CUDA
    tensors (given kk, it selects them itself), the plain version for CPU
    tensors."""
    if not p.is_cuda:
        return front_full_plain(sc_bmin, sc_bmax, mb_min, mb_max, p, d, t_limit, jj, kk)
    _check(sc_bmin, sc_bmax, p, d, t_limit, jj, members=(mb_min, mb_max), kk=kk)
    lib = build()
    n, k2, sc = p.shape[0], mb_min.shape[0], mb_min.shape[1]
    out_p = torch.empty((n, jj), dtype=torch.int32, device=p.device)
    out_c = torch.empty((n, _cand_width(jj * sc, kk)), dtype=torch.int32, device=p.device)
    if n == 0:
        return out_p, out_c
    err = lib.front_full_launch(
        sc_bmin.data_ptr(), sc_bmax.data_ptr(), mb_min.data_ptr(), mb_max.data_ptr(),
        p.data_ptr(), d.data_ptr(), t_limit.data_ptr(), n, k2, jj, sc, kk or 0,
        parent_key_bits(k2), key_bits(jj * sc), out_p.data_ptr(), out_c.data_ptr(),
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"front_full launch failed: cudaError {err}")
    LAUNCHES["front_full"] += 1
    return out_p, out_c


# ---------------------------------------------------------------------------
# what the JAX wrappers do around their kernels
# ---------------------------------------------------------------------------

def slab_extract(sc_bmin, sc_bmax, p, d, t_limit, jj: int = 16, plain: bool = False):
    """The jj nearest pending superclusters of every ray, front to back:
    (t (N, jj) float32, id (N, jj) int32), as ``slab_extract_pallas``.
    plain=True takes the plain version on any device."""
    fn = front_slab_extract_plain if plain else front_slab_extract
    keys = fn(sc_bmin, sc_bmax, p, d, t_limit, jj)
    return decode_keys(keys, parent_key_bits(sc_bmin.shape[0]))


def front_all(sc_bmin, sc_bmax, mb_min, mb_max, p, d, t_limit, jj: int = 16,
              kk: int = 32, plain: bool = False):
    """The whole two-level front table, as ``front_all_pallas``: returns
    (ttbl (N, kk') float32, col (N, kk') int32 in [0, jj * SC), parent_t
    (N, jj) float32, parent_id (N, jj) int32), kk' = min(kk, jj * SC).
    ``front_full`` selects the kk nearest candidates (the kernel inside
    itself, where the JAX wrapper sorts the kernel's rows). Decode
    cluster ids with ``cluster_traverse._reconstruct_ids``. plain=True
    takes the plain version on any device."""
    fn = front_full_plain if plain else front_full
    pk, ck = fn(sc_bmin, sc_bmax, mb_min, mb_max, p, d, t_limit, jj, kk)
    pt, pid = decode_keys(pk, parent_key_bits(sc_bmin.shape[0]))
    ct, col = decode_keys(ck, key_bits(jj * mb_min.shape[1]))
    return ct, col, pt, pid

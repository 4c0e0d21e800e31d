"""Gather-wave cluster tracer: the traversal for BVH scenes.

Counterpart of ``phosphorus_mk2_tpu/accel/cluster_traverse.py``. The
scene's triangles are cut into K clusters of up to 128 (contiguous runs
of BVH subtrees, accel/bvh_builder.py), and a trace is three dense
stages with no per-node stack:

1. the front table: for every ray its kk nearest pending clusters,
   front to back, from slab tests of the cluster boxes. Up to
   DENSE_K clusters all (N, K) boxes are tested; above it the test goes
   through superclusters of 16 (``_front_table_hierarchical``), and that
   whole two-level table, the selection of the kk nearest included, is
   one hand-written CUDA kernel on the card (accel/front.py
   ``front_full``);
2. the wave loop: wave w tests every ray still live at its column w
   against that cluster's (9, 128) triangle rows, a dense
   Moller-Trumbore min-update. On the card a wave is one hand-written
   CUDA kernel (accel/wave.py ``wave_mt``: a lane per ray evaluates the
   live gate, a warp fetches each cluster's row once for the rays that
   want it and reduces each ray's winner); on CPU tensors it is the
   plain gather + ``_mt_rows``;
3. the exact fallback: rays whose table did not cover their hit range
   (table overflow, supercluster horizon) test every cluster
   (``wave_sweep``, a kernel on the card as well).

Where the JAX package runs masked fixed-shape loops over rays sorted by
overlap, the kernels meet every ray in place and leave a dead one
untouched, and the plain versions compact the live rays by index. What
decides a winner is kept exactly,
because ``_mt_rows`` accepts a hit only on strict ``t < best_t``: a ray
meets its front-table columns in ascending order; after the first
``recompact`` columns the remaining live columns are re-sorted by the
packed key (truncated tnear | cluster id); inside a wave the first flat
index at the minimum wins; in the fallback clusters come in ascending
id. The live gate of a wave compares the (after a recompaction:
truncated) table tnear with the ray's best t at the start of that wave.

Four tunables trade or keep exactness (``_trace``): ``slab_bf16`` slab-tests
the outward-rounded bf16 bounds tables (boxes only grow), ``front_levels=3``
seeds the front table from the super-superclusters, ``wave_dedup`` fetches
each distinct row of a wave once, and ``rows_bf16`` traces bf16 rows (the
one that changes winners: quantized geometry).

Every data-dependent trip count is a host sync here (``STATS`` counts
them under "syncs"): one per segment of waves for the table depth, one
per recompaction for the width and one for the indices of the fallback's
rays. The plain wave adds one per wave (the indices of the live rays);
the kernel needs none.

While a torch.profiler session is active a trace is the span
``tracer.trace`` (utils/profiling.py; args: the kind, closest or
any_hit, and the rays) and its three stages the spans ``tracer.front``,
``tracer.waves`` (the wave loop with its syncs) and ``tracer.fallback``;
otherwise each is the shared no-op.

Correctness oracle: the brute-force tracer of accel/mt.py.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.accel import front, wave
from phosphorus_mk2_tpu_torch.accel.bvh_builder import DENSE_CLUSTERS as DENSE_K
from phosphorus_mk2_tpu_torch.accel.bvh_builder import SUPER_CLUSTERS as SC
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, mt_intersect
from phosphorus_mk2_tpu_torch.accel.wave import dedup_rows as _dedup_rows  # noqa: F401
from phosphorus_mk2_tpu_torch.accel.wave import mt_rows as _mt_rows  # noqa: F401  (its old home)
from phosphorus_mk2_tpu_torch.utils.profiling import counted, span, tracing

MAX_FRONT = 32  # per-ray front-to-back cluster table depth; rays that
                # overlap more clusters finish in the exact fallback
SC_FRONT = 16   # supercluster table depth in hierarchical mode

# traces, rays, waves, host syncs and exact-fallback rays since the caller
# last cleared it (a profile reads it; nothing in the tracer does)
STATS = counted("accel.cluster_traverse.STATS",
                {"traces": 0, "syncs": 0, "waves": 0, "fallback_rays": 0, "rays": 0})

WAVE_DEDUP = ("off", "gather", "onehot")


def _cluster_rows(scene, bf16: bool = False):
    """(K, 9, C) triangle component rows (a|e0|e1), gathered per ray each
    wave. The winner is tracked as (cluster, lane) and mapped to a
    triangle id once per trace, so no id row rides in a wave's gather.
    bf16=True: the rows in bf16 (``attach_bvh`` rounds them to nearest
    even once), half the bytes a wave; the MT then runs on quantized
    geometry, which can flip the winner between surfaces closer than
    ~0.4% and miss rays within that band of a silhouette."""
    return scene.bvh["cluster_rows_bf16" if bf16 else "cluster_rows"]


def _table(bvh, name, slab_bf16):
    """A bounds table: its outward-rounded bf16 copy under slab_bf16
    (conservative: boxes only grow), else the float32 one. Every reader
    upcasts right after the read."""
    if slab_bf16 and name + "_bf16" in bvh:
        return bvh[name + "_bf16"]
    return bvh[name]


def _slab_interval(p, inv, bmin, bmax):
    """Raw slab interval (tn, tf) of rays against boxes; p and inv (N, 3)
    are broadcast from the left against bmin/bmax (N or 1, ..., 3). NaN
    bounds (empty slots) give NaN: minimum/maximum propagate it."""
    extra = (1,) * (bmin.dim() - 2)
    tn = tf = None
    for a in range(3):
        pa = p[:, a].reshape(-1, *extra)
        ia = inv[:, a].reshape(-1, *extra)
        t0 = (bmin[..., a] - pa) * ia
        t1 = (bmax[..., a] - pa) * ia
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _slab_all(p, d, bmin, bmax):
    """(N, K) cluster slab test. Returns (hit, tnear >= 0); a NaN-bounded
    slot has hit False."""
    inv = 1.0 / torch.where(d == 0.0, 1e-30, d)
    tn, tf = _slab_interval(p, inv, bmin.float()[None], bmax.float()[None])
    hit = (tn <= tf) & (tf >= 0.0)
    return hit, front.clamp0(tn)


def _stable_smallest(vals, k):
    """The k smallest of each row, ascending, equal values in ascending
    column order: what ``jax.lax.top_k`` of the negated values returns.
    ``torch.topk`` promises no order among ties, and equal tnear is the
    common case (every box that holds the ray origin has tnear 0)."""
    t, idx = torch.sort(vals, dim=1, stable=True)
    return t[:, :k], idx[:, :k].int()


def _front_table_dense(pp, dd, bvh, t_limit, kk, slab_bf16=False):
    """Dense (N, K) slab + the kk nearest. Returns (ttbl, ctbl, horizon)."""
    hit_tbl, tn_tbl = _slab_all(pp, dd, _table(bvh, "cluster_bmin", slab_bf16),
                                _table(bvh, "cluster_bmax", slab_bf16))
    pending0 = hit_tbl & (tn_tbl < t_limit[:, None])
    ttbl, ctbl = _stable_smallest(torch.where(pending0, tn_tbl, T_MAX), kk)
    return ttbl, ctbl, T_MAX  # horizon: every cluster was tested


def _select_topk(cand_t, k, mode="sort"):
    """Per-ray k nearest candidate columns of cand_t (N, M), front to
    back, ties to the lower column. Returns (t (N, k), col (N, k)); t
    carries the key truncation. The column rides in the low mantissa bits
    of the non-negative tnear (accel/front.py pack_keys / decode_keys hold
    what the JAX module's _key_consts, _pack_cols and _unpack_keys do, in
    the int32 domain).

    mode "sort": one packed row sort. mode "extract": k rounds of
    min-reduce and mask (the dead value is 0x7FFFFFFF, above any key).
    """
    nbits = front.key_bits(cand_t.shape[1])
    packed = front.pack_keys(cand_t, nbits)
    if mode == "extract":
        outs = []
        for _ in range(k):
            m = packed.min(dim=1, keepdim=True).values
            outs.append(m)
            packed = torch.where(packed == m, front.DEAD_KEY, packed)
        sel = torch.cat(outs, dim=1)
    elif mode == "sort":
        sel = torch.sort(packed, dim=1).values[:, :k]
    else:
        raise ValueError(f"unknown selection mode {mode!r}")
    return front.decode_keys(sel, nbits)


def _expand_members(pp, dd, mbmin, mbmax, ptbl, p_ttbl, t_limit, expand_batch=1):
    """Gather the member bounds of each ray's selected parents and
    slab-test them: ptbl (N, jj) parent ids (valid where p_ttbl < T_MAX),
    mbmin/mbmax (P, SC, 3). Returns (cand_t (N, G*B*SC) member tnear,
    the parent table padded to G*B columns). expand_batch parents are
    expanded per step (a memory lever; the result is the same)."""
    n, jj = ptbl.shape
    sc = mbmin.shape[1]
    inv = 1.0 / torch.where(dd == 0.0, 1e-30, dd)
    B = max(1, min(expand_batch, jj))
    G = -(-jj // B)
    pad = G * B - jj
    sct = torch.nn.functional.pad(ptbl, (0, pad))
    live_col = torch.nn.functional.pad(p_ttbl < T_MAX, (0, pad))
    outs = []
    for g in range(G):
        sc_b = sct[:, g * B : (g + 1) * B]
        live = live_col[:, g * B : (g + 1) * B]
        pid = torch.where(live, sc_b, 0).long()
        tn, tf = _slab_interval(pp, inv, mbmin[pid].float(), mbmax[pid].float())  # (N, B, SC)
        hit = (tn <= tf) & (tf >= 0.0) & live[:, :, None] & (tn < t_limit[:, None, None])
        outs.append(torch.where(hit, front.clamp0(tn), T_MAX).reshape(n, B * sc))
    return torch.cat(outs, dim=1), sct


def _reconstruct_ids(ptbl, col, sc):
    """Global member id of a selected candidate column: the parent id
    from the per-ray parent table, member = col % sc."""
    return ptbl.gather(1, (col // sc).long()) * sc + col % sc


def _front_table_hierarchical(pp, dd, bvh, t_limit, kk, expand_batch=1, levels=2,
                              sc_topk="auto", sc_front=0, slab_bf16=False, plain=False):
    """Supercluster-culled front table for big scenes: slab the coarsest
    level, take each ray's nearest, expand their members (16-wide slab of
    bounds gathered by parent id), on to the next level, ending in the kk
    nearest clusters. Memory is O(N * width), never O(N * K).

    levels=2: the (N, K2) supercluster slab seeds the table. levels=3
    (when the ``ssc_*`` tables exist): the (N, K3) super-supercluster slab
    seeds it, K3 = ceil(K2 / 16), and the jj nearest superclusters are
    selected from the expanded members of the jj nearest of those
    (expanded in one step), then the level-2 tail.

    sc_topk, at level 2: "auto" and "pallas_full" are the whole table in
    one kernel (accel/front.py ``front_full``: the CUDA kernel on the
    card, its plain version on CPU tensors), which reads the float32
    tables whatever slab_bf16 says, as the JAX package's fused kernel
    does; "pallas" is the fused slab + extraction kernel
    (``front_slab_extract``, float32 tables) followed by the plain
    expansion; "extract", "sort" and "topk" are the plain oracle forms.
    At level 3 the selection of superclusters is the JAX package's:
    "extract" for "auto" and "extract", a packed row sort for the rest.
    slab_bf16: every plain slab reads the bf16 tables. plain=True takes
    the kernels' plain versions on any device.

    Returns (ttbl, ctbl, horizon (N,)): clusters beyond the horizon are
    NOT in the table, so a ray whose best hit is farther needs the exact
    fallback.
    """
    sc_front = sc_front or SC_FRONT
    mbmin = _table(bvh, "sc_member_bmin", slab_bf16)
    mbmax = _table(bvh, "sc_member_bmax", slab_bf16)
    if levels >= 3 and "ssc_bmin" in bvh:
        s3_hit, s3_tn = _slab_all(pp, dd, _table(bvh, "ssc_bmin", slab_bf16),
                                  _table(bvh, "ssc_bmax", slab_bf16))
        j3 = min(sc_front, s3_tn.shape[1])
        s3_m = torch.where(s3_hit & (s3_tn < t_limit[:, None]), s3_tn, T_MAX)
        s3_ttbl, s3_tbl = _select_topk(s3_m, j3, mode="extract")
        sc_cand, s3_pad = _expand_members(
            pp, dd, _table(bvh, "ssc_member_bmin", slab_bf16),
            _table(bvh, "ssc_member_bmax", slab_bf16), s3_tbl, s3_ttbl, t_limit,
            expand_batch=sc_front,
        )
        jj = min(sc_front, sc_cand.shape[1])
        mode = "extract" if sc_topk in ("auto", "extract") else "sort"
        sc_ttbl, sc_col = _select_topk(sc_cand, jj, mode=mode)
        sctbl = _reconstruct_ids(s3_pad, sc_col, SC)
        # the nearest entry either level left out (truncated keys: lower)
        horizon = torch.minimum(s3_ttbl[:, -1], sc_ttbl[:, -1])
    else:
        K2 = bvh["sc_bmin"].shape[0]
        jj = min(sc_front, K2)
        if sc_topk in ("auto", "pallas_full"):
            ttbl, col, pt, pid = front.front_all(
                bvh["sc_bmin"], bvh["sc_bmax"], bvh["sc_member_bmin"], bvh["sc_member_bmax"],
                pp, dd, t_limit, jj=jj, kk=kk, plain=plain,
            )
            return ttbl, _reconstruct_ids(pid, col, SC), pt[:, -1]
        if sc_topk == "pallas":
            sc_ttbl, sctbl = front.slab_extract(
                bvh["sc_bmin"], bvh["sc_bmax"], pp, dd, t_limit, jj=jj, plain=plain
            )
        else:
            sc_hit, sc_tn = _slab_all(pp, dd, _table(bvh, "sc_bmin", slab_bf16),
                                      _table(bvh, "sc_bmax", slab_bf16))
            sc_m = torch.where(sc_hit & (sc_tn < t_limit[:, None]), sc_tn, T_MAX)
            if sc_topk == "topk":
                sc_ttbl, sctbl = _stable_smallest(sc_m, jj)
            else:
                sc_ttbl, sctbl = _select_topk(sc_m, jj, mode=sc_topk)
        horizon = sc_ttbl[:, -1]
    cand_t, sc_pad = _expand_members(
        pp, dd, mbmin, mbmax, sctbl, sc_ttbl, t_limit, expand_batch=expand_batch
    )
    ttbl, col = _select_topk(cand_t, kk, mode="sort")
    return ttbl, _reconstruct_ids(sc_pad, col, SC), horizon


def _trace(scene, p, d, t_limit, any_hit,
           dense_waves=0, chunk=1 << 17, dense_chunk=16384, expand_batch=1,
           slab_bf16=False, front_levels=0, sc_topk="auto", front_k=0,
           rows_bf16=False, fb_cc=0, recompact=8, dense_k=0, sc_front=0,
           wave_dedup="off", dedup_d=512, plain=False):
    """Core trace. Returns (t, cid, lane) of every ray's winner (cid -1
    on a miss; with any_hit, of some hit within t_limit).

    Tunables (none but rows_bf16 changes a winner, but for exact-t ties
    under ``recompact``, see below):
    dense_waves: the first W0 front-table columns are evaluated for ALL
      rays in one step (each against the ray's best t at its start),
      before the per-wave loop.
    chunk, dense_chunk: most live rays per gather + MT step of the plain
      wave and of the plain dense head (they bound the (rays, W, 9, 128)
      row gather and the MT temporaries; the kernel has neither and
      takes no chunk). The default takes a whole wavefront of 1 << 17
      rays in one step: 604 MB of rows and about as much again in MT
      temporaries.
    expand_batch: parents expanded per step of the plain member
      expansion.
    slab_bf16: the plain slab tests read the outward-rounded bf16 bounds
      tables (boxes only grow, so a table only gains entries; the MT
      stays float32). The fused front kernel (``front_full``, sc_topk
      "auto") reads the float32 tables regardless, as JAX's does.
    front_levels: 0 means 2; 3 seeds the hierarchical front table from
      the super-superclusters (``ssc_*`` tables), see
      ``_front_table_hierarchical``.
    sc_topk: how the hierarchical front table is made, see
      ``_front_table_hierarchical``.
    front_k: override MAX_FRONT (per-ray table depth). sc_front: override
      SC_FRONT (supercluster table depth jj). The exact fallback covers
      what a shallower table misses.
    fb_cc: clusters per step of the plain exact fallback; 0 = as many as
      wave.FB_ELEMS pairs allow for the needy rays at hand (a handful of
      rays then meets all K clusters in one step instead of K / 64 steps
      of ~90 launches each). The kernel sweeps all K in one launch.
    recompact: every ``recompact`` waves, drop the columns the early-out
      has already ended (tn >= best_t) and left-pack the survivors by a
      packed-key row sort, cluster id in the tn mantissa. 0 = off. The
      repack re-orders a ray's evaluations by (truncated tn, cluster id),
      so two triangles of different clusters at EXACTLY the same t can
      resolve to the other id than with recompact=0.
    dense_k: override DENSE_K, the cluster count above which the
      supercluster front table is used (lets small scenes take the
      hierarchical path).
    rows_bf16: the waves and the fallback test the bf16 rows (half the
      bytes a row): float32 arithmetic on quantized geometry, so the
      winner can change (see ``_cluster_rows``; ``occluded_clusters``
      widens its margins). The only tunable that changes images.
    wave_dedup: "off", "gather" or "onehot": each distinct cluster row
      of a single-column wave (the per-wave loop, not the dense head) is
      fetched once. On CPU tensors, or with plain=True, the plain wave
      takes its rows through ``dedup_rows`` (JAX's ``_dedup_rows``, by
      the route named). On the card both routes launch ``wave_mt`` over
      ``dedup_order``: the rays sorted by cluster, so the kernel's
      per-warp groups (``__match_any_sync``) fetch each row once for
      every ray of a warp that wants it. Exact either way.
    dedup_d: the compact buffer of the plain "onehot" route (a wave with
      more distinct clusters gathers directly). The card has no such
      buffer, so nothing there overflows.
    plain: take the plain versions of the front-table and wave kernels
      on any device (to hold a whole trace against the kernels on the
      card).
    """
    if wave_dedup not in WAVE_DEDUP:
        raise ValueError(f"wave_dedup must be one of {WAVE_DEDUP}, got {wave_dedup!r}")
    n = p.shape[0]
    args = {"kind": "any_hit" if any_hit else "closest", "rays": n} if tracing() else None
    with span("tracer.trace", args):
        bvh = scene.bvh
        rows_tbl = _cluster_rows(scene, bf16=rows_bf16)
        K = rows_tbl.shape[0]
        dev = p.device
        pp = p.detach().contiguous()
        dd = d.detach().contiguous()
        t_limit = t_limit.detach().contiguous()
        STATS["traces"] += 1
        STATS["rays"] += n

        best_t = t_limit.clone()
        best_c = torch.full((n,), -1, dtype=torch.int32, device=dev)   # -1 = miss
        best_l = torch.zeros((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return best_t, best_c, best_l

        with span("tracer.front"):
            kk = min(front_k or MAX_FRONT, K)
            if K > (dense_k or DENSE_K) and "sc_bmin" in bvh:
                ttbl, ctbl, sc_horizon = _front_table_hierarchical(
                    pp, dd, bvh, t_limit, kk, expand_batch=expand_batch,
                    levels=front_levels or 2, sc_topk=sc_topk, sc_front=sc_front,
                    slab_bf16=slab_bf16, plain=plain,
                )
                kth_tn = torch.minimum(ttbl[:, -1], sc_horizon)  # per-ray covered horizon
            else:
                ttbl, ctbl, _ = _front_table_dense(pp, dd, bvh, t_limit, kk,
                                                   slab_bf16=slab_bf16)
                kth_tn = ttbl[:, -1]

        # the kernels of accel/wave.py for CUDA tensors, their plain versions
        # for CPU tensors or when the caller asks for them
        use_plain = plain or not pp.is_cuda
        state = (best_t, best_c, best_l)  # updated in place from here on

        def mt_step(col_t, col_c, step, dedup=False):
            """Front-table columns col_t / col_c (n, w) for every ray: the
            live entries are tested against the ray's best t at the call. The
            plain version compacts the live rays by index, ``step`` at a time,
            which is a host sync; the kernel gates each ray itself. dedup (one
            column): wave_dedup's rows, or on the card its ray order."""
            if use_plain:
                wave.wave_mt_plain(pp, dd, rows_tbl, col_t, col_c, any_hit, *state,
                                   chunk=step, dedup=(wave_dedup, dedup_d) if dedup else None)
                STATS["syncs"] += 1
            elif dedup:
                live = wave.live_columns(col_t[:, 0], best_t, best_c, any_hit)
                order = wave.dedup_order(col_c[:, 0], live)
                wave.wave_mt(pp, dd, rows_tbl, col_t, col_c, any_hit, *state, order=order)
            else:
                wave.wave_mt(pp, dd, rows_tbl, col_t, col_c, any_hit, *state)

        with span("tracer.waves"):
            # --- dense head: columns [0, W0) of every ray in one step
            W0 = min(dense_waves, kk) if dense_waves else 0
            if W0 > 0:
                mt_step(ttbl[:, :W0], ctbl[:, :W0], dense_chunk)

            def run_waves(tbl_t, tbl_c, w0, ncols):
                """Columns [w0, ncols) of a table whose pending entries are
                left-packed, one wave each: stops at the deepest column any ray
                has."""
                if w0 >= ncols:
                    return
                depth = int((tbl_t[:, w0:ncols] < T_MAX).sum(dim=1).max())
                STATS["syncs"] += 1
                for w in range(w0, w0 + depth):
                    mt_step(tbl_t[:, w : w + 1], tbl_c[:, w : w + 1], chunk,
                            dedup=wave_dedup != "off")
                    STATS["waves"] += 1

            if recompact and 0 < recompact < kk - W0:
                seg = min(W0 + recompact, kk)
                run_waves(ttbl, ctbl, W0, seg)
                tbl_t, tbl_c = ttbl[:, seg:], ctbl[:, seg:]
                nbits = front.key_bits(K)
                while tbl_t.shape[1] > 0:
                    live = wave.live_columns(tbl_t, best_t, best_c, any_hit)
                    width = int(live.sum(dim=1).max())
                    STATS["syncs"] += 1
                    if width == 0:
                        break
                    # the cluster id rides in the tn mantissa: truncation only
                    # LOWERS tn (keys clamped non-negative), permissive for the
                    # live gate; the MT stays exact
                    packed = torch.where(
                        live, front.pack_keys(front.clamp0(tbl_t), nbits, tbl_c),
                        front.DEAD_KEY,
                    )
                    packed = torch.sort(packed, dim=1).values[:, :width]  # left-pack
                    tbl_t, tbl_c = front.decode_keys(packed, nbits)
                    run_len = min(recompact, width)
                    run_waves(tbl_t, tbl_c, 0, run_len)
                    tbl_t, tbl_c = tbl_t[:, run_len:], tbl_c[:, run_len:]
            else:
                run_waves(ttbl, ctbl, W0, kk)

        with span("tracer.fallback"):
            # --- exact fallback for rays whose front table did not cover their
            # hit range: every cluster for the needy rays only
            needy = kth_tn < best_t
            if any_hit:
                needy = needy & (best_c < 0)
            idx = needy.nonzero()[:, 0].int()
            STATS["syncs"] += 1
            STATS["fallback_rays"] += idx.shape[0]
            if idx.shape[0] > 0:
                if use_plain:
                    wave.wave_sweep_plain(pp, dd, rows_tbl, idx, *state, fb_cc=fb_cc)
                else:
                    wave.wave_sweep(pp, dd, rows_tbl, idx, *state)
        return best_t, best_c, best_l


def _winner_tri(scene, cid, lane):
    """Map (cluster, lane) winners to triangle ids, once per trace."""
    ids = scene.bvh["cluster_id"]  # (K, C)
    tri = ids[torch.clamp(cid, min=0).long(), lane.long()]
    return torch.where(cid >= 0, tri, -1)


def intersect_clusters(scene, p, d, tmax=None, **tune):
    """Closest hit through the cluster tracer: {"t", "tri", "u", "v",
    "hit"}; t is tmax (T_MAX without one) on a miss. tune: see ``_trace``."""
    n = p.shape[0]
    t0 = torch.full((n,), T_MAX, dtype=torch.float32, device=p.device) if tmax is None else tmax
    t, cid, lane = _trace(scene, p, d, t0, False, **tune)
    tri = _winner_tri(scene, cid, lane)
    # u/v re-derived from the winner triangle (the wave loop does not
    # carry them; the integrator reintersects anyway)
    f = scene.faces[torch.clamp(tri, min=0).long()].long()
    a, b, c = scene.vertices[f[:, 0]], scene.vertices[f[:, 1]], scene.vertices[f[:, 2]]
    _, u, v, _ = mt_intersect(p.detach(), d.detach(), a, b, c)
    miss = tri < 0
    u = torch.where(miss, 0.0, u)
    v = torch.where(miss, 0.0, v)
    return {"t": t, "tri": tri, "u": u, "v": v, "hit": tri >= 0}


def occluded_clusters(scene, p, d, tmax, **tune):
    """Any hit within [0, tmax) through the cluster tracer; tmax <= 0
    disables a ray (it traces with a limit of 1e-6 and is masked after).
    Returns (N,) bool.

    Under rows_bf16 the hit t carries ~0.2-0.5% relative error from the
    quantized geometry, more than the absolute offset the caller already
    took off: a shadow ray would find its own light just inside tmax,
    and its origin lies inside its own quantized surface. Both margins
    therefore scale with the ray's extent, as in the JAX package: the
    origin is lifted by 0.005 tmax along d and tmax shrunk to
    0.99 tmax - lift (a ray left with tmax <= 0 is disabled)."""
    disabled = tmax <= 0.0
    if tune.get("rows_bf16"):
        lift = 0.005 * torch.clamp(tmax, min=0.0)
        p = p + d * lift[:, None]
        tmax = tmax * 0.99 - lift
        disabled = disabled | (tmax <= 0.0)
    t0 = torch.where(disabled, 1e-6, tmax)
    _, cid, _ = _trace(scene, p, d, t0, True, **tune)
    return (cid >= 0) & ~disabled

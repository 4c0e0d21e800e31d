"""Binned-SAH 8-wide BVH builder and the cluster tables (host side).

A copy of ``phosphorus_mk2_tpu/accel/bvh_builder.py`` (numpy only):
counterpart of the reference's builder (reference
src/accel/bvh/binned_sah_builder.hpp: 12 SAH bins over 3 axes, leaves of
up to 8 triangles, 8-way nodes formed by repeatedly splitting the child
with the most primitives, :229-241) producing flattened SoA node arrays,
the treelet cut of the tree into triangle clusters, and ``attach_bvh``,
which turns both into the tables the cluster tracer
(accel/cluster_traverse.py) reads, as tensors on the scene's device.

Differences from the reference (documented):
  * a leaf is emitted only when a subtree has <= MAX_LEAF prims; the
    reference's SAH-cost leaf test can emit larger leaves split across
    multiple packed records (bvh.cpp:68-75). Bounded leaves keep the
    traversal's inner loop static.
  * degenerate splits (all centroids equal) fall back to a median split
    instead of a giant leaf.

``build_bvh`` is the correctness builder in numpy; the C++ builder
(csrc/bvh_builder.cpp through accel/native_bvh.py, same output format)
is the production path for large scenes.
"""
from __future__ import annotations

import dataclasses
import logging
import sys
import time
import warnings

import numpy as np
import torch

from phosphorus_mk2_tpu_torch.accel import native_bvh
from phosphorus_mk2_tpu_torch.utils.profiling import spanned

log = logging.getLogger(__name__)

NUM_BINS = 12       # reference binned_sah_builder.hpp:17
MAX_LEAF = 8        # reference binned_sah_builder.hpp:18
WIDTH = 8           # 8-wide nodes, reference node.hpp:12
SENTINEL = -1
CLUSTER_TRIS = 128  # triangle-cluster granularity for the cluster
                    # tracer (accel/cluster_traverse.py)
SUPER_CLUSTERS = 16  # clusters per supercluster (hierarchical culling)
DENSE_CLUSTERS = 2048  # above this the tracer goes hierarchical
                       # (cluster_traverse.DENSE_K imports this)
# the bounds tables that attach_bvh also gives as outward-rounded bf16
# copies (name + "_bf16")
BOUNDS_TABLES = ("cluster_bmin", "cluster_bmax", "sc_member_bmin", "sc_member_bmax",
                 "sc_bmin", "sc_bmax", "ssc_member_bmin", "ssc_member_bmax",
                 "ssc_bmin", "ssc_bmax")


class _BuildCtx:
    def __init__(self, bmin, bmax, centroid):
        self.bmin = bmin
        self.bmax = bmax
        self.centroid = centroid
        self.node_bmin = []
        self.node_bmax = []
        self.node_child = []
        self.node_count = []
        self.leaf_tris = []


def _bounds_of(ctx, idx):
    return ctx.bmin[idx].min(axis=0), ctx.bmax[idx].max(axis=0)


def _sah_split(ctx, idx):
    """Best binned-SAH split over 3 axes. Returns (axis, threshold,
    left_idx, right_idx) or None when degenerate."""
    cent = ctx.centroid[idx]
    cmin = cent.min(axis=0)
    cmax = cent.max(axis=0)
    ext = cmax - cmin
    best = None  # (cost, axis, bin)
    for axis in range(3):
        if ext[axis] <= 0.0:
            continue
        scale = NUM_BINS * (1.0 - 1e-6) / ext[axis]
        bins = np.minimum(
            ((cent[:, axis] - cmin[axis]) * scale).astype(np.int32), NUM_BINS - 1
        )
        counts = np.bincount(bins, minlength=NUM_BINS)
        # per-bin bounds
        bin_min = np.full((NUM_BINS, 3), np.inf)
        bin_max = np.full((NUM_BINS, 3), -np.inf)
        for b in range(NUM_BINS):
            sel = bins == b
            if counts[b]:
                bin_min[b] = ctx.bmin[idx][sel].min(axis=0)
                bin_max[b] = ctx.bmax[idx][sel].max(axis=0)
        # sweep: cost(i) = SA(left<=i)*n_left + SA(right>i)*n_right
        lmin = np.minimum.accumulate(bin_min, axis=0)
        lmax = np.maximum.accumulate(bin_max, axis=0)
        rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(counts)
        rcnt = lcnt[-1] - lcnt

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

        for b in range(NUM_BINS - 1):
            if lcnt[b] == 0 or rcnt[b] == 0:
                continue
            cost = area(lmin, lmax)[b] * lcnt[b] + area(rmin[1:], rmax[1:])[b] * rcnt[b]
            if best is None or cost < best[0]:
                best = (cost, axis, b, bins)
    if best is None:
        return None
    _, axis, b, bins = best
    left = idx[bins <= b]
    right = idx[bins > b]
    if left.size == 0 or right.size == 0:
        return None
    return left, right


def _split_or_median(ctx, idx):
    s = _sah_split(ctx, idx)
    if s is not None:
        return s
    # degenerate: median split on the largest-extent axis (by index order)
    half = idx.size // 2
    return idx[:half], idx[half:]


def _build_node(ctx, idx) -> int:
    """Emit one 8-wide node for `idx`; returns node id."""
    # children start as a binary split, then the largest child keeps
    # splitting until we have WIDTH children or only leaves remain
    # (reference binned_sah_builder.hpp:224-241)
    children = [idx]
    while len(children) < WIDTH:
        sizes = [c.size for c in children]
        largest = int(np.argmax(sizes))
        if sizes[largest] <= MAX_LEAF:
            break
        l, r = _split_or_median(ctx, children[largest])
        children[largest : largest + 1] = [l, r]

    node_id = len(ctx.node_child)
    ctx.node_bmin.append(np.zeros((WIDTH, 3), np.float32))
    ctx.node_bmax.append(np.zeros((WIDTH, 3), np.float32))
    ctx.node_child.append(np.full((WIDTH,), SENTINEL, np.int32))
    ctx.node_count.append(np.zeros((WIDTH,), np.int32))

    for k, child in enumerate(children):
        mn, mx = _bounds_of(ctx, child)
        ctx.node_bmin[node_id][k] = mn
        ctx.node_bmax[node_id][k] = mx
        if child.size <= MAX_LEAF:
            ctx.node_child[node_id][k] = len(ctx.leaf_tris)
            ctx.node_count[node_id][k] = child.size
            # each leaf record is padded to MAX_LEAF entries so offsets are
            # group-aligned (block traversal indexes leaf groups by
            # offset // MAX_LEAF)
            ctx.leaf_tris.extend(child.tolist())
            ctx.leaf_tris.extend([0] * (MAX_LEAF - child.size))
        else:
            cid = _build_node(ctx, child)
            ctx.node_child[node_id][k] = cid
            ctx.node_count[node_id][k] = 0
    return node_id


def build_bvh(vertices: np.ndarray, faces: np.ndarray) -> dict:
    """Build the flattened 8-wide BVH. Returns numpy arrays:
      node_bmin/node_bmax: (n_nodes, 8, 3) f32
      node_child: (n_nodes, 8) i32 — inner: child node id; leaf: offset
                  into leaf_tris; empty slot: -1
      node_count: (n_nodes, 8) i32 — 0 for inner/empty, else leaf size
      leaf_tris:  (LT,) i32 triangle ids (padded to MAX_LEAF multiple)
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    tri = vertices[faces]  # (T, 3, 3)
    bmin = tri.min(axis=1)
    bmax = tri.max(axis=1)
    centroid = 0.5 * (bmin + bmax)

    ctx = _BuildCtx(bmin, bmax, centroid)
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        _build_node(ctx, np.arange(faces.shape[0]))
    finally:
        sys.setrecursionlimit(old_limit)

    leaf = np.asarray(ctx.leaf_tris, np.int32)
    if leaf.size == 0:
        leaf = np.zeros((MAX_LEAF,), np.int32)
    return {
        "node_bmin": np.stack(ctx.node_bmin),
        "node_bmax": np.stack(ctx.node_bmax),
        "node_child": np.stack(ctx.node_child),
        "node_count": np.stack(ctx.node_count),
        "leaf_tris": leaf,
    }


class _Treelets:
    """Cut the BVH into clusters at SUBTREE boundaries instead of fixed
    runs of DFS leaf order.

    The flat chop ignores node boundaries, so a cluster can straddle two
    distant subtrees and get a huge bounding box; subtree clusters
    inherit the SAH builder's tight bounds, which directly cuts the
    per-ray cluster overlap the wave loop pays for. `hierarchy()` nests
    the cut — every
    supercluster / super-supercluster is also a packed run of subtrees —
    and pads each level to the fixed SC fan-out so the tracer's
    stride-based id reconstruction (cluster = sc*SC + member) holds.
    Node-order independent (explicit stacks), so the C++ builder's
    output works too.
    """

    def __init__(self, bvh):
        self.child = np.asarray(bvh["node_child"])
        self.count = np.asarray(bvh["node_count"])
        n_nodes = self.child.shape[0]
        # post-order subtree sizes in leaf groups (explicit stack)
        size = np.zeros(n_nodes, np.int64)
        stack = [(0, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                s = 0
                for k in range(WIDTH):
                    c = self.child[node, k]
                    if c < 0:
                        continue
                    s += 1 if self.count[node, k] > 0 else size[c]
                size[node] = s
                continue
            stack.append((node, True))
            for k in range(WIDTH):
                c = self.child[node, k]
                if c >= 0 and self.count[node, k] == 0:
                    stack.append((int(c), False))
        self.size = size

    def _items(self, node):
        """Direct children as ("g", leaf-group-id) / ("n", node-id)."""
        items = []
        for k in range(WIDTH):
            c = self.child[node, k]
            if c < 0:
                continue
            if self.count[node, k] > 0:
                items.append(("g", int(c) // MAX_LEAF))
            else:
                items.append(("n", int(c)))
        return items

    def _groups_of(self, items):
        """Leaf groups of an item list, DFS order."""
        out = []
        st = list(reversed(items))
        while st:
            kind, v = st.pop()
            if kind == "g":
                out.append(v)
            else:
                st.extend(reversed(self._items(v)))
        return out

    def _cut(self, items, budget):
        """Partition an item list into consecutive packs of <= budget
        leaf groups, opening nodes only when they exceed the budget —
        each pack is a run of whole subtrees (tight union bounds)."""
        parts, cur, sz = [], [], 0
        st = list(reversed(items))
        while st:
            it = st.pop()
            s = 1 if it[0] == "g" else int(self.size[it[1]])
            if s == 0:
                continue
            if s > budget:
                st.extend(reversed(self._items(it[1])))
                continue
            if sz + s > budget:
                parts.append(cur)
                cur, sz = [], 0
            cur.append(it)
            sz += s
        if cur:
            parts.append(cur)
        return parts

    def clusters(self, max_groups):
        """Flat subtree clusters (small scenes): list of group lists."""
        return [self._groups_of(p) for p in self._cut([("n", 0)], max_groups)]

    def hierarchy(self, max_groups):
        """Nested 3-level cut, padded to fixed SC fan-out per level.

        Returns a flat cluster list (length K3*SC*SC; [] = padding slot)
        laid out so reshaping by SC yields superclusters and
        super-superclusters whose members are exactly the nested packs.
        """
        SC = SUPER_CLUSTERS
        flat: list[list[int]] = []
        # parent budgets carry a 3/4 margin: the child cut fills ~84% of
        # its budget (subtree sizes don't sum to exact powers), so a
        # full-budget parent systematically overflows SC children and
        # splits into a nearly-empty sibling — all padding
        for ssc_items in self._cut([("n", 0)], max_groups * SC * SC * 9 // 16):
            sc_lists = []
            for sc_items in self._cut(ssc_items, max_groups * SC * 3 // 4):
                cls = [
                    self._groups_of(p)
                    for p in self._cut(sc_items, max_groups)
                ]
                for i in range(0, len(cls), SC):  # overflow: split the sc
                    sc_lists.append(cls[i : i + SC])
            for j in range(0, len(sc_lists), SC):  # overflow: split the ssc
                chunk = sc_lists[j : j + SC]
                for sc in chunk:
                    flat.extend(sc + [[]] * (SC - len(sc)))
                flat.extend([[]] * (SC * (SC - len(chunk))))
        return flat


def cluster_rows(a, e0, e1):
    """(K, 9, C) component rows ax ay az e0x .. e1z of the (K, C, 3)
    cluster triangle tables: what one wave of the tracer gathers per ray."""
    return np.ascontiguousarray(np.concatenate([a, e0, e1], axis=2).transpose(0, 2, 1))


@spanned("setup.bvh")
def attach_bvh(scene_data, bvh: dict | None = None,
               cluster_mode: str = "treelet",
               cluster_tris: int | None = None,
               builder: str = "auto"):
    """Return SceneData with the BVH and cluster tables attached as
    tensors on the scene's device (``scene_data.bvh``), plus pre-gathered
    leaf triangle tables (leaf-group rows of v0/e0/e1).

    cluster_mode: "treelet" (clusters cut at BVH subtree boundaries:
    tight bounds, low per-ray overlap), "treelet_nested", or "flat"
    (fixed 128-slot runs of leaf order, kept for A/B measurement).

    builder: which builder makes the tree when ``bvh`` is not given.
    "native" is the C++ builder and raises if it cannot be compiled;
    "python" is the numpy builder; "auto" is the native builder, except
    that a CPU scene on a host without a C++ compiler takes the numpy
    builder. A scene on the card never gives way to the numpy builder
    behind the caller's back. Which builder ran, and its seconds, are
    logged.

    NOTE: the tables snapshot vertex positions; like the BVH itself they
    go stale if vertices change.
    """
    dev = scene_data.device
    verts = scene_data.vertices.detach().cpu().numpy()
    faces = scene_data.faces.cpu().numpy()
    if bvh is None:
        if builder not in ("auto", "native", "python"):
            raise ValueError(f"unknown builder {builder!r}")
        if builder == "auto":
            no_compiler = native_bvh.compiler() is None
            builder = "python" if no_compiler and dev.type == "cpu" else "native"
        t0 = time.perf_counter()
        if builder == "native":
            bvh = native_bvh.build_bvh_native(verts, faces)
        else:
            bvh = build_bvh(verts, faces)
        log.info("BVH: %s builder, %d triangles, %d nodes, %.3f s", builder,
                 faces.shape[0], bvh["node_child"].shape[0], time.perf_counter() - t0)
    tables = {k: np.asarray(v) for k, v in bvh.items()}

    ids2 = np.asarray(bvh["leaf_tris"]).reshape(-1, MAX_LEAF)
    f = faces[ids2]  # (G, 8, 3)
    a = verts[f[..., 0]]
    tables["leaf_a"] = a
    tables["leaf_e0"] = verts[f[..., 1]] - a
    tables["leaf_e1"] = verts[f[..., 2]] - a
    tables["leaf_id"] = ids2

    # ---- cluster tables for the cluster tracer -----------------------
    # leaf-slot validity from the node tables (padded slots repeat tri 0
    # and must not contribute to cluster bounds or intersections)
    valid = np.zeros(ids2.shape, bool)
    nc = np.asarray(bvh["node_count"])
    cc = np.asarray(bvh["node_child"])
    leaf_mask = nc > 0
    groups = cc[leaf_mask] // MAX_LEAF
    counts = nc[leaf_mask]
    for g, cnt in zip(groups, counts):
        valid[g, :cnt] = True

    C = cluster_tris or CLUSTER_TRIS
    if cluster_mode.startswith("treelet"):
        tl = _Treelets(bvh)
        GC = C // MAX_LEAF
        if cluster_mode == "treelet_nested":
            # nested layout: superclusters/super-superclusters are also
            # subtree runs (tight at every level, but padding slots cost
            # cluster-table memory)
            groups = tl.hierarchy(GC)
        else:
            groups = tl.clusters(GC)
        K = max(1, len(groups))
        cl_ids = np.zeros((K, C), np.int32)
        cl_valid = np.zeros((K, C), bool)
        for i, gs in enumerate(groups):
            m = len(gs) * MAX_LEAF
            cl_ids[i, :m] = ids2[gs].reshape(-1)
            cl_valid[i, :m] = valid[gs].reshape(-1)
    else:  # "flat": fixed 128-slot runs of DFS leaf order
        total = ids2.size
        K = max(1, -(-total // C))
        pad = K * C - total
        flat_ids = np.concatenate([ids2.reshape(-1), np.zeros((pad,), np.int32)])
        flat_valid = np.concatenate([valid.reshape(-1), np.zeros((pad,), bool)])
        cl_ids = flat_ids.reshape(K, C)
        cl_valid = flat_valid.reshape(K, C)

    fc = faces[cl_ids]  # (K, C, 3)
    ca = verts[fc[..., 0]]
    ce0 = verts[fc[..., 1]] - ca
    ce1 = verts[fc[..., 2]] - ca
    # degenerate out invalid slots (det = 0 -> always miss)
    ce0 = np.where(cl_valid[..., None], ce0, 0.0)
    ce1 = np.where(cl_valid[..., None], ce1, 0.0)

    tri_pts = verts[fc]  # (K, C, 3, 3)
    masked_pts = np.where(cl_valid[..., None, None], tri_pts, np.float32(np.nan))
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        bmin = np.nanmin(masked_pts.reshape(K, -1, 3), axis=1)
        bmax = np.nanmax(masked_pts.reshape(K, -1, 3), axis=1)
    # empty slots keep NaN bounds: NaN compares false in the slab test,
    # a guaranteed miss. (An inverted box, bmin=+big and bmax=-big, is
    # NOT a miss there: min/max swap makes it an infinite interval that
    # hits EVERY ray, which the padded hierarchical layout would turn
    # into thousands of phantom overlaps per ray.) Every consumer must
    # therefore use NaN-propagating min/max (torch.minimum/maximum, never
    # fmin/fmax; the CUDA kernels of csrc/front.cu write theirs out).
    bmin = bmin.astype(np.float32)
    bmax = bmax.astype(np.float32)

    tables["cluster_a"] = ca.astype(np.float32)
    tables["cluster_e0"] = ce0.astype(np.float32)
    tables["cluster_e1"] = ce1.astype(np.float32)
    # the same geometry as the (K, 9, C) component rows a wave gathers
    tables["cluster_rows"] = cluster_rows(tables["cluster_a"], tables["cluster_e0"],
                                          tables["cluster_e1"])
    tables["cluster_id"] = cl_ids
    tables["cluster_bmin"] = bmin
    tables["cluster_bmax"] = bmax

    # ---- supercluster level (hierarchical front table for big scenes):
    # groups of SUPER_CLUSTERS clusters; member bounds packed as rows so
    # the tracer gathers one supercluster's members by parent id
    SC = SUPER_CLUSTERS
    K2 = -(-K // SC)
    pad2 = K2 * SC - K
    nan3 = np.full((pad2, 3), np.nan, np.float32)
    mb_min = np.concatenate([bmin, nan3]).reshape(K2, SC, 3)
    mb_max = np.concatenate([bmax, nan3]).reshape(K2, SC, 3)
    tables["sc_member_bmin"] = mb_min
    tables["sc_member_bmax"] = mb_max
    with warnings.catch_warnings():  # all-NaN (fully padded) parents
        warnings.simplefilter("ignore", RuntimeWarning)
        tables["sc_bmin"] = np.nanmin(mb_min, axis=1)
        tables["sc_bmax"] = np.nanmax(mb_max, axis=1)

    # ---- super-supercluster level (the three-level front table): groups
    # of SC superclusters, so the slab and selection that seed the front
    # table run over K3 = ceil(K2 / SC) columns instead of K2
    K3 = -(-K2 // SC)
    nan3 = np.full((K3 * SC - K2, 3), np.nan, np.float32)
    m3_min = np.concatenate([tables["sc_bmin"], nan3]).reshape(K3, SC, 3)
    m3_max = np.concatenate([tables["sc_bmax"], nan3]).reshape(K3, SC, 3)
    tables["ssc_member_bmin"] = m3_min
    tables["ssc_member_bmax"] = m3_max
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        tables["ssc_bmin"] = np.nanmin(m3_min, axis=1)
        tables["ssc_bmax"] = np.nanmax(m3_max, axis=1)

    on_dev = {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in tables.items()
    }
    # bf16 copies of every bounds table, rounded OUTWARD (min down, max
    # up) so boxes only grow: the slab tnear only drops and hits are only
    # added, conservative for the front table, its horizon and the live
    # gate (the slab_bf16 tunable; the Moller-Trumbore stays float32)
    for name in BOUNDS_TABLES:
        on_dev[name + "_bf16"] = bf16_from_bits(
            _bf16_outward(tables[name], up=name.endswith("bmax")), dev)
    # the rows in bf16, rounded to nearest even (the rows_bf16 tunable):
    # made once here, so that no trace pays for the cast
    on_dev["cluster_rows_bf16"] = torch.from_numpy(tables["cluster_rows"]).to(
        torch.bfloat16).to(dev)
    return dataclasses.replace(scene_data, bvh=on_dev)



def _bf16_outward(x: np.ndarray, up: bool) -> np.ndarray:
    """Round float32 values to the nearest bf16 toward +inf (up) or -inf
    (down). Returned as float32 holding values that bf16 represents
    exactly; NaN stays NaN. Values are first clipped to +-3.38e38, inside
    bf16's finite range (no infinities in the slab arithmetic)."""
    x = np.ascontiguousarray(np.clip(x.astype(np.float32), -3.38e38, 3.38e38))
    bits = x.view(np.uint32)
    t = bits & np.uint32(0xFFFF0000)  # truncate the mantissa: toward zero
    tv = t.view(np.float32)
    # truncation rounds a positive value down and a negative one up: where
    # that is the wrong way, one bf16 ulp away from zero (0x10000 on the
    # bit pattern)
    need = (tv < x) if up else (tv > x)
    return np.where(need, t + np.uint32(0x10000), t).view(np.float32)


def bf16_from_bits(x: np.ndarray, device) -> torch.Tensor:
    """A bf16 tensor on ``device`` of float32 values that bf16 represents
    exactly (their low 16 bits are zero): the top 16 bits of each, moved
    as integers, so no rounding rule of any library is involved."""
    top = (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return torch.from_numpy(top.view(np.int16)).view(torch.bfloat16).to(device)

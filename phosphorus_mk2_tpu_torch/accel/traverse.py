"""Per-ray BVH traversal: a stack machine a ray, run in masked lockstep.

Counterpart of ``phosphorus_mk2_tpu/accel/traverse.py`` (reference
src/kernels/cpu/stream_bvh_kernel.cpp:18-148): an explicit stack over
8-wide nodes, slab tests, Moller-Trumbore leaf tests, and an early out
on any hit for shadow rays. The JAX package runs one ``while_loop`` a
ray under ``vmap``; here one loop steps every live ray at once. Each
step pops one node from each live ray's stack; a ray whose loop has
ended keeps its state, as under ``vmap``. The loop runs while any ray is
live, one host sync a step (``STATS`` counts the steps and the syncs),
and each step works on the live rays only.

This is the oracle of traversal semantics; the performance path is the
cluster tracer (accel/cluster_traverse.py). The trace is primal: it runs
under ``torch.no_grad()`` on detached inputs, as every tracer of the
integrator does (accel/intersect.reintersect is the differentiable
path). It runs on the device of the scene it is given.

JAX's semantics kept, each one deliberately:
  * the pop reads ``stack[sp - 1]`` clamped into the stack, and a push
    past STACK_DEPTH is dropped while ``sp`` still grows (JAX clamps an
    out-of-range gather and drops an out-of-range scatter);
  * ``1 / where(d == 0, 1e-30, d)``;
  * children are pushed in the order of a stable argsort of
    ``where(is_inner, tnear, -T_MAX)``: ascending tnear, so the farthest
    child pops first (the JAX comment says the nearest; its code is
    what this copies). Hits are taken on strict ``t < best_t``, so visit
    order decides exact-t ties.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.accel.bvh_builder import MAX_LEAF
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, mt_intersect_soa
from phosphorus_mk2_tpu_torch.utils.profiling import counted

STACK_DEPTH = 96

STATS = counted("accel.traverse.STATS", {"traces": 0, "steps": 0, "syncs": 0})


def _tri_data(scene):
    verts = scene.vertices.detach()
    f = scene.faces.long()
    a = verts[f[:, 0]]
    return a, verts[f[:, 1]] - a, verts[f[:, 2]] - a


def first_nearest(ok, t, u, v, ids):
    """Along dim 1, the first candidate at the lowest t among those ``ok``
    (tensors of one shape, ``ids`` broadcastable to it). Returns (better,
    t, tri, u, v) with dim 1 gone; ``better`` is False where none is ok.

    JAX tests a node's 8 leaf slots one after the other, each on the best
    t the earlier slots left, and takes the first lowest t of a slot. With
    the candidates in slot then triangle order along dim 1 and ``ok``
    holding t < best_t, one argmin over them picks the same hit.
    """
    t_m = torch.where(ok, t, T_MAX)
    j = torch.argmin(t_m, dim=1, keepdim=True)  # the first index at the minimum
    pick = lambda x: x.expand_as(t_m).gather(1, j).squeeze(1)  # noqa: E731
    return pick(ok), pick(t_m), pick(ids), pick(u), pick(v)


def _leaf_best(a, e0, e1, ids, valid, p, d, best_t):
    """The nearest hit among each ray's leaf candidates. ids, valid: (m,
    64), the 8 leaf slots of a node in order, 8 triangles each; p, d:
    (m, 3); best_t: (m,). Moller-Trumbore in the MT kernels' arithmetic
    (mt_intersect_soa), which is JAX's cross and dot products."""
    col = lambda x: tuple(x[..., k] for k in range(3))  # noqa: E731
    t, u, v, hit = mt_intersect_soa(*(tuple(c[:, None] for c in col(x)) for x in (p, d)),
                                    col(a[ids]), col(e0[ids]), col(e1[ids]))
    return first_nearest(valid & hit & (t < best_t[:, None]), t, u, v, ids)


def push_children(stack, sp, child, is_inner, tnear):
    """Push each row's inner children in the order of a stable argsort of
    ``where(is_inner, tnear, -T_MAX)``; writes at or past the stack's
    depth are dropped and ``sp`` still counts them. stack: (m, S);
    sp: (m,); child, is_inner, tnear: (m, 8). Returns the new sp."""
    depth = stack.shape[1]
    order = torch.argsort(torch.where(is_inner, tnear, -T_MAX), dim=1, stable=True)
    do = is_inner.gather(1, order)
    kid = child.gather(1, order)
    pos = sp[:, None] + torch.cumsum(do.long(), dim=1) - do.long()
    keep = do & (pos < depth)
    rows = torch.arange(stack.shape[0], device=stack.device)[:, None].expand_as(pos)
    stack[rows[keep], pos[keep]] = kid[keep].to(stack.dtype)
    return sp + do.long().sum(dim=1)


def pop(stack, sp):
    """The node at the top of each row's stack, read clamped into it,
    and the decremented sp."""
    top = (sp - 1).clamp(0, stack.shape[1] - 1)
    return stack.gather(1, top[:, None]).squeeze(1), sp - 1


def _step(bvh, tri, leaf_tris, p, d, inv_d, state):
    """One pop, slab test, leaf test and push for each ray of the state
    tuple (sp, stack, best_t, best_tri, best_u, best_v), all of them
    live. Returns the new state."""
    sp, stack, best_t, best_tri, best_u, best_v = state
    node, sp = pop(stack, sp)
    node = node.long()
    t0 = (bvh["node_bmin"][node] - p[:, None, :]) * inv_d[:, None, :]  # (m, 8, 3)
    t1 = (bvh["node_bmax"][node] - p[:, None, :]) * inv_d[:, None, :]
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmin <= tmax) & (tmax >= 0.0) & (tmin < best_t[:, None])
    child = bvh["node_child"][node].long()
    count = bvh["node_count"][node].long()
    hit = hit & (child >= 0)
    is_leaf = hit & (count > 0)
    is_inner = hit & (count == 0)

    lane = torch.arange(MAX_LEAF, device=p.device)
    off = child.clamp(min=0)[:, :, None] + lane  # (m, 8, 8)
    ids = leaf_tris[off.clamp(max=leaf_tris.shape[0] - 1)].long().flatten(1)
    valid = ((lane < count[:, :, None]) & is_leaf[:, :, None]).flatten(1)
    better, t, tri_id, u, v = _leaf_best(*tri, ids, valid, p, d, best_t)
    best_t = torch.where(better, t, best_t)
    best_tri = torch.where(better, tri_id, best_tri)
    best_u = torch.where(better, u, best_u)
    best_v = torch.where(better, v, best_v)

    sp = push_children(stack, sp, child, is_inner, tmin)
    return sp, stack, best_t, best_tri, best_u, best_v


def _traverse(scene, p, d, t0, any_hit: bool):
    bvh = scene.bvh
    tri = _tri_data(scene)
    leaf_tris = bvh["leaf_tris"]
    n = p.shape[0]
    dev = p.device
    inv_d = 1.0 / torch.where(d == 0.0, 1e-30, d)
    state = [
        torch.ones((n,), dtype=torch.long, device=dev),
        torch.zeros((n, STACK_DEPTH), dtype=torch.long, device=dev),
        t0.clone(),
        torch.full((n,), -1, dtype=torch.long, device=dev),
        torch.zeros((n,), dtype=torch.float32, device=dev),
        torch.zeros((n,), dtype=torch.float32, device=dev),
    ]
    STATS["traces"] += 1
    while True:
        live = state[0] > 0
        if any_hit:
            live = live & (state[3] < 0)
        rows = torch.nonzero(live).squeeze(1)
        STATS["syncs"] += 1
        if rows.numel() == 0:
            break
        STATS["steps"] += 1
        new = _step(bvh, tri, leaf_tris, p[rows], d[rows], inv_d[rows],
                    tuple(x[rows] for x in state))
        for x, y in zip(state, new):
            x[rows] = y
    return state[2], state[3], state[4], state[5]


def intersect_bvh(scene, p, d, tmax=None):
    """Closest hit through the BVH, the contract of intersect_brute:
    {"t", "tri", "u", "v", "hit"}; t is tmax (or T_MAX) on a miss."""
    with torch.no_grad():
        p, d = p.detach(), d.detach()
        t0 = (torch.full((p.shape[0],), T_MAX, dtype=torch.float32, device=p.device)
              if tmax is None else tmax.detach())
        t, tri, u, v = _traverse(scene, p, d, t0, False)
    return {"t": t, "tri": tri.int(), "u": u, "v": v, "hit": tri >= 0}


def occluded_bvh(scene, p, d, tmax):
    """Any hit within [0, tmax) through the BVH: (N,) bool."""
    with torch.no_grad():
        _, tri, _, _ = _traverse(scene, p.detach(), d.detach(), tmax.detach(), True)
    return tri >= 0

"""Block-shared-stack BVH traversal.

Counterpart of ``phosphorus_mk2_tpu/accel/block_traverse.py`` (the idea
of the reference's MBVH-RS stream kernel, src/kernels/cpu/detail/
stream.hpp:16, stream_bvh_kernel.cpp:43-120): a BLOCK of rays traverses
the tree with ONE shared stack. A node's 8 child boxes are slab-tested
against every ray of the block as an (8, B) slab, and a child is pushed
when any live ray of the block hits it; a leaf runs Moller-Trumbore on
its 8 triangles against all B rays, from the leaf-ordered triangle
tables that ``attach_bvh`` builds (``leaf_a``, ``leaf_e0``, ``leaf_e1``,
``leaf_id``, one row of 8 per leaf group). A block visits the union of
its rays' nodes, so it wants coherent rays: the tracer kind "block"
sorts the wavefront first (accel/sort.py).

The JAX package runs one ``while_loop`` a block under ``vmap``; here one
loop steps every live block at once, each with its own stack pointer and
stack, and a finished block keeps its state. One host sync a step
(``STATS``). Rays are padded to a whole block with p = 0, d = 1 and
t0 = 0, as ``jnp.pad`` pads them: a padded ray never hits, so it keeps
an any-hit block live, in the JAX package as here. The push order, the
clamped pop and the dropped pushes past STACK_DEPTH are those of
accel/traverse.py. Primal only, on the scene's device.
"""
from __future__ import annotations

import torch

from phosphorus_mk2_tpu_torch.accel.bvh_builder import MAX_LEAF
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, mt_intersect_soa
from phosphorus_mk2_tpu_torch.accel.traverse import first_nearest, pop, push_children
from phosphorus_mk2_tpu_torch.utils.profiling import counted

BLOCK = 256
STACK_DEPTH = 192

STATS = counted("accel.block_traverse.STATS", {"traces": 0, "steps": 0, "syncs": 0})


def _leaf_step(leaf, group, count, is_leaf, ray, best_t):
    """Moller-Trumbore (mt_intersect_soa) of each block's rays against the
    8 triangles of each of its node's 8 slots, and each ray's first
    nearest hit below best_t in slot then triangle order
    (traverse.first_nearest). leaf: the (G, 8, 3) tables a, e0, e1 and
    the (G, 8) ids; group, count, is_leaf: (m, 8); ray: the (m, 1, B)
    components of p and d; best_t: (m, B). Returns (better, t, tri, u,
    v), each (m, B)."""
    leaf_a, leaf_e0, leaf_e1, leaf_id = leaf
    m = group.shape[0]
    g = group.clamp(0, leaf_id.shape[0] - 1)

    def comps(x):  # (m, 64, 1) per component
        x = x[g].reshape(m, MAX_LEAF * MAX_LEAF, 3)
        return x[..., 0:1], x[..., 1:2], x[..., 2:3]

    lane = torch.arange(MAX_LEAF, device=group.device)
    valid = ((lane < count[:, :, None]) & is_leaf[:, :, None]).reshape(m, -1, 1)
    t, u, v, hit = mt_intersect_soa(ray[:3], ray[3:], comps(leaf_a), comps(leaf_e0),
                                    comps(leaf_e1))
    ids = leaf_id[g].reshape(m, -1, 1).long()
    return first_nearest(valid & hit & (t < best_t[:, None, :]), t, u, v, ids)


def _step(bvh, leaf, ray, inv, state, any_hit):
    """One pop, (8, B) slab test, leaf test and push for each block of the
    state tuple (sp, stack, best_t, best_tri, best_u, best_v), all of
    them live. ray: (px, py, pz, dx, dy, dz), inv: (ix, iy, iz), each
    (m, 1, B). Returns the new state."""
    sp, stack, best_t, best_tri, best_u, best_v = state
    node, sp = pop(stack, sp)
    node = node.long()
    bmin = bvh["node_bmin"][node][..., None]  # (m, 8, 3, 1)
    bmax = bvh["node_bmax"][node][..., None]
    child = bvh["node_child"][node].long()  # (m, 8)
    count = bvh["node_count"][node].long()
    px, py, pz = ray[:3]
    ix, iy, iz = inv
    t0x = (bmin[:, :, 0] - px) * ix
    t1x = (bmax[:, :, 0] - px) * ix
    t0y = (bmin[:, :, 1] - py) * iy
    t1y = (bmax[:, :, 1] - py) * iy
    t0z = (bmin[:, :, 2] - pz) * iz
    t1z = (bmax[:, :, 2] - pz) * iz
    tn = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z),
    )
    tf = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    hit = (tn <= tf) & (tf >= 0.0) & (tn < best_t[:, None, :])  # (m, 8, B)
    if any_hit:
        hit = hit & (best_tri < 0)[:, None, :]
    slot_hit = hit.any(dim=2) & (child >= 0)
    is_leaf = slot_hit & (count > 0)
    is_inner = slot_hit & (count == 0)

    better, t, tri, u, v = _leaf_step(leaf, child // MAX_LEAF, count, is_leaf, ray, best_t)
    best_t = torch.where(better, t, best_t)
    best_tri = torch.where(better, tri, best_tri)
    best_u = torch.where(better, u, best_u)
    best_v = torch.where(better, v, best_v)

    # block consensus: a child's key is the least entry distance over the
    # rays that hit it
    tmin_per_child = torch.where(hit, tn, T_MAX).amin(dim=2)
    sp = push_children(stack, sp, child, is_inner, tmin_per_child)
    return sp, stack, best_t, best_tri, best_u, best_v


def _run_blocks(scene, p, d, t0, any_hit: bool, block: int):
    bvh = scene.bvh
    leaf = (bvh["leaf_a"], bvh["leaf_e0"], bvh["leaf_e1"], bvh["leaf_id"])
    n = p.shape[0]
    dev = p.device
    pad = (-n) % block
    pp = torch.cat([p, p.new_zeros((pad, 3))]).reshape(-1, block, 3)
    dd = torch.cat([d, d.new_ones((pad, 3))]).reshape(-1, block, 3)
    tt = torch.cat([t0, t0.new_zeros((pad,))]).reshape(-1, block)
    nb = pp.shape[0]
    inv = 1.0 / torch.where(dd == 0.0, 1e-30, dd)
    ray = tuple(x[..., k][:, None, :] for x in (pp, dd) for k in range(3))  # (nb, 1, B)
    inv = tuple(inv[..., k][:, None, :] for k in range(3))
    state = [
        torch.ones((nb,), dtype=torch.long, device=dev),
        torch.zeros((nb, STACK_DEPTH), dtype=torch.long, device=dev),
        tt.clone(),
        torch.full((nb, block), -1, dtype=torch.long, device=dev),
        torch.zeros((nb, block), dtype=torch.float32, device=dev),
        torch.zeros((nb, block), dtype=torch.float32, device=dev),
    ]
    STATS["traces"] += 1
    while True:
        live = state[0] > 0
        if any_hit:
            live = live & (state[3] < 0).any(dim=1)
        rows = torch.nonzero(live).squeeze(1)
        STATS["syncs"] += 1
        if rows.numel() == 0:
            break
        STATS["steps"] += 1
        new = _step(bvh, leaf, tuple(x[rows] for x in ray), tuple(x[rows] for x in inv),
                    tuple(x[rows] for x in state), any_hit)
        for x, y in zip(state, new):
            x[rows] = y
    return tuple(x.reshape(-1)[:n] for x in state[2:])


def intersect_blocks(scene, p, d, tmax=None, block: int = BLOCK):
    """Closest hit over the wavefront in shared-stack blocks: {"t", "tri",
    "u", "v", "hit"}; t is tmax (or T_MAX) on a miss."""
    with torch.no_grad():
        p, d = p.detach(), d.detach()
        t0 = (torch.full((p.shape[0],), T_MAX, dtype=torch.float32, device=p.device)
              if tmax is None else tmax.detach())
        t, tri, u, v = _run_blocks(scene, p, d, t0, False, block)
    return {"t": t, "tri": tri.int(), "u": u, "v": v, "hit": tri >= 0}


def occluded_blocks(scene, p, d, tmax, block: int = BLOCK):
    """Any hit within [0, tmax) over the wavefront in shared-stack blocks;
    a ray with tmax <= 0 is unoccluded."""
    with torch.no_grad():
        tmax = tmax.detach()
        disabled = tmax <= 0.0
        t0 = torch.where(disabled, 1e-6, tmax)
        _, tri, _, _ = _run_blocks(scene, p.detach(), d.detach(), t0, True, block)
    return (tri >= 0) & ~disabled

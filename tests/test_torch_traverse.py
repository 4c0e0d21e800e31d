"""The port's per-ray BVH traversal (accel/traverse.py) against the JAX
package's, on sphere_in_box and cornell_box with the JAX package's BVH
tables carried to the port (scene_data_from_numpy), on rays drawn with
numpy.

Tolerances, and why:
  * hit, tri and occlusion: equal. Both sides visit the same nodes in the
    same order and take a hit on the same strict comparison.
  * t: rtol 1e-5. XLA may contract a product and a sum of the
    Moller-Trumbore expression into one rounding where PyTorch rounds
    twice (tests/test_torch_cluster.py).
  * u, v: atol 1e-5, as tests/test_torch_cluster.py holds them. They lie
    in [0, 1] and come out of a cancelling dot product scaled by 1/det,
    so one rounding moves them by up to ~2e-6 on sphere_in_box's small
    triangles whatever their size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import traverse as jtr
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu_torch.accel import traverse as ttr
from test_torch_cluster import _carry, _rays

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 300
SCENES = ("sphere_in_box", "cornell_box")


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    jd = j_attach_bvh(getattr(jscenes, request.param)(8, 8).build(), cluster_mode="treelet")
    return jd, _carry(jd)


def _both(seed, n=N):
    p, d, tmax = _rays(seed, n)
    d[::11, 1] = 0.0  # a zero direction component: inv_d of 1e30
    d[5::11] = [0.0, 0.0, 1.0]
    return (tuple(jnp.asarray(x) for x in (p, d, tmax)),
            tuple(torch.from_numpy(x) for x in (p, d, tmax)))


def assert_hits_equal(ref, got):
    np.testing.assert_array_equal(got["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(ref["tri"]))
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), rtol=1e-5)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_intersect_bvh_matches_jax(pair):
    jd, td = pair
    (jp, jdir, _), (tp, tdir, _) = _both(0)
    ref = jtr.intersect_bvh(jd, jp, jdir)
    got = ttr.intersect_bvh(td, tp, tdir)
    assert int(got["hit"].sum()) > N // 2
    assert got["tri"].dtype == torch.int32
    assert_hits_equal(ref, got)


def test_intersect_bvh_respects_tmax(pair):
    jd, td = pair
    (jp, jdir, jt), (tp, tdir, tt) = _both(1)
    ref = jtr.intersect_bvh(jd, jp, jdir, jt)
    got = ttr.intersect_bvh(td, tp, tdir, tt)
    assert_hits_equal(ref, got)
    hit = got["hit"]
    assert 0 < int(hit.sum()) < N
    assert (got["t"][hit] < tt[hit]).all()
    assert torch.equal(got["t"][~hit], tt[~hit])  # a miss keeps its bound, as in JAX
    full = ttr.intersect_bvh(td, tp, tdir)
    assert torch.equal(hit, full["hit"] & (full["t"] < tt))


def test_occluded_bvh_matches_jax(pair):
    jd, td = pair
    (jp, jdir, jt), (tp, tdir, tt) = _both(2)
    ref = np.asarray(jtr.occluded_bvh(jd, jp, jdir, jt))
    got = ttr.occluded_bvh(td, tp, tdir, tt)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < int(got.sum()) < N and not got[tt == 0].any()


def test_stack_overflow_matches_jax(monkeypatch):
    """A stack too shallow for the tree: pushes past it are dropped while
    sp grows and pops read clamped, in both packages alike. (At a depth
    where the clamped pop meets a node with inner children the loop never
    ends, in both packages; 7 on multi_bsdf_scene's tree ends.)"""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    td = _carry(jd)
    (jp, jdir, jt), (tp, tdir, tt) = _both(3)
    depth = 7
    monkeypatch.setattr(jtr, "STACK_DEPTH", depth)
    monkeypatch.setattr(ttr, "STACK_DEPTH", depth)
    deepest = []
    push = ttr.push_children

    def recorded(stack, sp, *args):
        sp = push(stack, sp, *args)
        deepest.append(int(sp.max()))
        return sp

    monkeypatch.setattr(ttr, "push_children", recorded)
    ref = jtr.intersect_bvh(jd, jp, jdir)
    got = ttr.intersect_bvh(td, tp, tdir)
    assert max(deepest) > depth  # the stack did overflow
    assert_hits_equal(ref, got)
    np.testing.assert_array_equal(ttr.occluded_bvh(td, tp, tdir, tt).numpy(),
                                  np.asarray(jtr.occluded_bvh(jd, jp, jdir, jt)))


def test_lockstep_counts_and_primal_inputs(pair):
    _, td = pair
    _, (tp, tdir, tt) = _both(4, n=64)
    for k in ttr.STATS:
        ttr.STATS[k] = 0
    p = tp.clone().requires_grad_()
    got = ttr.intersect_bvh(td, p, tdir)
    assert not got["t"].requires_grad and not got["u"].requires_grad
    assert ttr.STATS["traces"] == 1 and ttr.STATS["steps"] >= 1
    assert ttr.STATS["syncs"] == ttr.STATS["steps"] + 1  # one a step, one to end
    ttr.occluded_bvh(td, p, tdir, tt)
    assert ttr.STATS["traces"] == 2

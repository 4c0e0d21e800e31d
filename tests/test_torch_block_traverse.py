"""The port's block-shared-stack traversal (accel/block_traverse.py) and
the tracer kind "block" (sorted_trace over it) against the JAX package's,
on sphere_in_box (and the leaf tables of cornell_box too) with the JAX
package's BVH tables carried to the port, on rays drawn with numpy.

Tolerances, as in tests/test_torch_traverse.py: hit, tri and occlusion
equal (the same node order and the same strict comparison); t within
rtol 1e-5 (XLA may contract a product and a sum of the Moller-Trumbore
expression into one rounding), u and v within atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import block_traverse as jbt
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.integrator.path import make_tracer as j_make_tracer
from phosphorus_mk2_tpu_torch.accel import block_traverse as tbt
from phosphorus_mk2_tpu_torch.integrator.path import make_tracer
from test_torch_cluster import _carry, _rays
from test_torch_traverse import assert_hits_equal

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 300  # not a multiple of either block size: the last block is padded
# (scene, block): the JAX compile of a traversal takes seconds, so the
# cases are few; cornell_box's tree is one node, so sphere_in_box's deeper
# tree takes both block sizes
CASES = [("sphere_in_box", 128), ("sphere_in_box", 256)]

j_intersect = jax.jit(jbt.intersect_blocks, static_argnames="block")
j_occluded = jax.jit(jbt.occluded_blocks, static_argnames="block")


@functools.lru_cache(maxsize=None)
def _pair(name):
    jd = j_attach_bvh(getattr(jscenes, name)(8, 8).build(), cluster_mode="treelet")
    return jd, _carry(jd)


def _both(seed, n=N):
    p, d, tmax = _rays(seed, n)
    tmax[5::13] = -1.0  # a negative bound: disabled like 0
    return (tuple(jnp.asarray(x) for x in (p, d, tmax)),
            tuple(torch.from_numpy(x) for x in (p, d, tmax)))


@pytest.mark.parametrize("name", ["sphere_in_box", "cornell_box"])
def test_leaf_tables_match_jax(name):
    jd, td = _pair(name)
    for k in ("leaf_a", "leaf_e0", "leaf_e1", "leaf_id"):
        np.testing.assert_array_equal(td.bvh[k].numpy(), np.asarray(jd.bvh[k]), err_msg=k)


@pytest.mark.parametrize("name,block", CASES)
def test_intersect_blocks_matches_jax(name, block):
    jd, td = _pair(name)
    (jp, jdir, jt), (tp, tdir, tt) = _both(block)
    got = tbt.intersect_blocks(td, tp, tdir, tt, block=block)
    assert_hits_equal(j_intersect(jd, jp, jdir, jt, block=block), got)
    assert (got["t"][got["hit"]] < tt[got["hit"]]).all()
    assert torch.equal(got["t"][~got["hit"]], tt[~got["hit"]])  # a miss keeps its bound


@pytest.mark.parametrize("name,block", CASES)
def test_occluded_blocks_matches_jax(name, block):
    jd, td = _pair(name)
    (jp, jdir, jt), (tp, tdir, tt) = _both(block + 1)
    got = tbt.occluded_blocks(td, tp, tdir, tt, block=block)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_occluded(jd, jp, jdir, jt, block=block)))
    assert 0 < int(got.sum()) < N
    assert not got[tt <= 0].any()  # tmax <= 0 is disabled, not a hit at t in [0, 1e-6)


def test_block_stack_overflow_matches_jax(monkeypatch):
    """A shared stack shallower than a block's pushes (12 on this tree):
    dropped pushes and clamped pops, alike in both packages."""
    jd, td = _pair("sphere_in_box")
    (jp, jdir, _), (tp, tdir, _) = _both(7)
    monkeypatch.setattr(jbt, "STACK_DEPTH", 8)
    monkeypatch.setattr(tbt, "STACK_DEPTH", 8)
    assert_hits_equal(jbt.intersect_blocks(jd, jp, jdir), tbt.intersect_blocks(td, tp, tdir))


def test_make_tracer_block_matches_jax_closures():
    """kind="block": sorted_trace over the block tracer, both packages."""
    jd, td = _pair("sphere_in_box")
    (jp, jdir, jt), (tp, tdir, tt) = _both(9)
    j_closest, j_occluded = j_make_tracer(jd, kind="block")
    closest, occluded = make_tracer(td, kind="block")
    assert_hits_equal(j_closest(jd, jp, jdir, jt), closest(tp, tdir, tt))
    np.testing.assert_array_equal(occluded(tp, tdir, tt).numpy(),
                                  np.asarray(j_occluded(jd, jp, jdir, jt)))
    for k in tbt.STATS:
        tbt.STATS[k] = 0
    closest(tp, tdir)
    assert tbt.STATS["traces"] == 1 and tbt.STATS["syncs"] == tbt.STATS["steps"] + 1

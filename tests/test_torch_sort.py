"""The port's ray sorting (accel/sort.py) against the JAX package's.

Tolerances: the keys are integers, equal bit for bit (JAX's uint32
words, held in int64 here). sorted_trace puts every ray back in its own
place, so a sorted trace equals the unsorted one exactly: the same
tracer on the same rays.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import sort as jsort
from phosphorus_mk2_tpu_torch.accel import intersect as tint
from phosphorus_mk2_tpu_torch.accel import sort as tsort
from test_torch_cluster import _rays

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)


def _keys_both(p, d, lo, hi):
    ref = np.asarray(jsort.ray_sort_keys(*(jnp.asarray(x) for x in (p, d, lo, hi))))
    got = tsort.ray_sort_keys(*(torch.from_numpy(x) for x in (p, d, lo, hi)))
    return ref, got


def test_ray_sort_keys_match_jax():
    rs = np.random.RandomState(0)
    n = 2000
    p = rs.uniform(-3.0, 3.0, size=(n, 3)).astype(np.float32)  # some outside [lo, hi]
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::5, 0] = 0.0
    d[1::5, 1] = -0.0  # -0.0 >= 0: the positive octant bit, as in JAX
    d[2::7] = 0.0
    p[::9] = [-1.0, -2.0, 2.0]  # exactly on lo and hi
    lo = np.float32([-1.0, -2.0, -1.5])
    hi = np.float32([1.0, 2.0, 2.0])
    ref, got = _keys_both(p, d, lo, hi)
    assert ref.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert got.max() < (1 << 21) and len(np.unique(ref)) > 100


def test_ray_sort_keys_flat_extent():
    """A flat scene (hi == lo on an axis) takes the 1e-8 floor."""
    rs = np.random.RandomState(1)
    p = rs.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    d = rs.normal(size=(64, 3)).astype(np.float32)
    lo = np.float32([-1.0, 0.0, -1.0])
    hi = np.float32([1.0, 0.0, 1.0])
    ref, got = _keys_both(p, d, lo, hi)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_sort_keys_group_octants():
    p = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 1.0, 1.0], [-1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [-1.0, -1.0, -1.0]])
    keys = tsort.ray_sort_keys(p, d, torch.zeros(3), torch.ones(3))
    assert keys[0] == keys[2] and keys[0] != keys[1] != keys[3]


@pytest.fixture(scope="module")
def box():
    jd = jscenes.cornell_box(8, 8).build()
    return types.SimpleNamespace(vertices=torch.from_numpy(np.array(jd.vertices)),
                                 faces=torch.from_numpy(np.array(jd.faces)))


def test_sorted_trace_round_trip_dict(box):
    p, d, tmax = (torch.from_numpy(x) for x in _rays(2, 500))
    seen = []

    def trace(scene, pp, dd, tt):
        seen.append(pp)
        return tint.intersect_brute(scene, pp, dd, tt)

    got = tsort.sorted_trace(trace, box, p, d, tmax)
    ref = tint.intersect_brute(box, p, d, tmax)
    assert not torch.equal(seen[0], p)  # the tracer saw another order
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_sorted_trace_round_trip_tensor_and_none(box):
    p, d, tmax = (torch.from_numpy(x) for x in _rays(3, 500))
    got = tsort.sorted_trace(tint.occluded_brute, box, p, d, tmax)
    assert torch.equal(got, tint.occluded_brute(box, p, d, tmax))
    # None passes through unpermuted, as jax.tree_util.tree_map passes it
    nothing = tsort.sorted_trace(lambda scene, pp, dd, t: {"t": pp[:, 0], "none": t},
                                 box, p, d, None)
    assert nothing["none"] is None and torch.equal(nothing["t"], p[:, 0])
    closest = tsort.sorted_trace(tint.intersect_brute, box, p, d, None)
    assert torch.equal(closest["tri"], tint.intersect_brute(box, p, d)["tri"])


def test_sorted_order_matches_jax_argsort():
    """The permutation itself: a stable argsort of equal keys keeps the
    original order in both packages."""
    rs = np.random.RandomState(4)
    p = rs.uniform(-1, 1, size=(700, 3)).astype(np.float32)
    p[::3] = p[0]  # many equal keys
    d = rs.normal(size=(700, 3)).astype(np.float32)
    d[::3] = d[0]
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    ref, got = _keys_both(p, d, lo, hi)
    np.testing.assert_array_equal(torch.argsort(got, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(ref))))

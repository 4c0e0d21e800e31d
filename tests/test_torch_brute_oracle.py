"""The port's scene-level brute tracers (accel/intersect.py
intersect_brute / occluded_brute) against the JAX package's, on
cornell_box (one chunk of 128 lanes) and sphere_in_box (972 triangles:
two chunks of 512, or eight of 128), and on a built packed-key tie.

Tolerances, and why:
  * hit, tri and occlusion: equal. Both sides reduce the same packed
    uint32 keys (here held in int64).
  * t, u, v: the winner's values are recomputed by mt_intersect; t within
    rtol 1e-5, u and v within atol 1e-5 (XLA may contract a product and a
    sum into one rounding, tests/test_torch_traverse.py).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import intersect as jint
from phosphorus_mk2_tpu_torch.accel import intersect as tint
from phosphorus_mk2_tpu_torch.accel import mt
from test_torch_cluster import _rays
from test_torch_traverse import assert_hits_equal

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 300


def _soup(v, f):
    """The two fields the brute tracers read, for each package."""
    v, f = np.array(v, np.float32), np.array(f, np.int32)
    return (types.SimpleNamespace(vertices=jnp.asarray(v), faces=jnp.asarray(f)),
            types.SimpleNamespace(vertices=torch.from_numpy(v), faces=torch.from_numpy(f)))


def _scene(name):
    jd = getattr(jscenes, name)(8, 8).build()
    return _soup(jd.vertices, jd.faces)


def _both(seed, n=N):
    p, d, tmax = _rays(seed, n)
    return (tuple(jnp.asarray(x) for x in (p, d, tmax)),
            tuple(torch.from_numpy(x) for x in (p, d, tmax)))


@pytest.mark.parametrize("name,chunk", [("cornell_box", None), ("sphere_in_box", None),
                                        ("sphere_in_box", 128)])
def test_intersect_brute_matches_jax(name, chunk):
    js, ts = _scene(name)
    (jp, jd, jt), (tp, td, tt) = _both(0)
    assert_hits_equal(jint.intersect_brute(js, jp, jd, chunk=chunk),
                      tint.intersect_brute(ts, tp, td, chunk=chunk))
    got = tint.intersect_brute(ts, tp, td, tt, chunk=chunk)
    assert_hits_equal(jint.intersect_brute(js, jp, jd, jt, chunk=chunk), got)
    hit = got["hit"]
    assert 0 < int(hit.sum()) < N and (got["t"][hit] < tt[hit]).all()
    assert (got["t"][~hit] == tint.T_MAX).all() and got["tri"].dtype == torch.int32


@pytest.mark.parametrize("name,chunk", [("cornell_box", None), ("sphere_in_box", None),
                                        ("sphere_in_box", 128)])
def test_occluded_brute_matches_jax(name, chunk):
    js, ts = _scene(name)
    (jp, jd, jt), (tp, td, tt) = _both(1)
    got = tint.occluded_brute(ts, tp, td, tt, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jint.occluded_brute(js, jp, jd, jt, chunk=chunk)))
    assert 0 < int(got.sum()) < N and not got[tt == 0].any()


def test_packed_key_tie_lower_lane_wins():
    """Two facing triangles 30 and 60 ulps past t = 1: one 128-lane key
    bucket (7 cleared mantissa bits). The lower lane wins at the larger t
    in both packages; the MT kernels' plain version, exact in t, names
    the nearer one. The two differ by a packed-key tie."""
    far = np.float32(1.0).view(np.int32) + 60
    near = np.float32(1.0).view(np.int32) + 30
    zf, zn = np.array([far, near], np.int32).view(np.float32)
    v = [[-1, -1, zf], [1, -1, zf], [0, 1, zf],      # triangle 0: the farther
         [-1, -1, zn], [1, -1, zn], [0, 1, zn]]      # triangle 1: the nearer
    js, ts = _soup(v, [[0, 1, 2], [3, 4, 5]])
    rs = np.random.RandomState(2)
    p = np.zeros((16, 3), np.float32)
    p[:, :2] = rs.uniform(-0.2, 0.2, size=(16, 2))
    d = np.tile(np.float32([0, 0, 1]), (16, 1))
    ref = jint.intersect_brute(js, jnp.asarray(p), jnp.asarray(d))
    got = tint.intersect_brute(ts, torch.from_numpy(p), torch.from_numpy(d))
    assert_hits_equal(ref, got)
    assert (got["tri"] == 0).all()
    assert (got["t"] > zn).all()  # the winner's own t, recomputed
    t, tri, _, _ = mt.mt_closest_plain(mt.tri_table(ts), torch.from_numpy(p),
                                       torch.from_numpy(d))
    assert (tri == 1).all() and (t < got["t"]).all()
    lane_mask = 127
    key = lambda x: x.view(torch.int32) & ~lane_mask  # noqa: E731
    assert torch.equal(key(t), key(got["t"]))  # one key bucket: a tie


def test_brute_gradients_flow_through_the_winner():
    """As in the JAX package, t, u and v of the winner carry the vertices'
    gradient (the choice of triangle carries none)."""
    jd = jscenes.cornell_box(8, 8).build()
    v = torch.from_numpy(np.array(jd.vertices)).requires_grad_()
    scene = types.SimpleNamespace(vertices=v, faces=torch.from_numpy(np.array(jd.faces)))
    _, (tp, td, _) = _both(3, n=32)
    out = tint.intersect_brute(scene, tp, td)
    out["t"][out["hit"]].sum().backward()
    assert v.grad is not None and v.grad.abs().sum() > 0

"""The selection of the kk nearest candidates that ``front_full`` now makes
itself, on the CPU: ``front_full_plain(kk=)`` decoded against the JAX
package's ``front_all_pallas`` (its kernel in interpret mode, as
tests/test_pallas_front.py runs it, then its row sort and cut to kk), on
numpy-seeded tables and rays.

Cases: K2 not a multiple of 32 (45 and 200 superclusters); jj * SC below
kk (the prefix is the whole sorted row); rows with no hit at all; NaN
member slots and whole NaN superclusters; and the flat box whose tnear
is -0.0 before the clamp, tied at 0 with the boxes that hold the origin.

Every comparison is exact (bit-equal): both sides compute the same
float32 slab per (ray, box), one operation at a time, and keys are
integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.accel.pallas_front import front_all_pallas
from phosphorus_mk2_tpu_torch.accel import front
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX

torch.set_num_threads(1)  # several pytest workers share few cores

TM = np.float32(T_MAX)
SC = 16


def _bits(x):
    return np.asarray(x).view(np.int32)


def _table(k2, seed):
    """k2 superclusters of SC member boxes scattered in [-3, 3]^3; about
    one member slot in six empty (NaN), the last supercluster wholly
    empty, and each supercluster box the union of its members."""
    rs = np.random.RandomState(seed)
    centre = rs.uniform(-3.0, 3.0, size=(k2, 1, 3))
    mb_min = (centre + rs.uniform(-0.8, 0.2, size=(k2, SC, 3))).astype(np.float32)
    mb_max = (mb_min + rs.uniform(0.05, 0.6, size=(k2, SC, 3))).astype(np.float32)
    empty = rs.uniform(size=(k2, SC)) < 0.17
    empty[-1] = True
    mb_min[empty] = np.nan
    mb_max[empty] = np.nan
    with np.errstate(all="ignore"):
        sc_min = np.nanmin(np.where(empty[..., None], np.inf, mb_min), axis=1)
        sc_max = np.nanmax(np.where(empty[..., None], -np.inf, mb_max), axis=1)
    sc_min[-1] = np.nan
    sc_max[-1] = np.nan
    return sc_min.astype(np.float32), sc_max.astype(np.float32), mb_min, mb_max


def _rays(n, seed):
    """Origins in the table's box, random directions (some with an axis
    component of exactly 0), limits by quarters: T_MAX, short, 0 (a row
    with no hit at all) and T_MAX again."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-3.5, 3.5, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[::9, 0] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.full((n,), TM)
    t[1::4] = rs.uniform(0.1, 2.0, size=t[1::4].shape).astype(np.float32)
    t[2::4] = 0.0
    return p, d, t


def _compare(sc_min, sc_max, mb_min, mb_max, p, d, t, jj, kk):
    bounds6 = jnp.concatenate([jnp.asarray(sc_min), jnp.asarray(sc_max)], axis=1)
    ref = front_all_pallas(bounds6, jnp.asarray(mb_min), jnp.asarray(mb_max),
                           *(jnp.asarray(x) for x in (p, d, t)), jj=jj, kk=kk, interpret=True)
    args = [torch.from_numpy(x) for x in (sc_min, sc_max, mb_min, mb_max, p, d, t)]
    pk, ck = front.front_full_plain(*args, jj, kk=kk)
    width = jj * mb_min.shape[1]
    assert tuple(ck.shape) == (p.shape[0], min(kk, width))
    # the prefix of the sorted row of the unsorted keys, to the bit
    pk0, ck0 = front.front_full_plain(*args, jj)
    assert torch.equal(pk, pk0) and torch.equal(ck, torch.sort(ck0, dim=1).values[:, :kk])
    assert (ck[:, 1:] > ck[:, :-1]).all()  # unique, ascending
    got = (*front.decode_keys(ck, front.key_bits(width)),
           *front.decode_keys(pk, front.parent_key_bits(sc_min.shape[0])))
    for name, g, r in zip(("ttbl", "col", "parent_t", "parent_id"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        if g.dtype == np.float32:
            g, r = _bits(g), _bits(r)
        np.testing.assert_array_equal(g, r, err_msg=name)
    # front_all on CPU tensors returns the same decoded table
    for g, a in zip(got, front.front_all(*args, jj=jj, kk=kk)):
        assert torch.equal(g, a)
    return got


@pytest.mark.parametrize("k2,jj,kk", [(45, 16, 32), (200, 16, 32), (45, 1, 32), (200, 3, 40)],
                         ids=["k2_45", "k2_200", "jj_sc_below_kk", "k2_200_jj3_kk40"])
def test_selected_candidates_match_pallas(k2, jj, kk):
    sc_min, sc_max, mb_min, mb_max = _table(k2, seed=k2 + jj)
    p, d, t = _rays(160, seed=k2 + kk)
    ttbl, col, pt, pid = _compare(sc_min, sc_max, mb_min, mb_max, p, d, t, jj, kk)
    live = ttbl < T_MAX
    assert live.any(dim=1).sum() >= 10  # rows with candidates
    assert (~live.any(dim=1)).sum() >= 40  # and rows with none: the t_limit 0 quarter
    assert (pt[pid == k2 - 1] == T_MAX).all()  # the NaN supercluster never pends


def test_flat_box_ties_select_like_pallas():
    """The flat supercluster of tests/test_torch_wave.py: rays from the
    origin, which lies in the plane x = 0 of box 1 with dx < 0, so box 1's
    raw tnear is -0.0 and boxes 0, 1, 2 all tie at tnear 0 (box 3 lies
    ahead). Each has one real member, its own box, among NaN slots.
    kk = 4 cuts inside the ties; kk = 100 exceeds jj * SC = 64."""
    bmin = np.array([[-1, -1, -1], [0, -1, -1], [-2, -2, -2], [-3, -1e3, -1e3]], np.float32)
    bmax = np.array([[1, 1, 1], [0, 1, 1], [2, 2, 2], [-2.5, 1e3, 1e3]], np.float32)
    rs = np.random.RandomState(80)
    n = 41
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = -np.abs(d[:, 0]) - 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.zeros((n, 3), np.float32)
    p[:, 1:] = rs.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    mb_min = np.full((4, SC, 3), np.nan, np.float32)
    mb_max = np.full((4, SC, 3), np.nan, np.float32)
    for s in range(4):
        mb_min[s, (5 * s) % SC], mb_max[s, (5 * s) % SC] = bmin[s], bmax[s]
    t = np.full((n,), TM)
    for kk in (4, 100):
        ttbl, col, _, pid = _compare(bmin, bmax, mb_min, mb_max, p, d, t, 4, kk)
        assert (pid.numpy() == np.arange(4)).all()
        assert (col.numpy()[:, :3] == np.array([0, 21, 42])).all()  # j * 16 + slot, ties by column
        assert (_bits(ttbl.numpy())[:, :3] == 0).all()  # +0.0, the flat box's too
        assert tuple(col.shape) == (n, min(kk, 64))


def test_kk_must_be_positive():
    sc_min, sc_max, mb_min, mb_max = _table(45, seed=3)
    args = [torch.from_numpy(x) for x in (sc_min, sc_max, mb_min, mb_max, *_rays(8, seed=4))]
    for fn in (front.front_full_plain, front.front_full):
        with pytest.raises(ValueError, match="kk"):
            fn(*args, 16, kk=0)

"""The brute tracer's kernels as they now cut their work, on the CPU.

``mt_closest`` cuts the table's columns over several blocks and merges
their winners by the least (t, column); ``mt_anyhit`` walks the table
with a compacted list of the rays still live. Their plain versions
reproduce both, and here they are held against the unsplit walk (bit
for bit) and against the JAX package's Pallas kernels, run in interpret
mode as tests/test_pallas.py runs them, on numpy-seeded rays. Both walk
only the tiles that reach into the table's live columns, and that stop
changes nothing. The launch plan that picks the split on the card is
checked at the main path's shapes.

Tolerances, as in tests/test_torch_mt.py: tri and hit equal; t within
rtol 1e-5 (XLA may contract a product and a sum into one rounding where
PyTorch rounds twice); u and v within atol 1e-5.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel.pallas_mt import intersect_pallas_brute, occluded_pallas_brute
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.accel import mt
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, mt_intersect_soa

torch.set_num_threads(1)  # several pytest workers share few cores

j_closest = functools.partial(intersect_pallas_brute, interpret=True)
j_occluded = functools.partial(occluded_pallas_brute, interpret=True)

SPLITS = (1, 2, 3, 7)
DUPS = 300  # triangles copied into multi_bsdf_scene's pad columns


def _bits(x):
    return x.contiguous().view(torch.int32).numpy()


def _scene(name):
    return (getattr(jscenes, name)(8, 8).build(),
            getattr(tscenes, name)(8, 8).build(device="cpu"))


def _rays(seed, n):
    """The test_pallas.py mix: origins in the box, random directions. In
    multi_bsdf_scene most of them end on the box's walls, its first
    twelve triangles."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _occluders(table, p, d, tmax):
    """(n, Tp) bool: every column that occludes each ray, all pairs at once."""
    rp = tuple(torch.from_numpy(p[:, i : i + 1]) for i in range(3))
    rd = tuple(torch.from_numpy(d[:, i : i + 1]) for i in range(3))
    rows = [table[i : i + 1] for i in range(9)]
    t, _, _, ok = mt_intersect_soa(rp, rd, tuple(rows[0:3]), tuple(rows[3:6]), tuple(rows[6:9]))
    return ok & (t < torch.from_numpy(tmax)[:, None]) & (table[9].view(torch.int32) >= 0)[None, :]


@pytest.fixture(scope="module")
def multi():
    """multi_bsdf_scene's table (ten 512-column chunks), 240 random rays,
    the JAX reference on them, and the unsplit plain result."""
    jd, td = _scene("multi_bsdf_scene")
    table = mt.tri_table(td)
    assert table.shape[1] == 10 * mt.TRI_TILE and td.num_tris + DUPS <= table.shape[1]
    p, d = _rays(41, 240)
    ref = j_closest(jd, jnp.asarray(p), jnp.asarray(d))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    whole = mt.mt_closest_plain(table, torch.from_numpy(p), torch.from_numpy(d))
    return table, td.num_tris, p, d, ref, whole


def _same_bits(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _near_jax(got, ref):
    t, tri, u, v = (x.numpy() for x in got)
    hit = ref["hit"]
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(tri, ref["tri"])
    np.testing.assert_allclose(t[hit], ref["t"][hit], rtol=1e-5)
    np.testing.assert_allclose(u[hit], ref["u"][hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], ref["v"][hit], atol=1e-5)
    np.testing.assert_array_equal(t[~hit], np.float32(T_MAX))


@pytest.mark.parametrize("splits", SPLITS)
def test_split_merge_equals_the_unsplit_walk_and_jax(multi, splits):
    table, _, p, d, ref, whole = multi
    got = mt.mt_closest_plain(table, torch.from_numpy(p), torch.from_numpy(d), splits=splits)
    _same_bits(got, whole)
    _near_jax(got, ref)


@pytest.mark.parametrize("splits", SPLITS)
def test_split_ties_go_to_the_lowest_column(multi, splits):
    """The first DUPS triangles copied into the pad columns under new ids:
    every tie lies across a split boundary for splits > 1 (the copies sit
    in the last split), and every hit must name the first copy."""
    table, num, p, d, ref, whole = multi
    dup = table.clone()
    dup[:9, num : num + DUPS] = table[:9, :DUPS]
    dup[9, num : num + DUPS] = torch.arange(num, num + DUPS, dtype=torch.int32).view(torch.float32)
    got = mt.mt_closest_plain(dup, torch.from_numpy(p), torch.from_numpy(d), splits=splits)
    tri = got[1].numpy()
    assert ((tri >= 0) & (tri < DUPS)).sum() > 100  # rays that meet a duplicated triangle
    _same_bits(got, whole)
    _near_jax(got, ref)


def test_split_beyond_the_tile_count_is_one_tile_a_split(multi):
    table, _, p, d, _, whole = multi
    got = mt.mt_closest_plain(table, torch.from_numpy(p), torch.from_numpy(d),
                              splits=10_000)
    _same_bits(got, whole)


@pytest.mark.parametrize("splits", (1, 3))
def test_a_winning_t_of_zero_is_stored_as_plus_zero(splits):
    """Rays that start at the centroid of an axis-aligned cornell_box
    triangle (exactly on its plane) win there at t = 0, as +0.0 or -0.0 by the
    determinant's sign. The plain version stores +0.0 (bits 0), as the
    kernel must (its key is t's bits), and the JAX package's winner is the
    same triangle at t == 0 as a float."""
    jd, td = _scene("cornell_box")
    table = mt.tri_table(td)
    n = 400
    normal = torch.cross(table[3:6, : td.num_tris].T, table[6:9, : td.num_tris].T, dim=1)
    flat = torch.nonzero((normal == 0).sum(dim=1) == 2)[:, 0]  # axis-aligned: exactly planar
    cols = flat[torch.arange(n) % len(flat)]
    a, e0, e1 = (table[r : r + 3, cols].T for r in (0, 3, 6))
    p = (a + (e0 + e1) / 3).contiguous()
    rs = np.random.RandomState(5)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d)
    t, tri, u, v = mt.mt_closest_plain(table, p, d, splits=splits)
    zero = (t == 0).numpy()
    assert zero.sum() > n // 4
    assert (_bits(t)[zero] == 0).all()
    # the arithmetic itself gives -0.0 at some of these winners
    c = table[:, tri.long().clamp(min=0)].T
    raw, _, _, _ = mt_intersect_soa(
        (p[:, 0:1], p[:, 1:2], p[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
        (c[:, 0:1], c[:, 1:2], c[:, 2:3]), (c[:, 3:4], c[:, 4:5], c[:, 5:6]),
        (c[:, 6:7], c[:, 7:8], c[:, 8:9]))
    assert (_bits(raw[:, 0])[zero] == np.int32(-(1 << 31))).any()
    ref = j_closest(jd, jnp.asarray(p.numpy()), jnp.asarray(d.numpy()))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(ref["tri"]))
    np.testing.assert_array_equal(np.asarray(ref["t"])[zero], 0.0)


@pytest.fixture(scope="module")
def anyhit_inputs():
    """multi_bsdf_scene, 160 random rays, and 60 rays whose only occluders
    lie in the table's last non-empty 128-column tile: each starts a
    short way off one of those triangles, along its normal, and points
    back at its centroid, tmax just past it."""
    jd, td = _scene("multi_bsdf_scene")
    table = mt.tri_table(td)
    p, d = _rays(17, 160)
    rs = np.random.RandomState(18)
    last = (td.num_tris - 1) // 128 * 128
    t = table.numpy()
    cols = rs.randint(last, td.num_tris, size=600)
    cen = (t[0:3, cols] + (t[3:6, cols] + t[6:9, cols]) / 3).T
    nrm = np.cross(t[3:6, cols].T, t[6:9, cols].T)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    h = rs.uniform(0.01, 0.05, size=(600, 1)).astype(np.float32)
    side = np.where(rs.uniform(size=(600, 1)) < 0.5, -1.0, 1.0)
    lp = (cen + side * h * nrm).astype(np.float32)
    ld = (-side * nrm).astype(np.float32)
    ltm = (1.5 * h[:, 0]).astype(np.float32)
    occ = _occluders(table, lp, ld, ltm)
    only_last = occ.any(dim=1) & ~occ[:, :last].any(dim=1)
    keep = np.flatnonzero(only_last.numpy())[:60]
    assert len(keep) == 60
    return jd, table, (p, d), (lp[keep], ld[keep], ltm[keep])


@pytest.mark.parametrize("case", ["zero", "nan", "negative", "t_max", "mixed", "last_tile"])
def test_anyhit_compacted_walk_matches_pallas_and_all_pairs(anyhit_inputs, case):
    jd, table, (p, d), last = anyhit_inputs
    n = p.shape[0]
    rs = np.random.RandomState(3)
    tmax = {
        "zero": np.zeros(n, np.float32),
        "nan": np.full(n, np.nan, np.float32),
        "negative": -rs.uniform(0.1, 3.0, size=n).astype(np.float32),
        "t_max": np.full(n, T_MAX, np.float32),
        "mixed": np.where(np.arange(n) % 4 == 0, np.nan,
                          np.where(np.arange(n) % 4 == 1, -1.0,
                                   rs.uniform(0.0, 3.0, size=n))).astype(np.float32),
    }.get(case)
    if case == "last_tile":
        p, d, tmax = last
    got = mt.mt_anyhit_plain(table, torch.from_numpy(p), torch.from_numpy(d),
                             torch.from_numpy(tmax)).numpy()
    ref = np.asarray(j_occluded(jd, jnp.asarray(p), jnp.asarray(d), jnp.asarray(tmax)))
    pairs = (_occluders(table, p, d, tmax).any(dim=1).numpy() & (tmax > 0))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pairs)
    if case in ("zero", "nan", "negative"):
        assert not got.any()
    else:
        assert got.any()
        if case == "last_tile":
            assert got.all()


def test_live_columns_end_at_the_last_triangle(multi):
    table, num, _, _, _, _ = multi
    assert mt.live_columns(table) == num
    dup = table.clone()
    dup[9, num + 5] = torch.tensor(7, dtype=torch.int32).view(torch.float32)
    assert mt.live_columns(dup) == num + 6  # a triangle after a pad column
    dup[9] = torch.full_like(dup[9].view(torch.int32), -1).view(torch.float32)
    assert mt.live_columns(dup) == 0


@pytest.mark.parametrize("scene", ["cornell_box", "multi_bsdf_scene"])
def test_the_walk_that_stops_at_the_live_columns_equals_the_whole_walk(scene):
    """cornell_box's 36 triangles fill one 64-column tile of 512 and
    multi_bsdf_scene's 4,812 end in tile 76 of 80: the kernels stop there,
    and the result is that of the whole table, to the bit."""
    jd, td = _scene(scene)
    table = mt.tri_table(td)
    p, d = _rays(29, 200)
    p, d = torch.from_numpy(p), torch.from_numpy(d)
    tmax = torch.from_numpy(np.random.RandomState(30).uniform(0.0, 3.0, 200).astype(np.float32))
    tp = table.shape[1]
    for splits in (1, 3):
        _same_bits(mt.mt_closest_plain(table, p, d, splits=splits),
                   mt.mt_closest_plain(table, p, d, splits=splits, cols=tp))
    occ = mt.mt_anyhit_plain(table, p, d, tmax)
    np.testing.assert_array_equal(occ.numpy(), mt.mt_anyhit_plain(table, p, d, tmax, tp).numpy())
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(j_occluded(jd, jnp.asarray(p.numpy()), jnp.asarray(d.numpy()),
                                           jnp.asarray(tmax.numpy()))))


def test_a_table_without_triangles_hits_nothing():
    table = torch.zeros((10, mt.TRI_TILE), dtype=torch.float32)
    table[9] = torch.full((mt.TRI_TILE,), -1, dtype=torch.int32).view(torch.float32)
    p, d = (torch.from_numpy(x) for x in _rays(3, 20))
    t, tri, u, v = mt.mt_closest(table, p, d)
    assert (tri == -1).all() and (t == T_MAX).all() and (u == 0).all() and (v == 0).all()
    assert not mt.mt_anyhit(table, p, d, torch.full((20,), T_MAX)).any()


@pytest.mark.parametrize("cols", [-1, mt.TRI_TILE + 1])
def test_cols_outside_the_table_raise(cols):
    table = torch.zeros((10, mt.TRI_TILE), dtype=torch.float32)
    p, d = (torch.from_numpy(x) for x in _rays(3, 4))
    with pytest.raises(ValueError, match="cols"):
        mt.mt_closest(table, p, d, cols=cols)
    with pytest.raises(ValueError, match="cols"):
        mt.mt_anyhit(table, p, d, torch.ones(4), cols=cols)


RESIDENT = (132, 6)  # an H100's SMs, mt_closest blocks resident on an SM


@pytest.mark.parametrize("tp", [36, 512, 4812, 5120, 530944])
@pytest.mark.parametrize("n", [1, 31, 65536, 262144])
def test_closest_launch_plan(n, tp):
    """tp: the live columns the plan is given (cornell_box's 36 and
    multi_bsdf_scene's 4,812 triangles among them)."""
    sms, per_sm = RESIDENT
    plan = mt.closest_plan(n, tp, sms, per_sm)
    resident = sms * per_sm
    tiles = -(-tp // mt.CLOSEST_TILE)
    assert plan["ray_tile"] == mt.CLOSEST_THREADS * mt.CLOSEST_RAYS
    assert plan["ray_tiles"] == -(-n // plan["ray_tile"])
    assert plan["col_tiles"] == tiles and plan["resident"] == resident
    assert plan["scratch_bytes"] == 8 * n
    s, per = plan["splits"], plan["tiles_per_split"]
    assert s >= 1 and per >= 1 and (s - 1) * per < tiles <= s * per  # no split empty
    assert plan["blocks"] == plan["ray_tiles"] * s

    # WAVES waves of resident blocks where the tiles allow (the tiles
    # evened out over the splits may cost up to half of them); one split
    # when the rays alone give them
    target = mt.WAVES * resident
    if plan["ray_tiles"] >= target:
        assert s == 1
    else:
        assert 2 * plan["blocks"] >= min(target, plan["ray_tiles"] * tiles)
    if n >= 65536 and tp >= 4812:  # the brute renders' shapes: three waves or more
        assert plan["blocks"] >= 3 * resident

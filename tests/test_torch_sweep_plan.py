"""wave_sweep (the cluster tracer's exact fallback) as its kernel cuts the
work, on the CPU.

The kernel cuts the m listed rays into tiles and the clusters into ranges
(``sweep_plan``), one block each: every (tile, range) is tested against
the best t the rays had at the call, and a ray's winners are merged by
the least (t bits << 32 | cluster * C + lane) key. ``wave_sweep_plain(
plan=)`` walks that cut; here it is held against the uncut
``wave_sweep_plain`` (bit for bit: the same Moller-Trumbore arithmetic on
the same rows) and against the JAX package's fallback step (``_mt_rows``
with ``cand_base`` over every cluster, as its ``_trace`` runs it) on
numpy-seeded inputs, on multi_bsdf_scene's 56 clusters. The plan that
cuts the work on the card is checked from given SM counts and
occupancies.

Tolerances: cluster and lane equal; t equal to the bit against the uncut
walk, within rtol 1e-5 against the JAX package (XLA may contract a
product and a sum of the Moller-Trumbore expression into one rounding
where PyTorch rounds twice, as in tests/test_torch_wave.py).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import cluster_traverse as jct
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData
from phosphorus_mk2_tpu_torch.accel import cluster_traverse as tct
from phosphorus_mk2_tpu_torch.accel import wave
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy

torch.set_num_threads(1)  # several pytest workers share few cores

TM = np.float32(T_MAX)
TILES = (wave.WARP_TILE, wave.STAGED_TILE)  # the two layouts' rays a tile
N = 120  # rays in a case; the listed ones are a subset


@pytest.fixture(scope="module")
def tables():
    """multi_bsdf_scene's cluster rows (56 clusters) from the JAX package's
    BVH, as a JAX array and as a CPU tensor."""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    arrays = {
        f.name: np.asarray(getattr(jd, f.name))
        for f in dataclasses.fields(JSceneData)
        if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"
    }
    arrays["bvh"] = {k: np.asarray(v) for k, v in jd.bvh.items()}
    static = {k: getattr(jd, k) for k in JSceneData.STATIC_FIELDS}
    td = scene_data_from_numpy(arrays, static, device="cpu")
    return jct._cluster_rows(jd), tct._cluster_rows(td)


def _rays(table_np, seed, n=N):
    """n rays from random origins in the box: the even ones aimed at the
    centroid of a real triangle (non-zero edges) of a random cluster, so
    that they hit, the odd ones in random directions."""
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    for i in range(0, n, 2):
        row = table_np[rs.randint(table_np.shape[0])]
        real = np.nonzero(np.abs(row[3:6]).sum(axis=0) > 0)[0]
        lane = real[rs.randint(len(real))]
        d[i] = row[0:3, lane] + (row[3:6, lane] + row[6:9, lane]) / 3 - p[i]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _state(n, seed, starts=(T_MAX, 1.0, 0.0)):
    """best t drawn from ``starts`` (by default T_MAX, short, 0), no hit."""
    rs = np.random.RandomState(seed)
    best_t = rs.choice(np.array(starts, np.float32), size=n)
    return best_t, np.full((n,), -1, np.int32), np.zeros((n,), np.int32)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _sweep(fn, p, d, table, idx, best, **kw):
    """fn on copies of the state; returns the state after it."""
    state = _t(*best)
    fn(*_t(p, d), table, torch.from_numpy(idx), *state, **kw)
    return state


def _jax_fallback(rows_j, p, d, idx, best):
    """The JAX package's fallback step for the listed rays: _mt_rows with
    cand_base 0 over every cluster, in one block."""
    m = idx.shape[0]
    K, _, C = rows_j.shape
    rows = jnp.broadcast_to(rows_j[None], (m, K, 9, C))
    cur = tuple(jnp.asarray(b[idx]) for b in best)
    return jct._mt_rows(jnp.asarray(p[idx]), jnp.asarray(d[idx]), rows, cur,
                        jnp.ones((m,), bool), cand_base=jnp.zeros((m,), jnp.int32))


def _agree(got, whole, ref, idx):
    """got equals the uncut walk to the bit; the listed rays equal the JAX
    step (t at rtol 1e-5)."""
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[1].numpy()[idx], np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy()[idx], np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy()[idx], np.asarray(ref[0]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 56, 5803])
@pytest.mark.parametrize("m", [1, 7, 33, 2048])
def test_plan_covers_every_ray_and_cluster_once(m, k):
    """Tiles cover each listed ray once and ranges each cluster once (no
    range empty, the last one may be short); the grid stays within limits,
    holds at most SWEEP_WAVES waves of resident blocks (and a block a
    tile), gives a block's warps SWEEP_MIN_ROWS rows each where K allows,
    and fills at least half a wave when the work allows."""
    for sms, per_sm in ((132, 2), (132, 7), (114, 1), (1, 1)):
        plan = wave.sweep_plan(m, k, sms, per_sm)
        r, per, splits = plan["tile"], plan["per_block"], plan["splits"]
        assert r == wave.sweep_tile(m) and r in TILES
        assert plan["tiles"] == -(-m // r)
        rays = np.concatenate([np.arange(j0, min(j0 + r, m))
                               for j0 in range(0, plan["tiles"] * r, r)])
        np.testing.assert_array_equal(rays, np.arange(m))
        ranges = [(s * per, min(k, (s + 1) * per)) for s in range(splits)]
        assert all(a < b for a, b in ranges)
        np.testing.assert_array_equal(
            np.concatenate([np.arange(a, b) for a, b in ranges]), np.arange(k))
        resident = sms * per_sm
        assert plan["resident_blocks"] == resident
        assert plan["blocks"] == plan["tiles"] * splits < 2**31 - 1
        assert plan["blocks"] <= resident * wave.SWEEP_WAVES + plan["tiles"]
        unit = (wave.SWEEP_WARPS if r == wave.WARP_TILE else 1) * wave.SWEEP_MIN_ROWS
        assert splits <= -(-k // unit)
        assert plan["blocks"] >= min(resident, plan["tiles"] * -(-k // unit)) / 2


def test_tile_follows_the_ray_count():
    """Tiles of 4 rays a warp up to 16 rays; then the rows staged, tiles
    of 32 rays."""
    want = {1: 4, 2: 4, 5: 4, 8: 4, 16: 4, 17: 32, 24: 32, 33: 32, 448: 32, 1023: 32,
            1024: 32, 2048: 32, 100000: 32}
    assert {m: wave.sweep_tile(m) for m in want} == want


# ---------------------------------------------------------------------------
# the plain walk of the cut
# ---------------------------------------------------------------------------

def _cut(tile, splits, k):
    """A plan of ``splits`` ranges (as sweep_plan normalises them)."""
    per = -(-k // splits)
    return {"tile": tile, "splits": -(-k // per), "per_block": per}


@pytest.mark.parametrize("splits", [1, 3, 56])
@pytest.mark.parametrize("tile", TILES)
def test_plan_walk_equals_the_uncut_walk_and_jax(tables, tile, splits):
    """40 listed rays of 120, best t T_MAX / short / 0, in tiles of
    ``tile`` against one range, three (19, 19 and 18 clusters) or one
    cluster a range."""
    rows_j, table = tables
    p, d = _rays(table.numpy(), seed=3)
    best = _state(N, seed=4)
    idx = np.random.RandomState(5).permutation(N)[:40].astype(np.int32)
    plan = _cut(tile, splits, table.shape[0])
    assert plan["splits"] == splits
    got = _sweep(wave.wave_sweep_plain, p, d, table, idx, best, plan=plan)
    whole = _sweep(wave.wave_sweep_plain, p, d, table, idx, best)
    _agree(got, whole, _jax_fallback(rows_j, p, d, idx, best), idx)
    hit = got[1].numpy()[idx] >= 0
    assert 5 < hit.sum() < 40  # hits and misses both
    rest = np.setdiff1d(np.arange(N), idx)
    assert (got[1].numpy()[rest] == -1).all()  # only the listed rays are swept


@pytest.mark.parametrize("tile", TILES)
def test_equal_t_in_two_clusters_of_different_ranges_goes_to_the_lower(tables, tile):
    """Clusters K..K+5 copy 0..5: a ray aimed at a triangle of cluster c
    meets it at equal t in c and K + c, which the plan puts in different
    ranges; the winner is c, the lower flat index, as the uncut walk and
    the JAX step have it."""
    rows_j, table = tables
    K = table.shape[0]
    twin = torch.cat([table, table[:6]])
    twin_j = jnp.concatenate([rows_j, rows_j[:6]])
    rs = np.random.RandomState(6)
    n = 48
    cid = rs.randint(0, 6, size=n)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.empty_like(d)
    tn = table.numpy()
    for i in range(n):  # 0.05 short of a triangle's centroid: it is the nearest
        real = np.nonzero(np.abs(tn[cid[i], 3:6]).sum(axis=0) > 0)[0]
        lane = real[rs.randint(len(real))]
        target = tn[cid[i], 0:3, lane] + (tn[cid[i], 3:6, lane] + tn[cid[i], 6:9, lane]) / 3
        p[i] = target - 0.05 * d[i]
    best = _state(n, seed=7, starts=(T_MAX,))
    idx = np.arange(n, dtype=np.int32)
    plan = _cut(tile, 4, twin.shape[0])
    per = plan["per_block"]
    assert all(c // per != (K + c) // per for c in range(6))
    got = _sweep(wave.wave_sweep_plain, p, d, twin, idx, best, plan=plan)
    whole = _sweep(wave.wave_sweep_plain, p, d, twin, idx, best)
    _agree(got, whole, _jax_fallback(twin_j, p, d, idx, best), idx)
    c = got[1].numpy()
    assert (c < K).all()  # never the copy
    assert (c == cid).sum() > n // 2


@pytest.mark.parametrize("start", [T_MAX, 0.5, 0.0])
def test_starting_best_t(tables, start):
    """Every listed ray starts at best t T_MAX, short (0.5) or 0; with 0
    nothing is below it and the state stays as it was, bit for bit."""
    rows_j, table = tables
    p, d = _rays(table.numpy(), seed=8)
    best = _state(N, seed=9, starts=(start,))
    idx = np.arange(0, N, 3, dtype=np.int32)
    for tile in TILES:
        plan = _cut(tile, 5, table.shape[0])
        got = _sweep(wave.wave_sweep_plain, p, d, table, idx, best, plan=plan)
        whole = _sweep(wave.wave_sweep_plain, p, d, table, idx, best)
        _agree(got, whole, _jax_fallback(rows_j, p, d, idx, best), idx)
        hits = int((got[1].numpy() >= 0).sum())
        if start == 0.0:
            for a, b in zip(got, _t(*best)):
                assert torch.equal(a, b)
        else:
            assert hits > 0


@pytest.mark.parametrize("tile", TILES)
def test_a_minus_zero_winner_is_plus_zero(tile):
    """Rays that start ON a triangle of cluster 1 with a negative
    determinant get t = -0.0 there; the cut walk stores +0.0, as the
    uncut walk does (the JAX package keeps -0.0, equal as a float)."""
    C, n = 128, 24
    table_np = np.zeros((3, 9, C), np.float32)
    rs = np.random.RandomState(91)
    a = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    table_np[1, 0:3, :n] = a.T
    table_np[1, 3:6, :n] = np.array([[1, 0, 0]], np.float32).T
    table_np[1, 6:9, :n] = np.array([[0, 1, 0]], np.float32).T
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))  # det = -1
    best = (np.full((n,), TM), np.full((n,), -1, np.int32), np.zeros((n,), np.int32))
    idx = np.arange(n, dtype=np.int32)
    table = torch.from_numpy(table_np)
    ref = _jax_fallback(jnp.asarray(table_np), a, d, idx, best)
    assert (np.asarray(ref[0]) == 0.0).all()
    plan = _cut(tile, 3, 3)
    got = _sweep(wave.wave_sweep_plain, a, d, table, idx, best, plan=plan)
    assert (got[0].numpy().view(np.int32) == 0).all()  # +0.0
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("tile", TILES)
def test_one_listed_ray(tables, tile):
    """m = 1: a ray aimed at a triangle, alone in its tile."""
    rows_j, table = tables
    p, d = _rays(table.numpy(), seed=10)
    best = _state(N, seed=11, starts=(T_MAX,))
    idx = np.array([4], np.int32)
    plan = _cut(tile, 7, table.shape[0])
    got = _sweep(wave.wave_sweep_plain, p, d, table, idx, best, plan=plan)
    whole = _sweep(wave.wave_sweep_plain, p, d, table, idx, best)
    _agree(got, whole, _jax_fallback(rows_j, p, d, idx, best), idx)
    assert got[1].numpy()[4] >= 0


def test_the_wrapper_on_cpu_tensors_and_a_bad_plan(tables):
    """wave_sweep on CPU tensors takes the plain walk; a plan that does
    not cut the table raises."""
    _, table = tables
    p, d = _rays(table.numpy(), seed=12)
    best = _state(N, seed=13)
    idx = np.arange(0, N, 2, dtype=np.int32)
    whole = _sweep(wave.wave_sweep_plain, p, d, table, idx, best)
    got = _sweep(wave.wave_sweep, p, d, table, idx, best)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        _sweep(wave.wave_sweep_plain, p, d, table, idx, best,
               plan={"tile": 8, "splits": 3, "per_block": 10})


# ---------------------------------------------------------------------------
# the kernel's skip: a triangle whose first edge is zero never hits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e1", ["zero", "unit"])
@pytest.mark.parametrize("ray", ["random", "from_the_vertex", "zero_component",
                                 "infinite_component"])
def test_a_zero_first_edge_never_hits(ray, e1):
    """The staged sweep kernel skips a quad whose four triangles have
    e0 = (+-0, +-0, +-0), the pads of a row among them; that is exact only
    if no ray hits such a triangle. Its determinant is then 0 or NaN
    (an infinite or NaN direction component), and mt_rows and the JAX
    package's _mt_rows take no hit from it, even for a ray that starts on
    its vertex."""
    C, n = 128, 64
    rs = np.random.RandomState(92)
    table_np = np.zeros((2, 9, C), np.float32)
    table_np[:, 0:3] = rs.uniform(-1, 1, size=(2, 3, C))
    table_np[:, 3:6] = np.where(rs.rand(2, 3, C) < 0.5, -0.0, 0.0)  # e0 of +0 and -0
    if e1 == "unit":
        table_np[:, 6:9] = rs.normal(size=(2, 3, C))
    p = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if ray == "from_the_vertex":
        p = table_np[rs.randint(2, size=n), 0:3, rs.randint(C, size=n)].astype(np.float32)
    elif ray == "zero_component":
        d[:, rs.randint(3)] = 0.0
    elif ray == "infinite_component":
        d[:, 1] = np.inf
    best = (np.full((n,), TM), np.full((n,), -1, np.int32), np.zeros((n,), np.int32))
    idx = np.arange(n, dtype=np.int32)
    with np.errstate(invalid="ignore", over="ignore"):
        got = _sweep(wave.wave_sweep_plain, p, d, torch.from_numpy(table_np), idx, best)
        ref = _jax_fallback(jnp.asarray(table_np), p, d, idx, best)
    assert (got[1].numpy() == -1).all() and (np.asarray(ref[1]) == -1).all()
    assert (got[0].numpy() == TM).all()

"""The plain versions of the port's wave kernels (accel/wave.py) against
the JAX package, on inputs drawn with numpy, and the repair of a tnear of
-0.0.

The JAX package has no Pallas kernel behind the wave body (it is XLA),
so the reference is its own code: ``_mt_rows`` with the live gate and the
masked row gather of ``chunk_fn`` written out, its ``cand_base`` form
over all clusters, and whole traces through ``intersect_clusters`` /
``occluded_clusters``. The row-gather probe's reference is ``np.take``.

Tolerances, and why:
  * cluster, lane, tri, hit and occlusion: equal;
  * t: rtol 1e-5, since XLA may contract a product and a sum of the
    Moller-Trumbore expression into one rounding where PyTorch rounds
    twice (the tolerance of tests/test_torch_cluster.py); against the
    port's own brute tracer, same arithmetic, t is equal;
  * slab tnear, packed keys, table order, gathered rows: equal to the
    bit (one float32 operation at a time on both sides, integer keys).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import cluster_traverse as jct
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.accel.pallas_front import front_all_pallas
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData
from phosphorus_mk2_tpu_torch.accel import cluster_traverse as tct
from phosphorus_mk2_tpu_torch.accel import front, mt, wave
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy
from phosphorus_mk2_tpu_torch.tools import row_gather_probe

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 300
TM = np.float32(T_MAX)


@pytest.fixture(scope="module")
def scene_pair():
    """multi_bsdf_scene (4,812 triangles, 56 clusters) with the JAX
    package's BVH tables on both sides."""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    arrays = {
        f.name: np.asarray(getattr(jd, f.name))
        for f in dataclasses.fields(JSceneData)
        if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"
    }
    arrays["bvh"] = {k: np.asarray(v) for k, v in jd.bvh.items()}
    static = {k: getattr(jd, k) for k in JSceneData.STATIC_FIELDS}
    return jd, scene_data_from_numpy(arrays, static, device="cpu")


def _rays(seed, n=N):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rs.uniform(0.0, 3.0, size=n).astype(np.float32)
    tmax[::7] = 0.0
    tmax[3::7] = 1e-6  # the integrator's dead lanes
    return p, d, tmax


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _bits(x):
    return np.asarray(x).view(np.int32)


# ---------------------------------------------------------------------------
# wave_mt
# ---------------------------------------------------------------------------

def _wave_inputs(K, W, any_hit, seed):
    """Rays, W table columns and a state with every case in it: best t
    T_MAX / short / 0, columns at tnear 0 / mid / T_MAX (dead, their ids
    out of range), rays with no live column and, for an any-hit trace,
    rays that already hold a hit."""
    p, d, _ = _rays(seed)
    rs = np.random.RandomState(seed + 100)
    col_c = rs.randint(0, K, size=(N, W)).astype(np.int32)
    col_t = rs.choice(np.array([0.0, 0.3, T_MAX], np.float32), size=(N, W), p=[0.5, 0.3, 0.2])
    col_t[::11] = TM
    col_c[col_t == TM] = K + 9  # never an address
    best_t = rs.choice(np.array([T_MAX, 1.2, 0.0], np.float32), size=N, p=[0.5, 0.4, 0.1])
    best_c = np.full((N,), -1, np.int32)
    best_l = np.zeros((N,), np.int32)
    if any_hit:
        best_c[2::5] = 3
        best_l[2::5] = 17
    return p, d, col_t, col_c, best_t, best_c, best_l


def _jax_wave(jd, p, d, col_t, col_c, any_hit, best):
    """What chunk_fn of the JAX package's _trace does for one chunk."""
    rows_tbl = jct._cluster_rows(jd)
    p, d, col_t, col_c = _j(p, d, col_t, col_c)
    cur = _j(*best)
    live = (col_t < cur[0][:, None]) & (col_t < T_MAX)
    if any_hit:
        live = live & (cur[1] < 0)[:, None]
    rows = rows_tbl[jnp.where(live, col_c, 0)]
    live_el = jnp.broadcast_to(live[:, :, None], live.shape + (rows.shape[-1],))
    return jct._mt_rows(p, d, rows, cur, live_el, cand_cids=col_c), np.asarray(live)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("W", [1, 4])
def test_wave_mt_plain_matches_jax_mt_rows(scene_pair, W, any_hit):
    jd, td = scene_pair
    table = tct._cluster_rows(td)
    K = table.shape[0]
    p, d, col_t, col_c, *best = _wave_inputs(K, W, any_hit, seed=20 + W)
    ref, live = _jax_wave(jd, p, d, col_t, col_c, any_hit, best)
    assert live.any(axis=1).sum() not in (0, N) and (~live).any()
    got = _t(*best)
    wave.wave_mt_plain(*_t(p, d), table, *_t(col_t, col_c), any_hit, *got)
    changed = got[1].numpy() != best[1]
    assert changed.any() and not changed.all()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    if any_hit:  # a ray that held a hit keeps its record
        assert (got[1].numpy()[2::5] == 3).all() and (got[2].numpy()[2::5] == 17).all()
    # the wrapper takes the plain version for CPU tensors; a small chunk and
    # a column range of a wider table (row stride) change nothing
    before = dict(wave.LAUNCHES)
    wide_t = np.concatenate([np.full((N, 2), 0.1, np.float32), col_t], axis=1)
    wide_c = np.concatenate([np.zeros((N, 2), np.int32), col_c], axis=1)
    for fn, kw, ct_, cc_ in (
        (wave.wave_mt, {}, *_t(col_t, col_c)),
        (wave.wave_mt_plain, {"chunk": 37}, *_t(col_t, col_c)),
        (wave.wave_mt_plain, {}, torch.from_numpy(wide_t)[:, 2:], torch.from_numpy(wide_c)[:, 2:]),
    ):
        again = _t(*best)
        fn(*_t(p, d), table, ct_, cc_, any_hit, *again, **kw)
        for a, b in zip(again, got):
            assert torch.equal(a, b)
    assert wave.LAUNCHES == before  # launches count kernel launches only


def test_wave_mt_columns_meet_the_best_t_of_the_call(scene_pair):
    """With W > 1 every column is tested against the best t at the START:
    one call over W columns equals mt_rows on all of them at once, and
    may differ from W calls of one column only in work, never in the
    winner (min t, then the lowest w * C + lane)."""
    _, td = scene_pair
    table = tct._cluster_rows(td)
    p, d, col_t, col_c, *best = _wave_inputs(table.shape[0], 4, False, seed=31)
    col_c[:, 2] = col_c[:, 0]  # a duplicated cluster: the first column wins
    col_t[:, 2] = col_t[:, 0]
    once = _t(*best)
    wave.wave_mt_plain(*_t(p, d), table, *_t(col_t, col_c), False, *once)
    steps = _t(*best)
    for w in range(4):
        wave.wave_mt_plain(*_t(p, d), table, torch.from_numpy(col_t)[:, w : w + 1],
                           torch.from_numpy(col_c)[:, w : w + 1], False, *steps)
    for a, b in zip(once, steps):
        assert torch.equal(a, b)


def test_a_winning_t_of_minus_zero_is_stored_as_plus_zero():
    """A ray that starts ON a triangle (at its first vertex) with a
    negative determinant gets t = 0 * (1 / det) = -0.0. The kernels store
    +0.0 (their winner is an integer minimum over t's bits), and so do
    the plain versions: the state is +0.0 to the bit, in the wave and in
    the fallback, and the JAX package's winner is the same triangle at
    t == 0."""
    C, n = 128, 6
    table_np = np.zeros((2, 9, C), np.float32)  # padded lanes: zero edges, det 0, never hit
    rs = np.random.RandomState(90)
    a = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    table_np[1, 0:3, :n] = a.T
    table_np[1, 3:6, :n] = np.array([[1, 0, 0]], np.float32).T  # e0 = x
    table_np[1, 6:9, :n] = np.array([[0, 1, 0]], np.float32).T  # e1 = y
    p = a.copy()
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))  # det = e0 . (d x e1) = -1
    table = torch.from_numpy(table_np)
    col_t = np.zeros((n, 1), np.float32)
    col_c = np.ones((n, 1), np.int32)
    best = (np.full((n,), TM), np.full((n,), -1, np.int32), np.zeros((n,), np.int32))
    # the arithmetic does give -0.0, here and in the JAX package
    rows = jnp.asarray(table_np)[jnp.asarray(col_c)]
    ref = jct._mt_rows(*_j(p, d), rows, _j(*best), jnp.ones((n, 1, C), bool),
                       cand_cids=jnp.asarray(col_c))
    assert (_bits(ref[0]) == np.int32(-(1 << 31))).all()
    got = _t(*best)
    wave.wave_mt(*_t(p, d), table, *_t(col_t, col_c), False, *got)
    swept = _t(*best)
    wave.wave_sweep(*_t(p, d), table, torch.arange(n, dtype=torch.int32), *swept)
    for state in (got, swept):
        assert (_bits(state[0].numpy()) == 0).all()  # +0.0
        np.testing.assert_array_equal(state[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(state[2].numpy(), np.arange(n))
        np.testing.assert_array_equal(state[2].numpy(), np.asarray(ref[2]))


# ---------------------------------------------------------------------------
# wave_sweep
# ---------------------------------------------------------------------------

def test_wave_sweep_plain_matches_jax_cand_base_and_brute(scene_pair):
    jd, td = scene_pair
    table = tct._cluster_rows(td)
    K, _, C = table.shape
    p, d, _ = _rays(40)
    rs = np.random.RandomState(41)
    idx = rs.permutation(N)[:60].astype(np.int32)
    best = (rs.choice(np.array([T_MAX, 1.0], np.float32), size=N, p=[0.7, 0.3]),
            np.full((N,), -1, np.int32), np.zeros((N,), np.int32))
    # the JAX package's fallback step, every cluster in one block
    rows = jnp.broadcast_to(jct._cluster_rows(jd)[None], (60, K, 9, C))
    ref = jct._mt_rows(*_j(p[idx], d[idx]), rows, _j(*(b[idx] for b in best)),
                       jnp.ones((60,), bool), cand_base=jnp.zeros((60,), jnp.int32))
    got = _t(*best)
    wave.wave_sweep_plain(*_t(p, d), table, torch.from_numpy(idx), *got)
    sel = torch.from_numpy(idx).long()
    assert (got[1][sel] >= 0).any() and not (got[1][sel] >= 0).all()
    np.testing.assert_array_equal(got[1][sel].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2][sel].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0][sel].numpy(), np.asarray(ref[0]), rtol=1e-5)
    rest = np.setdiff1d(np.arange(N), idx)
    assert (got[1].numpy()[rest] == -1).all()  # only the listed rays are swept
    # blocks of 5 clusters, the last overlapping (56 = 11 * 5 + 1), and the
    # wrapper on CPU tensors: the same winners
    for fn, kw in ((wave.wave_sweep_plain, {"fb_cc": 5}), (wave.wave_sweep, {})):
        again = _t(*best)
        fn(*_t(p, d), table, torch.from_numpy(idx), *again, **kw)
        for a, b in zip(again, got):
            assert torch.equal(a, b)
    # the brute tracer over all triangles: same t, same triangle
    closest, _ = mt.brute_tracer(mt.tri_table(td))
    brute = closest(*_t(p[idx], d[idx], best[0][idx]))
    tri = tct._winner_tri(td, got[1][sel], got[2][sel])
    np.testing.assert_array_equal(tri.numpy(), brute["tri"].numpy())
    hit = brute["hit"].numpy()
    np.testing.assert_array_equal(got[0][sel].numpy()[hit], brute["t"].numpy()[hit])


# ---------------------------------------------------------------------------
# row_gather and its probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", wave.VARIANTS)
def test_row_gather_plain_matches_take(scene_pair, variant):
    _, td = scene_pair
    table = tct._cluster_rows(td)
    K = table.shape[0]
    idx = np.random.RandomState(50).randint(0, K, size=500).astype(np.int32)
    idx[:40] = idx[40]
    idx[60:64] = (0, K - 1, 0, K - 1)
    want = np.take(table.numpy(), idx, axis=0)
    for fn in (wave.row_gather_plain, wave.row_gather):
        got = fn(torch.from_numpy(idx), table, variant)
        assert tuple(got.shape) == (500, 9, 128)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert wave.row_gather(torch.from_numpy(idx[:0]), table, variant).shape == (0, 9, 128)


def test_probe_inputs_and_checksum_on_the_cpu():
    idx, table = row_gather_probe.inputs("cpu", k=50, r=20, seed=3)
    rng = np.random.default_rng(3)
    want_table = rng.random((50, 1, 1152)).astype(np.float32)
    want_idx = rng.integers(0, 50, size=(20,))
    np.testing.assert_array_equal(table.numpy().reshape(50, 1, 1152), want_table)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    res = row_gather_probe.probe("staged", device="cpu", k=50, r=20, seed=3)
    want = want_table[want_idx, 0, :128].astype(np.float64).sum()
    assert res["checksum"] == pytest.approx(want, rel=1e-12)
    # a time exists only on a card
    assert res["ms"] is None and res["ns_per_row"] is None and res["eff_gbps"] is None
    assert (row_gather_probe.K, row_gather_probe.R, res["row_bytes"]) == (10987, 4096, 4608)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            row_gather_probe.probe("direct")


# ---------------------------------------------------------------------------
# the wrappers' checks
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device: what a wrapper
    meets when it is handed a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def test_wrappers_check_their_inputs(scene_pair):
    _, td = scene_pair
    table = tct._cluster_rows(td)
    K = table.shape[0]
    p, d, col_t, col_c, *best = _wave_inputs(K, 2, False, seed=60)
    p, d, col_t, col_c = _t(p, d, col_t, col_c)
    idx = torch.arange(10, dtype=torch.int32)

    def state():
        return _t(*best)

    # a sliced (non-contiguous) table is refused by every wrapper
    for sliced in (table[:, :, ::2], table[::2], table.transpose(0, 1)):
        with pytest.raises(ValueError):
            wave.row_gather(idx, sliced)
        with pytest.raises(ValueError):
            wave.wave_mt(p, d, sliced, col_t, col_c, False, *state())
        with pytest.raises(ValueError):
            wave.wave_sweep(p, d, sliced, idx, *state())
    with pytest.raises(ValueError, match="variant"):
        wave.row_gather(idx, table, "pipe")
    with pytest.raises(ValueError):
        wave.row_gather(idx.long(), table)
    with pytest.raises(ValueError):
        wave.row_gather(idx, table.double())
    with pytest.raises(ValueError):
        wave.wave_mt(p, d, table, col_t, col_c.long(), False, *state())
    with pytest.raises(ValueError):
        wave.wave_mt(p, d, table, col_t[:, 0], col_c[:, 0], False, *state())
    with pytest.raises(ValueError):
        wave.wave_mt(p[:-1], d, table, col_t, col_c, False, *state())
    t, c, lane = state()
    with pytest.raises(ValueError):
        wave.wave_mt(p, d, table, col_t, col_c, False, t, c.long(), lane)
    with pytest.raises(ValueError):
        wave.wave_sweep(p, d, table, idx.long(), *state())


def test_a_cuda_tensor_never_gives_way_to_the_plain_version(scene_pair):
    """Handed a CUDA tensor where no kernel can be built, a wrapper
    raises: it does not take the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernels build")
    _, td = scene_pair
    table = tct._cluster_rows(td).as_subclass(_OnCard)
    p, d, col_t, col_c, *best = _wave_inputs(table.shape[0], 1, False, seed=61)
    p, d = (x.as_subclass(_OnCard) for x in _t(p, d))
    idx = torch.arange(10, dtype=torch.int32)
    assert wave._lib is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wave.row_gather(idx, table)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wave.wave_mt(p, d, table, *_t(col_t, col_c), False, *_t(*best))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wave.wave_sweep(p, d, table, idx, *_t(*best))
    assert set(wave.LAUNCHES) >= {"row_gather", "wave_mt", "wave_sweep"}
    assert not any(wave.LAUNCHES.values())


# ---------------------------------------------------------------------------
# whole traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recompact", [0, 8])
@pytest.mark.parametrize("dense_waves", [0, 2])
@pytest.mark.parametrize("dense_k", [0, 1], ids=["dense_front", "hier_front"])
def test_trace_matches_jax(scene_pair, dense_k, dense_waves, recompact):
    jd, td = scene_pair
    tune = {"dense_k": dense_k, "dense_waves": dense_waves, "recompact": recompact}
    p, d, tmax = _rays(70 + dense_waves)
    closest_tmax = np.where(tmax > 0.5, TM, tmax)  # T_MAX, short, 0, 1e-6
    ref = jax.jit(lambda p, d, t: jct.intersect_clusters(jd, p, d, t, **tune))(
        *_j(p, d, closest_tmax))
    occ_ref = jax.jit(lambda p, d, t: jct.occluded_clusters(jd, p, d, t, **tune))(
        *_j(p, d, tmax))
    for k in tct.STATS:
        tct.STATS[k] = 0
    got = tct.intersect_clusters(td, *_t(p, d, closest_tmax), **tune)
    assert got["hit"].any() and not got["hit"].all()
    assert tct.STATS["waves"] > 0
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(ref["tri"]))
    hit = got["hit"].numpy()
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(ref["t"])[hit], rtol=1e-5)
    occ = tct.occluded_clusters(td, *_t(p, d, tmax), **tune)
    assert occ.any() and not occ.all()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    # plain=True is the same path on CPU tensors
    again = tct.intersect_clusters(td, *_t(p, d, closest_tmax), plain=True, **tune)
    assert torch.equal(again["tri"], got["tri"]) and torch.equal(again["t"], got["t"])


# ---------------------------------------------------------------------------
# a tnear of -0.0
# ---------------------------------------------------------------------------

def _flat_box_case():
    """Rays from the origin, which lies IN the plane x = 0 of a flat box,
    with dx < 0: (0 - 0) * (1 / dx) is -0.0 on every axis-x slab, so the
    flat box's raw tnear is -0.0. Boxes 0 and 2 hold the origin (tnear
    +0.0, one at a lower and one at a higher column than the flat box 1),
    box 3 lies ahead (tnear > 0), box 4 behind (a miss)."""
    bmin = np.array([[-1, -1, -1], [0, -1, -1], [-2, -2, -2], [-3, -1e3, -1e3], [1, 1, 1]],
                    np.float32)
    bmax = np.array([[1, 1, 1], [0, 1, 1], [2, 2, 2], [-2.5, 1e3, 1e3], [2, 2, 2]], np.float32)
    rs = np.random.RandomState(80)
    n = 41  # odd: a vectorised maximum and its scalar tail may treat -0.0 differently
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:, 0] = -np.abs(d[:, 0]) - 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = np.zeros((n, 3), np.float32)
    p[:, 1:] = rs.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    return bmin, bmax, p, d


def test_slab_tnear_of_a_flat_box_is_plus_zero_like_jax():
    bmin, bmax, p, d = _flat_box_case()
    hit_ref, tn_ref = jct._slab_all(*_j(p, d, bmin, bmax))
    hit, tn = tct._slab_all(*_t(p, d, bmin, bmax))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    assert hit.numpy()[:, :4].all() and not hit.numpy()[:, 4].any()
    assert (_bits(tn_ref)[:, :3] == 0).all()  # +0.0, the flat box too
    np.testing.assert_array_equal(_bits(tn.numpy()), _bits(tn_ref))
    # the raw interval does carry the -0.0, and the clamp keeps NaN
    inv = 1.0 / torch.from_numpy(d)
    raw, _ = tct._slab_interval(torch.from_numpy(p), inv, torch.from_numpy(bmin)[None],
                                torch.from_numpy(bmax)[None])
    assert (_bits(raw.numpy())[:, 1] == np.int32(-(1 << 31))).all()
    clamped = front.clamp0(torch.tensor([-0.0, 0.0, -1.0, 2.5, float("nan")]))
    assert _bits(clamped.numpy())[:4].tolist() == _bits(np.array([0, 0, 0, 2.5], np.float32)).tolist()
    assert torch.isnan(clamped[4])


def test_packed_keys_of_a_flat_box_order_by_column_like_jax():
    bmin, bmax, p, d = _flat_box_case()
    hit_ref, tn_ref = jct._slab_all(*_j(p, d, bmin, bmax))
    packed_ref = jct._pack_cols(jnp.where(hit_ref, tn_ref, T_MAX), 5)[0]
    hit, tn = tct._slab_all(*_t(p, d, bmin, bmax))
    cand = torch.where(hit, tn, T_MAX)
    keys = front.pack_keys(cand, front.key_bits(5))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(packed_ref).view(np.int32))
    assert (keys.numpy() >= 0).all()  # a -0.0 key would be negative
    for mode in ("sort", "extract"):
        t_ref, c_ref = jct._select_topk(jnp.where(hit_ref, tn_ref, T_MAX), 4, mode=mode)
        t_got, c_got = tct._select_topk(cand, 4, mode=mode)
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
        np.testing.assert_array_equal(_bits(t_got.numpy()), _bits(t_ref))
        assert (c_got.numpy() == np.arange(4)).all()  # 0, 1 (flat), 2, then the box ahead


def test_dense_front_table_of_a_flat_box_matches_jax():
    bmin, bmax, p, d = _flat_box_case()
    t_limit = np.full((p.shape[0],), TM)
    jb = {"cluster_bmin": jnp.asarray(bmin), "cluster_bmax": jnp.asarray(bmax)}
    tb = {"cluster_bmin": torch.from_numpy(bmin), "cluster_bmax": torch.from_numpy(bmax)}
    t_ref, c_ref, _ = jct._front_table_dense(*_j(p, d), jb, jnp.asarray(t_limit), 4)
    t_got, c_got, _ = tct._front_table_dense(*_t(p, d), tb, torch.from_numpy(t_limit), 4)
    np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(_bits(t_got.numpy()), _bits(np.abs(np.asarray(t_ref))))
    assert (_bits(t_got.numpy())[:, :3] == 0).all()
    # the recompaction packs these tnear with their cluster ids: no key is
    # negative, so the flat box keeps its place between boxes 0 and 2
    keys = front.pack_keys(front.clamp0(t_got), front.key_bits(5), c_got)
    assert (torch.sort(keys, dim=1).values == keys).all()


def test_front_all_plain_of_a_flat_supercluster_matches_pallas():
    """The two-level table: superclusters 0 and 2 hold the origin, 1 is
    the flat one; each has one real member (its own box) among NaN
    slots. Parents and candidates come out in column order, as the
    Pallas kernel (interpret mode) gives them."""
    bmin, bmax, p, d = _flat_box_case()
    k2 = 4
    mb_min = np.full((k2, 16, 3), np.nan, np.float32)
    mb_max = np.full((k2, 16, 3), np.nan, np.float32)
    for s in range(k2):
        mb_min[s, (5 * s) % 16], mb_max[s, (5 * s) % 16] = bmin[s], bmax[s]
    t_limit = np.full((p.shape[0],), TM)
    bounds6 = jnp.concatenate([jnp.asarray(bmin[:k2]), jnp.asarray(bmax[:k2])], axis=1)
    ref = front_all_pallas(bounds6, jnp.asarray(mb_min), jnp.asarray(mb_max),
                           *_j(p, d, t_limit), jj=4, kk=4, interpret=True)
    got = front.front_all(*_t(bmin[:k2], bmax[:k2], mb_min, mb_max, p, d, t_limit),
                          jj=4, kk=4, plain=True)
    for name, g, r in zip(("ttbl", "col", "parent_t", "parent_id"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        if g.dtype == np.float32:
            g, r = _bits(g), _bits(r)
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert (got[3].numpy() == np.arange(4)).all()           # parents 0, 1 (flat), 2, 3
    assert (got[1].numpy()[:, :3] == np.array([0, 21, 42])).all()  # j * 16 + member slot

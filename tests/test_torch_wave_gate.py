"""wave_mt as its kernel cuts the work, on the CPU.

The kernel gates G rays a warp, a lane a ray, and per column groups the
live rays of a warp by cluster: each group's row is fetched once, every
(ray, column) winner comes from one warp reduction against the best t of
the call, and a ray's winners are merged by the least (t, w * C + lane).
``wave_mt_plain(gate=G)`` walks that decomposition; here it is held
against the uncut ``wave_mt_plain`` (bit for bit: the same mt_rows
arithmetic on the same rows) and against the JAX package's ``_mt_rows``
with the live gate and masked gather of its ``chunk_fn`` written out, on
numpy-seeded inputs. The launch plan that picks G on the card is checked
from a given SM count and occupancy.

Tolerances: cluster and lane equal; t equal to the bit against the port's
uncut walk, within rtol 1e-5 against the JAX package (XLA may contract a
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
N = 200


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


def _aimed(table_np, col_c, seed):
    """Rays from random origins in the box, each aimed at the centroid of a
    real triangle (non-zero edges) of its first column's cluster, so that
    most live columns hold a hit."""
    rs = np.random.RandomState(seed)
    n = col_c.shape[0]
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = np.empty_like(p)
    for i in range(n):
        row = table_np[col_c[i, 0]]
        real = np.nonzero(np.abs(row[3:6]).sum(axis=0) > 0)[0]
        lane = real[rs.randint(len(real))]
        target = row[0:3, lane] + (row[3:6, lane] + row[6:9, lane]) / 3
        d[i] = target - p[i]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _state(n, seed, any_hit):
    rs = np.random.RandomState(seed)
    best_t = rs.choice(np.array([T_MAX, 1.5, 0.0], np.float32), size=n, p=[0.6, 0.3, 0.1])
    best_c = np.full((n,), -1, np.int32)
    best_l = np.zeros((n,), np.int32)
    if any_hit:
        best_c[3::7] = 5
        best_l[3::7] = 9
    return best_t, best_c, best_l


def _case(name, table_np, seed):
    """(col_t, col_c, any_hit) of one adversarial case; K clusters."""
    K = table_np.shape[0]
    rs = np.random.RandomState(seed)
    any_hit = name == "any_hit"
    W = 3 if name in ("columns", "any_hit", "ties") else 1
    if name == "one_cluster":
        col_c = np.full((N, W), 7, np.int32)
    elif name == "own_cluster":  # every ray of a warp on a cluster of its own
        col_c = (np.arange(N, dtype=np.int32) % K)[:, None].copy()
    else:
        col_c = rs.randint(0, 6, size=(N, W)).astype(np.int32)  # few clusters: groups
    if name == "ties":  # clusters K..K+5 copy 0..5: one triangle at equal t in two columns
        col_c[:, 2] = col_c[:, 0]
        col_c[0::2, 0] += K
        col_c[1::2, 2] += K
    col_t = np.where(rs.uniform(size=(N, W)) < 0.8, np.float32(0.0), TM).astype(np.float32)
    col_t[:, 0] = 0.0
    col_t[::13] = TM
    col_c[col_t == TM] = K + 5  # never an address
    return col_t, col_c, any_hit


def _jax_wave(rows_j, p, d, col_t, col_c, any_hit, best):
    """chunk_fn of the JAX package's _trace for one chunk: live gate,
    masked row gather, _mt_rows over every column at once."""
    p, d, col_t, col_c = (jnp.asarray(x) for x in (p, d, col_t, col_c))
    cur = tuple(jnp.asarray(x) for x in best)
    live = (col_t < cur[0][:, None]) & (col_t < T_MAX)
    if any_hit:
        live = live & (cur[1] < 0)[:, None]
    rows = rows_j[jnp.where(live, col_c, 0)]
    live_el = jnp.broadcast_to(live[:, :, None], live.shape + (rows.shape[-1],))
    return jct._mt_rows(p, d, rows, cur, live_el, cand_cids=col_c)


CASES = ("one_cluster", "own_cluster", "columns", "any_hit", "ties")


@pytest.mark.parametrize("gate", wave.GATES)
@pytest.mark.parametrize("name", CASES)
def test_gated_walk_equals_the_uncut_walk_and_jax(tables, name, gate):
    rows_j, table = tables
    col_t, col_c, any_hit = _case(name, table.numpy(), seed=CASES.index(name))
    if name == "ties":
        rows_j = jnp.concatenate([rows_j, rows_j[:6]])
        table = torch.cat([table, table[:6]])
    table_np = table.numpy()
    p, d = _aimed(table_np, np.where(col_c < table.shape[0], col_c, 0), seed=10 + gate)
    best = _state(N, seed=20 + CASES.index(name), any_hit=any_hit)
    t = [torch.from_numpy(np.array(x)) for x in (p, d, col_t, col_c)]
    got, whole = ([torch.from_numpy(x.copy()) for x in best] for _ in range(2))
    wave.wave_mt_plain(t[0], t[1], table, t[2], t[3], any_hit, *got, gate=gate)
    wave.wave_mt_plain(t[0], t[1], table, t[2], t[3], any_hit, *whole)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    assert (got[1].numpy() != best[1]).sum() > N // 4  # most rays take a hit
    ref = _jax_wave(rows_j, p, d, col_t, col_c, any_hit, best)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    # the wrapper on CPU tensors takes the same walk
    again = [torch.from_numpy(x.copy()) for x in best]
    wave.wave_mt(t[0], t[1], table, t[2], t[3], any_hit, *again, gate=gate)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    if name == "ties":  # a winner met in columns 0 and 2 at equal t is column 0's
        K = table.shape[0] - 6
        c = got[1].numpy()
        both = (c >= 0) & (c % K == col_c[:, 0] % K) & (col_t[:, 2] < TM)
        assert both.sum() > N // 4
        np.testing.assert_array_equal(c[both], col_c[both, 0])


def test_groups_count_the_rows_a_warp_fetches(tables):
    """One row a (warp, column, cluster) with a live ray: all rays on one
    cluster share a row a warp, rays on clusters of their own take one
    each, and a dead column fetches nothing."""
    _, table = tables
    K = table.shape[0]
    n = 64
    col_t = torch.zeros((n, 2))
    best_t, best_c = torch.full((n,), T_MAX), torch.full((n,), -1, dtype=torch.int32)
    one = torch.full((n, 2), 7, dtype=torch.int32)
    assert wave.wave_groups(col_t, one, best_t, best_c, False, K, 8) == 2 * (n // 8)
    assert wave.wave_groups(col_t, one, best_t, best_c, False, K, 32) == 2 * (n // 32)
    own = (torch.arange(n, dtype=torch.int32) % K)[:, None].expand(n, 2).contiguous()
    assert wave.wave_groups(col_t, own, best_t, best_c, False, K, 16) == 2 * n
    dead = col_t.clone()
    dead[:, 1] = T_MAX
    assert wave.wave_groups(dead, one, best_t, best_c, False, K, 8) == n // 8
    best_c[::2] = 1  # any-hit: rays that hold a hit gate nothing
    assert wave.wave_groups(col_t, own, best_t, best_c, True, K, 8) == n


def test_a_minus_zero_winner_in_a_shared_group_is_plus_zero():
    """Rays that start ON a triangle of one cluster with a negative
    determinant get t = -0.0; grouped into one warp's row they all win
    there, stored as +0.0, as the uncut walk and the JAX package (as
    -0.0, equal as a float) have it."""
    C, n = 128, 24
    table_np = np.zeros((2, 9, C), np.float32)
    rs = np.random.RandomState(91)
    a = rs.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    table_np[1, 0:3, :n] = a.T
    table_np[1, 3:6, :n] = np.array([[1, 0, 0]], np.float32).T
    table_np[1, 6:9, :n] = np.array([[0, 1, 0]], np.float32).T
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))  # det = -1
    col_t = np.zeros((n, 1), np.float32)
    col_c = np.ones((n, 1), np.int32)
    best = (np.full((n,), TM), np.full((n,), -1, np.int32), np.zeros((n,), np.int32))
    ref = _jax_wave(jnp.asarray(table_np), a, d, col_t, col_c, False, best)
    table = torch.from_numpy(table_np)
    for gate in wave.GATES:
        got = [torch.from_numpy(x.copy()) for x in best]
        wave.wave_mt_plain(*(torch.from_numpy(x) for x in (a, d)), table,
                           *(torch.from_numpy(x) for x in (col_t, col_c)), False, *got, gate=gate)
        assert (got[0].numpy().view(np.int32) == 0).all()  # +0.0
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        assert (np.asarray(ref[0]) == 0.0).all()


@pytest.mark.parametrize("n", [1, 300, 65536, 131072, 262144, 1 << 20])
@pytest.mark.parametrize("sms,per_sm", [(132, 3), (132, 4), (114, 2)])
def test_gate_plan(n, sms, per_sm):
    """The widest gate that still gives a wave of resident warps; the
    narrowest when none does. Blocks cover every warp."""
    plan = wave.gate_plan(n, sms, per_sm)
    resident = sms * per_sm * wave.MT_WARPS
    g = plan["g"]
    assert g in wave.GATES and plan["resident_warps"] == resident
    assert plan["warps"] == -(-n // g)
    assert plan["blocks"] == -(-plan["warps"] // wave.MT_WARPS)
    if g != wave.GATES[-1]:
        assert plan["warps"] >= resident
    wider = [w for w in wave.GATES if w > g]
    assert all(-(-n // w) < resident for w in wider)
    # at the main path's shapes on an H100 (132 SMs, 4 blocks an SM)
    if (sms, per_sm) == (132, 4):
        assert g == {1: 8, 300: 8, 65536: 8, 131072: 16, 262144: 32, 1 << 20: 32}[n]


def test_gate_must_be_a_warp_width(tables):
    _, table = tables
    n = 4
    z = torch.zeros((n, 3))
    args = (z, z, table, torch.zeros((n, 1)), torch.zeros((n, 1), dtype=torch.int32), False,
            torch.full((n,), T_MAX), torch.full((n,), -1, dtype=torch.int32),
            torch.zeros((n,), dtype=torch.int32))
    for fn in (wave.wave_mt_plain, wave.wave_mt):
        with pytest.raises(ValueError, match="gate"):
            fn(*args, gate=12)

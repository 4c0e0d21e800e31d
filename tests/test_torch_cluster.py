"""The port's cluster tracer against the JAX package's, helper by helper,
trace by trace and film by film, on inputs drawn with numpy.

The BVH tables are the JAX package's own (attach_bvh, native builder),
carried to the port with scene_data_from_numpy, so both sides trace the
same clusters.

Tolerances, and why:
  * helpers (slab, packed-key selection, member expansion, id
    reconstruction, winner lookup): exact. One float32 operation at a
    time on both sides, and integer keys.
  * ``_mt_rows`` and whole traces: cluster, lane, tri and hit equal; t
    within rtol 1e-5, since XLA may contract a product and a sum of the
    Moller-Trumbore expression into one rounding where PyTorch rounds
    twice. A ray whose tri differs must be an exact tie, its two t
    bit-equal against the port's own brute tracer (same arithmetic); the
    ties are counted, printed and must be few.
Whole films are held in tests/test_torch_cluster_render.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import cluster_traverse as jct
from phosphorus_mk2_tpu.accel.bvh_builder import attach_bvh as j_attach_bvh
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.accel import cluster_traverse as tct
from phosphorus_mk2_tpu_torch.accel import mt
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh as t_attach_bvh
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy
from phosphorus_mk2_tpu_torch.integrator.path import make_tracer

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 400


def _carry(jd):
    arrays = {
        f.name: np.asarray(getattr(jd, f.name))
        for f in dataclasses.fields(JSceneData)
        if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"
    }
    arrays["bvh"] = {k: np.asarray(v) for k, v in jd.bvh.items()}
    static = {k: getattr(jd, k) for k in JSceneData.STATIC_FIELDS}
    return scene_data_from_numpy(arrays, static, device="cpu")


@pytest.fixture(scope="module")
def scene_pair():
    """multi_bsdf_scene with the JAX package's BVH tables, on both sides."""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    return jd, _carry(jd)


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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def test_slab_all_matches_jax(scene_pair):
    jd, td = scene_pair
    p, d, _ = _rays(0)
    d[::9, 0] = 0.0
    hit_ref, tn_ref = jct._slab_all(*_j(p, d), jd.bvh["sc_member_bmin"].reshape(-1, 3),
                                    jd.bvh["sc_member_bmax"].reshape(-1, 3))
    hit, tn = tct._slab_all(*_t(p, d), td.bvh["sc_member_bmin"].reshape(-1, 3),
                            td.bvh["sc_member_bmax"].reshape(-1, 3))
    assert np.isnan(np.asarray(tn_ref)).any()  # the padded members
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(tn_ref))


@pytest.mark.parametrize("mode", ["sort", "extract"])
def test_select_topk_matches_jax(scene_pair, mode):
    jd, td = scene_pair
    p, d, _ = _rays(1)
    hit, tn = jct._slab_all(*_j(p, d), jd.bvh["cluster_bmin"], jd.bvh["cluster_bmax"])
    cand = np.asarray(jnp.where(hit, tn, T_MAX))  # many tn = 0 ties, many T_MAX
    for k in (1, 5, 32):
        t_ref, c_ref = jct._select_topk(jnp.asarray(cand), k, mode=mode)
        t_got, c_got = tct._select_topk(*_t(cand), k, mode=mode)
        np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_ref))
        np.testing.assert_array_equal(c_got.numpy(), np.asarray(c_ref))
    with pytest.raises(ValueError):
        tct._select_topk(*_t(cand), 4, mode="heap")


def test_dense_front_table_orders_ties_like_top_k(scene_pair):
    """jax.lax.top_k returns the lower index first among equal values;
    every box that holds the ray origin has tnear 0."""
    jd, td = scene_pair
    p, d, tmax = _rays(2)
    tmax = np.where(tmax > 0.5, np.float32(T_MAX), tmax)
    kk = 32
    t_ref, c_ref, _ = jct._front_table_dense(*_j(p, d), jd.bvh, jnp.asarray(tmax), kk)
    t_got, c_got, _ = tct._front_table_dense(*_t(p, d), td.bvh, torch.from_numpy(tmax), kk)
    t_ref = np.asarray(t_ref)
    assert ((t_ref[:, 0] == 0) & (t_ref[:, 1] == 0)).any(), "no tie in this ray set"
    np.testing.assert_array_equal(t_got.numpy(), t_ref)
    live = t_ref < np.float32(T_MAX)
    np.testing.assert_array_equal(c_got.numpy()[live], np.asarray(c_ref)[live])


@pytest.mark.parametrize("expand_batch", [1, 3, 16])
def test_expand_members_and_reconstruct_ids_match_jax(scene_pair, expand_batch):
    jd, td = scene_pair
    p, d, tmax = _rays(3)
    tmax = np.where(tmax > 1.0, np.float32(T_MAX), tmax)
    k2 = td.bvh["sc_bmin"].shape[0]
    rs = np.random.RandomState(4)
    ptbl = rs.randint(0, k2, size=(N, 3)).astype(np.int32)
    p_t = np.where(rs.uniform(size=(N, 3)) < 0.7, np.float32(0.25), np.float32(T_MAX))
    ref_c, ref_pad = jct._expand_members(
        *_j(p, d), jd.bvh["sc_member_bmin"], jd.bvh["sc_member_bmax"], *_j(ptbl, p_t, tmax),
        expand_batch=expand_batch)
    got_c, got_pad = tct._expand_members(
        *_t(p, d), td.bvh["sc_member_bmin"], td.bvh["sc_member_bmax"], *_t(ptbl, p_t, tmax),
        expand_batch=expand_batch)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_pad.numpy(), np.asarray(ref_pad))
    col = rs.randint(0, got_c.shape[1], size=(N, 8)).astype(np.int32)
    ref_ids = jct._reconstruct_ids(ref_pad, jnp.asarray(col), 16)
    got_ids = tct._reconstruct_ids(got_pad, torch.from_numpy(col), 16)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))


@pytest.mark.parametrize("form", ["cids", "base"])
def test_mt_rows_matches_jax(scene_pair, form):
    jd, td = scene_pair
    p, d, _ = _rays(5)
    rs = np.random.RandomState(6)
    rows_j = jct._cluster_rows(jd)
    rows_t = tct._cluster_rows(td)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    K = rows_t.shape[0]
    W = 3
    best = (np.where(rs.uniform(size=N) < 0.5, np.float32(T_MAX), np.float32(1.2)),
            np.full((N,), -1, np.int32), np.zeros((N,), np.int32))
    live = rs.uniform(size=N) < 0.9
    if form == "cids":
        cids = rs.randint(0, K, size=(N, W)).astype(np.int32)
        cids[:, 2] = cids[:, 0]  # a duplicated cluster: the first flat index wins
        ref = jct._mt_rows(*_j(p, d), rows_j[jnp.asarray(cids)], _j(*best), jnp.asarray(live),
                           cand_cids=jnp.asarray(cids))
        got = tct._mt_rows(*_t(p, d), rows_t[torch.from_numpy(cids).long()], _t(*best),
                           torch.from_numpy(live), cand_cids=torch.from_numpy(cids))
    else:
        base = np.full((N,), 7, np.int32)
        ref = jct._mt_rows(*_j(p, d), jnp.broadcast_to(rows_j[7:7 + W][None], (N, W, 9, 128)),
                           _j(*best), jnp.asarray(live), cand_base=jnp.asarray(base))
        got = tct._mt_rows(*_t(p, d), rows_t[7:7 + W][None].expand(N, -1, -1, -1), _t(*best),
                           torch.from_numpy(live), cand_base=torch.from_numpy(base))
    assert (np.asarray(ref[1]) >= 0).any()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    tri_ref = jct._winner_tri(jd, ref[1], ref[2])
    tri_got = tct._winner_tri(td, got[1], got[2])
    np.testing.assert_array_equal(tri_got.numpy(), np.asarray(tri_ref))
    assert ((tri_got >= 0) == (got[1] >= 0)).all()


# ---------------------------------------------------------------------------
# whole traces
# ---------------------------------------------------------------------------

TUNES = {
    "dense": {},
    "dense_recompact0": {"recompact": 0},
    "dense_recompact3_head2": {"recompact": 3, "dense_waves": 2, "chunk": 64},
    "dense_fallback": {"front_k": 2},
    "hier": {"dense_k": 1},
    "hier_extract_recompact0": {"dense_k": 1, "sc_topk": "extract", "recompact": 0},
    "hier_fallback": {"dense_k": 1, "sc_front": 2, "front_k": 4, "fb_cc": 5},
}
MAX_TIES = 2  # of 400 rays


def _assert_same_hits(name, got_tri, got_t, ref_tri, ref_t, brute_tri, brute_t):
    got_tri, got_t = got_tri.numpy(), got_t.numpy()
    hit = ref_tri >= 0
    np.testing.assert_array_equal(got_tri >= 0, hit)
    np.testing.assert_allclose(got_t[hit], ref_t[hit], rtol=1e-5)
    # against the port's own brute tracer the arithmetic is the same: t equal
    np.testing.assert_array_equal(got_tri >= 0, brute_tri >= 0)
    np.testing.assert_array_equal(got_t[hit], brute_t[hit])
    ties = int((got_tri != ref_tri).sum()) + int((got_tri != brute_tri).sum())
    print(f"{name}: {ties} tri differences at equal t")
    assert ties <= MAX_TIES, ties


@pytest.mark.parametrize("name", sorted(TUNES))
def test_intersect_and_occluded_match_jax_and_brute(scene_pair, name):
    jd, td = scene_pair
    tune = TUNES[name]
    p, d, tmax = _rays(9)
    closest_tmax = np.where(tmax > 0.5, np.float32(T_MAX), tmax)  # T_MAX, short, 0, 1e-6
    ref = jax.jit(lambda p, d, t: jct.intersect_clusters(jd, p, d, t, **tune))(
        *_j(p, d, closest_tmax))
    occ_ref = jax.jit(lambda p, d, t: jct.occluded_clusters(jd, p, d, t, **tune))(
        *_j(p, d, tmax))
    b_closest, b_occluded = mt.brute_tracer(mt.tri_table(td))
    brute = b_closest(*_t(p, d, closest_tmax))
    for k in tct.STATS:
        tct.STATS[k] = 0
    got = tct.intersect_clusters(td, *_t(p, d, closest_tmax), **tune)
    if "fallback" in name:
        assert tct.STATS["fallback_rays"] > 0
    assert got["hit"].any() and not got["hit"].all()
    _assert_same_hits(name, got["tri"], got["t"], np.asarray(ref["tri"]), np.asarray(ref["t"]),
                      brute["tri"].numpy(), brute["t"].numpy())
    hit = got["hit"].numpy()
    np.testing.assert_allclose(got["u"].numpy()[hit], np.asarray(ref["u"])[hit], atol=1e-5)
    np.testing.assert_allclose(got["v"].numpy()[hit], np.asarray(ref["v"])[hit], atol=1e-5)
    occ = tct.occluded_clusters(td, *_t(p, d, tmax), **tune)
    assert occ.any() and not occ[torch.from_numpy(tmax) <= 0].any()
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))
    np.testing.assert_array_equal(occ.numpy(), b_occluded(*_t(p, d, tmax)).numpy())


def test_tmax_none_and_the_unported_tunables(scene_pair):
    """tmax None is T_MAX; each of the four tunables the port once left
    unported (its NotImplementedError is gone) runs: front_levels 0, 2
    and 3, wave_dedup by both routes, slab_bf16, rows_bf16; the exact
    ones keep the untuned winners; an unknown tunable is a TypeError and
    an unknown wave_dedup a ValueError; no rays, no work."""
    _, td = scene_pair
    p, d, tmax = _t(*_rays(10, n=64))
    a = tct.intersect_clusters(td, p, d)
    b = tct.intersect_clusters(td, p, d, torch.full((64,), T_MAX))
    assert torch.equal(a["tri"], b["tri"]) and torch.equal(a["t"], b["t"])
    assert (a["t"][~a["hit"]] == T_MAX).all()
    tct.intersect_clusters(td, p, d, front_levels=2, wave_dedup="off", slab_bf16=False)
    occ = tct.occluded_clusters(td, p, d, tmax)
    for tune in ({"slab_bf16": True}, {"dense_k": 1, "front_levels": 0},
                 {"dense_k": 1, "front_levels": 3}, {"wave_dedup": "gather"},
                 {"wave_dedup": "onehot", "dedup_d": 4}, {"rows_bf16": True}):
        got = tct.intersect_clusters(td, p, d, **tune)
        got_occ = tct.occluded_clusters(td, p, d, tmax, **tune)
        assert got["hit"].any() and got_occ.dtype == torch.bool
        if "rows_bf16" not in tune:
            assert torch.equal(got["tri"], a["tri"]), tune
            assert torch.equal(got_occ, occ), tune
    with pytest.raises(TypeError):
        tct.intersect_clusters(td, p, d, wave_pallas=True)
    with pytest.raises(ValueError, match="wave_dedup"):
        tct.intersect_clusters(td, p, d, wave_dedup="sort")
    with pytest.raises(ValueError, match="wave_dedup"):
        tct.occluded_clusters(td, p, d, tmax, wave_dedup=True)
    empty = tct.intersect_clusters(td, p[:0], d[:0], rows_bf16=True, wave_dedup="gather")
    assert empty["tri"].shape == (0,)


# ---------------------------------------------------------------------------
# make_tracer and the whole slice
# ---------------------------------------------------------------------------

def test_make_tracer_rules(scene_pair):
    _, td = scene_pair
    bare = dataclasses.replace(td, bvh=None)
    p, d, tmax = _t(*_rays(12, n=64))

    def fn(tr):
        return tr.func if isinstance(tr, functools.partial) else tr

    closest, occluded = make_tracer(td, use_bvh=True)
    assert fn(closest) is tct.intersect_clusters and fn(occluded) is tct.occluded_clusters
    # auto: brute without a BVH, with use_bvh=False, or at <= 1024 triangles
    for scene, use in ((bare, True), (td, False)):
        assert fn(make_tracer(scene, use_bvh=use)[0]) is not tct.intersect_clusters
    small = t_attach_bvh(tscenes.cornell_box(8, 8).build(device="cpu"))
    assert fn(make_tracer(small, use_bvh=True)[0]) is not tct.intersect_clusters
    assert fn(make_tracer(small, use_bvh=True, kind="cluster")[0]) is tct.intersect_clusters
    with pytest.raises(ValueError, match="requires an attached BVH"):
        make_tracer(bare, kind="cluster")
    with pytest.raises(ValueError, match="requires an attached BVH"):
        make_tracer(td, use_bvh=False, kind="cluster")
    # the oracle kinds route to the ported tracers, and need a BVH too
    from phosphorus_mk2_tpu_torch.accel import block_traverse, sort, traverse

    closest, occluded = make_tracer(td, kind="per_ray")
    assert fn(closest) is traverse.intersect_bvh and fn(occluded) is traverse.occluded_bvh
    closest, occluded = make_tracer(td, kind="block")
    ref = sort.sorted_trace(block_traverse.intersect_blocks, td, p, d, tmax)
    assert all(torch.equal(closest(p, d, tmax)[k], ref[k]) for k in ref)
    assert torch.equal(occluded(p, d, tmax),
                       sort.sorted_trace(block_traverse.occluded_blocks, td, p, d, tmax))
    for kind in ("block", "per_ray"):
        with pytest.raises(ValueError, match="requires an attached BVH"):
            make_tracer(bare, kind=kind)
        with pytest.raises(ValueError, match="requires an attached BVH"):
            make_tracer(td, use_bvh=False, kind=kind)
    with pytest.raises(ValueError, match="unknown tracer kind"):
        make_tracer(td, kind="octree")
    # tracer_tune, and its shadow sub-dict for the any-hit trace only
    closest, occluded = make_tracer(
        td, tracer_tune={"dense_k": 1, "front_k": 8, "shadow": {"front_k": 2}})
    assert closest.keywords == {"dense_k": 1, "front_k": 8}
    assert occluded.keywords == {"dense_k": 1, "front_k": 2}
    ref_c, ref_o = make_tracer(td, kind="brute")
    assert torch.equal(closest(p, d)["tri"], ref_c(p, d)["tri"])
    assert torch.equal(occluded(p, d, tmax), ref_o(p, d, tmax))

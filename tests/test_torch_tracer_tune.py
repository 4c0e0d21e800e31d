"""The cluster tracer's four tunables in the port (slab_bf16, front_levels,
wave_dedup / dedup_d, rows_bf16): against the untuned port, the port's
brute-force oracle, the JAX package at the same setting, and down to the
plain wave kernels, on inputs drawn with numpy.

The BVH tables of multi_bsdf_scene are the JAX package's own, carried to
the port with scene_data_from_numpy (bf16 tables through integer views),
so both sides trace the same clusters.

Tolerances, and why:
  * the exact tunables against the untuned port: hit, tri and occlusion
    equal, t within rtol 1e-6 (JAX's tests/test_tracer_tune.py): they
    change which clusters a ray meets and in what order, never the
    float32 Moller-Trumbore of a (ray, triangle) pair;
  * against the port's brute tracer: hit and occlusion equal, t within
    JAX's rtol 1e-5 (tests/test_front_table.py);
  * against the JAX package, one tunable at a time (JAX's compiles are
    the cost): hit, tri and occlusion equal, t within rtol 1e-6, u and v
    within 1e-5. rows_bf16 too: the same bf16 bits (round to nearest
    even on both sides) and float32 arithmetic on them;
  * dedup_rows against JAX's _dedup_rows, and the plain wave kernels on
    the bf16 table against the same calls on its float32 upcast: bit for
    bit;
  * films: tests/test_torch_cluster_render.py's depth-2 limits (at least
    99% of the pixels within rtol 1e-3, means within 1e-3 relative).
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
from phosphorus_mk2_tpu.core.options import Options as JOptions
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData
from phosphorus_mk2_tpu.renderer import Renderer as JRenderer
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.accel import cluster_traverse as tct
from phosphorus_mk2_tpu_torch.accel import wave
from phosphorus_mk2_tpu_torch.accel.bvh_builder import attach_bvh as t_attach_bvh
from phosphorus_mk2_tpu_torch.accel.intersect import T_MAX, intersect_brute, occluded_brute
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy
from phosphorus_mk2_tpu_torch.core.options import Options
from phosphorus_mk2_tpu_torch.renderer import Renderer

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

N = 400
TMAX_SHADOW = 1.3  # the any-hit limit of JAX's tests/test_tracer_tune.py rig

# tests/test_tracer_tune.py:24-49, every entry
TUNES = [
    {"dense_waves": 2},
    {"dense_waves": 4, "chunk": 1024},
    {"dense_chunk": 2048},
    {"slab_bf16": True},
    {"dense_waves": 2, "expand_batch": 16, "slab_bf16": True},
    {"recompact": 4},
    {"recompact": 1, "chunk": 256},
    {"recompact": 8, "dense_waves": 2},
    {"dense_k": 1},
    {"dense_k": 1, "recompact": 4},
    {"wave_dedup": "gather"},
    {"wave_dedup": "gather", "chunk": 300, "recompact": 4},
    {"wave_dedup": "onehot"},
    {"wave_dedup": "onehot", "dedup_d": 2},
    {"wave_dedup": "onehot", "dedup_d": 64, "chunk": 128, "recompact": 4},
    {"dense_k": 1, "wave_dedup": "gather"},
    {"dense_k": 1, "wave_dedup": "onehot", "dedup_d": 16},
]
# tests/test_front_table.py:49-58, each on the hierarchical path (JAX
# sets DENSE_K to 1 there; the port takes dense_k=1)
FRONT_TUNES = [
    {"dense_k": 1, **t} for t in (
        {"front_levels": 3},
        {"front_levels": 3, "sc_topk": "sort"},
        {"sc_topk": "extract"},
        {"sc_topk": "sort"},
        {"sc_topk": "pallas"},
        {"front_levels": 3, "front_k": 16},
        {"front_k": 16},
    )
]
# and the port's own: slab_bf16 on both hierarchical levels, with the
# member expansion after the fused slab + extraction, and every one
# together
OWN_TUNES = [
    {"dense_k": 1, "front_levels": 3, "slab_bf16": True},
    {"dense_k": 1, "sc_topk": "pallas", "slab_bf16": True},
    {"dense_k": 1, "front_levels": 3, "slab_bf16": True, "wave_dedup": "gather",
     "recompact": 4, "dense_waves": 2},
]


def _id(tune):
    return "+".join(f"{k}={v}" for k, v in tune.items())


def _carry(jd):
    arrays = {
        f.name: np.asarray(getattr(jd, f.name))
        for f in dataclasses.fields(JSceneData)
        if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"
    }
    arrays["bvh"] = {k: np.asarray(v) for k, v in jd.bvh.items()}
    static = {k: getattr(jd, k) for k in JSceneData.STATIC_FIELDS}
    return scene_data_from_numpy(arrays, static, device="cpu")


def _rays(seed, n=N):
    rs = np.random.RandomState(seed)
    p = rs.uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p, d


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.fixture(scope="module")
def rig():
    """multi_bsdf_scene with the JAX package's BVH on both sides, rays, the
    untuned port's closest hits and occlusion, and the brute oracle's."""
    jd = j_attach_bvh(jscenes.multi_bsdf_scene(8, 8).build(), cluster_mode="treelet")
    td = _carry(jd)
    p, d = _t(*_rays(9))
    tmax = torch.full((N,), TMAX_SHADOW)
    base = tct.intersect_clusters(td, p, d)
    base_occ = tct.occluded_clusters(td, p, d, tmax)
    brute = intersect_brute(td, p, d)
    brute_occ = occluded_brute(td, p, d, tmax)
    assert base["hit"].any() and not base["hit"].all() and base_occ.any()
    return jd, td, p, d, tmax, base, base_occ, brute, brute_occ


# ---------------------------------------------------------------------------
# the port against the untuned port and the brute oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tune", TUNES + FRONT_TUNES + OWN_TUNES, ids=_id)
def test_tune_matches_untuned_and_brute(rig, tune):
    _, td, p, d, tmax, base, base_occ, brute, brute_occ = rig
    got = tct.intersect_clusters(td, p, d, **tune)
    assert torch.equal(got["hit"], base["hit"])
    assert torch.equal(got["tri"], base["tri"])
    hit = base["hit"].numpy()
    np.testing.assert_allclose(got["t"].numpy()[hit], base["t"].numpy()[hit], rtol=1e-6)
    occ = tct.occluded_clusters(td, p, d, tmax, **tune)
    assert torch.equal(occ, base_occ)
    assert torch.equal(got["hit"], brute["hit"])
    np.testing.assert_allclose(got["t"].numpy()[hit], brute["t"].numpy()[hit], rtol=1e-5)
    assert torch.equal(occ, brute_occ)


def test_front_levels_on_nested_terrain():
    """A scene with real super-superclusters (terrain grid 96, the nested
    cluster layout: K3 2), rays from above the terrain aimed into it as
    JAX's tests/test_front_table.py:61 draws them: the three-level front
    table, with and without the bf16 bounds, gives the two-level table's
    winners and the brute oracle's hits and t."""
    td = t_attach_bvh(tscenes.terrain_scene(grid=96, width=16, height=16).build(device="cpu"),
                      cluster_mode="treelet_nested")
    assert td.bvh["ssc_bmin"].shape[0] > 1 and td.bvh["ssc_member_bmin"].shape[1] == 16
    n = 200
    rs = np.random.RandomState(5)
    p = np.tile(np.array([[0.0, 1.2, 4.5]], np.float32), (n, 1))
    tgt = (rs.uniform(-2, 2, size=(n, 3)) * np.array([1.0, 0.3, 1.0])).astype(np.float32)
    d = tgt - p
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, d = _t(p, d)
    ref = intersect_brute(td, p, d)
    two = tct.intersect_clusters(td, p, d, dense_k=1, front_levels=2)
    assert ref["hit"].any()
    hit = ref["hit"].numpy()
    for tune in ({"front_levels": 3}, {"front_levels": 3, "slab_bf16": True},
                 {"front_levels": 3, "sc_topk": "sort", "wave_dedup": "onehot"}):
        got = tct.intersect_clusters(td, p, d, dense_k=1, **tune)
        assert torch.equal(got["hit"], ref["hit"]), tune
        assert torch.equal(got["tri"], two["tri"]), tune
        np.testing.assert_allclose(got["t"].numpy()[hit], ref["t"].numpy()[hit], rtol=1e-5)
    # the three-level table itself: every entry a cluster the ray's slab
    # meets, front to back, and its horizon no farther than the two-level's
    tl = torch.full((n,), T_MAX)
    t3, c3, h3 = tct._front_table_hierarchical(p, d, td.bvh, tl, 32, levels=3)
    t2, _, h2 = tct._front_table_hierarchical(p, d, td.bvh, tl, 32, levels=2,
                                              sc_topk="extract")
    assert bool((t3[:, 1:] >= t3[:, :-1]).all()) and bool((h3 <= T_MAX).all())
    live = t3 < T_MAX
    assert live.any() and bool((c3[live] < td.bvh["cluster_bmin"].shape[0]).all())


# ---------------------------------------------------------------------------
# the port against the JAX package, once per tunable
# ---------------------------------------------------------------------------

AGAINST_JAX = {
    "front_levels_3": {"dense_k": 1, "front_levels": 3},
    "slab_bf16_extract": {"dense_k": 1, "slab_bf16": True, "sc_topk": "extract"},
    "wave_dedup_onehot_overflow": {"wave_dedup": "onehot", "dedup_d": 2},
    "rows_bf16": {"rows_bf16": True},
}


@pytest.mark.parametrize("name", sorted(AGAINST_JAX))
def test_tunable_matches_jax(rig, name):
    jd, td, p, d, _, _, _, _, _ = rig
    tune = AGAINST_JAX[name]
    rs = np.random.RandomState(71)
    tmax = rs.uniform(0.0, 3.0, size=N).astype(np.float32)
    tmax[::7] = 0.0
    tmax[3::7] = 1e-6  # the integrator's dead lanes
    closest_tmax = np.where(tmax > 0.5, np.float32(T_MAX), tmax)
    ref, occ_ref = jax.jit(lambda p, d, tc, t: (jct.intersect_clusters(jd, p, d, tc, **tune),
                                                jct.occluded_clusters(jd, p, d, t, **tune)))(
        jnp.asarray(p.numpy()), jnp.asarray(d.numpy()), jnp.asarray(closest_tmax),
        jnp.asarray(tmax))
    got = tct.intersect_clusters(td, p, d, torch.from_numpy(closest_tmax), **tune)
    occ = tct.occluded_clusters(td, p, d, torch.from_numpy(tmax), **tune)
    hit = np.asarray(ref["hit"])
    assert hit.any() and not hit.all() and np.asarray(occ_ref).any()
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(ref["tri"]))
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(ref["t"])[hit], rtol=1e-6)
    np.testing.assert_allclose(got["u"].numpy()[hit], np.asarray(ref["u"])[hit], atol=1e-5)
    np.testing.assert_allclose(got["v"].numpy()[hit], np.asarray(ref["v"])[hit], atol=1e-5)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_rows_bf16_near_exact_on_jax_case(rig):
    """JAX's tests/test_front_table.py:118 (test_rows_bf16_near_exact) in
    the port: multi_bsdf_scene, the hierarchical front table, JAX's own
    2,000 rays (jax.random key 11), rows_bf16 against the exact trace,
    held to that test's bounds. The bounds describe the tunable on these
    rays, not the port (whose rows_bf16 trace is JAX's, above): on 2,000
    rays drawn with numpy the same-triangle share reads 0.975."""
    _, td, *_ = rig
    key = jax.random.key(11)
    p = jax.random.uniform(key, (2000, 3), minval=-0.9, maxval=0.9)
    d = jax.random.normal(jax.random.fold_in(key, 1), (2000, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    p, d = _t(np.asarray(p), np.asarray(d))
    ref = tct.intersect_clusters(td, p, d, dense_k=1)
    got = tct.intersect_clusters(td, p, d, dense_k=1, rows_bf16=True)
    agree = got["hit"] == ref["hit"]
    assert agree.float().mean() > 0.99
    both = agree & ref["hit"]
    same = got["tri"][both] == ref["tri"][both]
    assert same.float().mean() > 0.98
    t_g, t_r = got["t"][both][same], ref["t"][both][same]
    rel = (t_g - t_r).abs() / t_r.abs().clamp(min=1e-6)
    assert (rel < 2e-2).float().mean() > 0.97
    assert rel.median() < 1e-3
    tmax = torch.full((2000,), TMAX_SHADOW)
    occ_r = tct.occluded_clusters(td, p, d, tmax)
    occ_g = tct.occluded_clusters(td, p, d, tmax, rows_bf16=True)
    assert (occ_r == occ_g).float().mean() > 0.99


# ---------------------------------------------------------------------------
# dedup_rows against JAX's _dedup_rows
# ---------------------------------------------------------------------------

DEDUP_CASES = {
    # route, rays (300: a slot mask that is not a power of two), distinct
    # ids drawn from, d_max, table type
    "gather": ("gather", 300, 40, 512, "f32"),
    "gather_bf16": ("gather", 300, 40, 512, "bf16"),
    "onehot": ("onehot", 300, 40, 512, "f32"),
    "onehot_small_buffer": ("onehot", 300, 40, 64, "f32"),
    "onehot_overflow": ("onehot", 300, 40, 2, "f32"),
    "one_ray": ("gather", 1, 1, 512, "f32"),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedup_rows_matches_jax(rig, case):
    jd, td, *_ = rig
    route, ch, ids, d_max, kind = DEDUP_CASES[case]
    rs = np.random.RandomState(ch + ids + d_max)
    table = td.bvh["cluster_rows_bf16" if kind == "bf16" else "cluster_rows"]
    k = table.shape[0]
    c1 = rs.choice(k, size=ids, replace=False)[rs.randint(0, ids, size=ch)].astype(np.int32)
    live1 = rs.rand(ch) < 0.7  # dead lanes
    live1[0] = True
    c1[5::11] = k + 5  # a dead lane may carry any id
    live1[5::11] = False
    assert tct._dedup_rows is wave.dedup_rows
    got = wave.dedup_rows(table, torch.from_numpy(c1), torch.from_numpy(live1), route, d_max)
    jrows = jct._cluster_rows(jd, bf16=kind == "bf16")
    ref = np.asarray(jct._dedup_rows(jrows, jnp.asarray(c1), jnp.asarray(live1), route, d_max))
    assert got.dtype == table.dtype and got.shape == (ch, 9, table.shape[2])
    view = (torch.int16, np.int16) if kind == "bf16" else (torch.int32, np.int32)
    np.testing.assert_array_equal(got.view(view[0]).numpy(), ref.view(view[1]))
    # the live lanes get their own cluster's row (a -0.0 may come out of
    # the one-hot product as +0.0: compare as floats there)
    live = torch.from_numpy(live1)
    want = table[torch.from_numpy(c1)[live].long()]
    assert torch.equal(got[live].float(), want.float())
    if case == "onehot_overflow":
        assert len(np.unique(c1[live1])) > d_max  # the direct gather ran


# ---------------------------------------------------------------------------
# the plain wave kernels on bf16 rows, and the ray order
# ---------------------------------------------------------------------------

def _states(n, tlim, held=()):
    st = [tlim.clone(), torch.full((n,), -1, dtype=torch.int32), torch.zeros((n,), dtype=torch.int32)]
    for i in held:  # rays that already hold a hit (any-hit)
        st[1][i] = 3
    return st


def _same(a, b):
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]))


def test_plain_waves_on_bf16_rows_and_order(rig):
    """wave_mt_plain and wave_sweep_plain on the bf16 table equal the same
    calls on its float32 upcast, bit for bit, in the uncut walk and in the
    kernels' decompositions (gate=, plan=); wave_mt_plain over
    dedup_order's rays equals it without an order."""
    _, td, p, d, *_ = rig
    bf = td.bvh["cluster_rows_bf16"]
    up = bf.float()
    assert not torch.equal(up, td.bvh["cluster_rows"])  # the rows are quantized
    k = bf.shape[0]
    n = p.shape[0]
    tlim = torch.full((n,), T_MAX)
    ttbl, ctbl, _ = tct._front_table_dense(p, d, td.bvh, tlim, min(tct.MAX_FRONT, k))
    for any_hit in (False, True):
        held = range(1, n, 4) if any_hit else ()
        for lo, hi in ((0, 1), (0, 4), (2, 3)):
            col_t, col_c = ttbl[:, lo:hi], ctbl[:, lo:hi]
            runs = {}
            for label, table, kw in (("f32 upcast", up, {}), ("bf16", bf, {}),
                                     *((f"bf16 gate {g}", bf, {"gate": g}) for g in wave.GATES)):
                st = _states(n, tlim, held)
                wave.wave_mt_plain(p, d, table, col_t, col_c, any_hit, *st, **kw)
                runs[label] = st
            assert (runs["f32 upcast"][1] >= 0).any()
            for label, st in runs.items():
                assert _same(st, runs["f32 upcast"]), (label, lo, hi, any_hit)
            # the ray order of wave_dedup on the card: sorted by cluster,
            # the dead rays last
            live = wave.live_columns(col_t[:, 0], tlim, _states(n, tlim, held)[1], any_hit)
            order = wave.dedup_order(col_c[:, 0], live)
            assert torch.equal(torch.sort(order).values, torch.arange(n, dtype=torch.int32))
            key = torch.where(live, col_c[:, 0].long(), wave.DEAD_CLUSTER)[order.long()]
            assert bool((key[1:] >= key[:-1]).all())
            for table in (up, bf):
                want = _states(n, tlim, held)
                wave.wave_mt_plain(p, d, table, col_t, col_c, any_hit, *want)
                for g in (None, 8, 32):
                    st = _states(n, tlim, held)
                    wave.wave_mt_plain(p, d, table, col_t, col_c, any_hit, *st, gate=g,
                                       order=order)
                    assert _same(st, want), (g, lo, hi, any_hit)
                # a wave meets only the rays of its order
                part = _states(n, tlim, held)
                wave.wave_mt_plain(p, d, table, col_t, col_c, any_hit, *part,
                                   order=order[: n // 2])
                met = torch.zeros(n, dtype=torch.bool)
                met[order[: n // 2].long()] = True
                assert torch.equal(part[1][~met], _states(n, tlim, held)[1][~met])
                assert torch.equal(part[1][met], want[1][met])
            # fewer rows fetched in cluster order: each warp's rays share
            g = 32
            unordered = wave.wave_groups(col_t, col_c, tlim, _states(n, tlim, held)[1],
                                         any_hit, k, g)
            ordered = wave.wave_groups(col_t, col_c, tlim, _states(n, tlim, held)[1],
                                       any_hit, k, g, order=order)
            if hi - lo == 1:
                distinct = int(torch.unique(col_c[:, 0][live]).numel())
                assert distinct <= ordered <= distinct + -(-n // g) - 1 <= unordered + -(-n // g)
    # the exact fallback on the bf16 rows: every cluster for 90 rays, best
    # t mixed
    idx = torch.from_numpy(np.random.RandomState(3).permutation(n)[:90].astype(np.int32))
    start = torch.where(torch.arange(n) % 3 == 0, 0.3, T_MAX)
    want = _states(n, start)
    wave.wave_sweep_plain(p, d, up, idx, *want)
    assert (want[1] >= 0).any()
    for kw in ({}, {"fb_cc": 5}, {"plan": wave.sweep_plan(90, k, 132, 4)},
               {"plan": wave.sweep_plan(8, k, 2, 1)}):
        st = _states(n, start)
        wave.wave_sweep_plain(p, d, bf, idx, *st, **kw)
        assert _same(st, want), kw
    # the wrappers take a bf16 table on the CPU through the plain versions
    st = _states(n, start)
    wave.wave_sweep(p, d, bf, idx, *st)
    assert _same(st, want)
    with pytest.raises(ValueError, match="float32"):
        wave.row_gather(idx, bf)
    with pytest.raises(ValueError):
        wave.wave_mt(p, d, bf.half(), ttbl[:, :1], ctbl[:, :1], False, *_states(n, tlim))
    with pytest.raises(ValueError, match="order"):
        wave.wave_mt(p, d, bf, ttbl[:, :1], ctbl[:, :1], False, *_states(n, tlim),
                     order=order.long())


# ---------------------------------------------------------------------------
# whole films
# ---------------------------------------------------------------------------

W = H = 16
FILMS = {
    # tracer_tune, path depth (spp 2)
    "exact_tunables": ({"dense_k": 1, "front_levels": 3, "slab_bf16": True,
                        "wave_dedup": "gather"}, 1),
    "rows_bf16_shadow": ({"shadow": {"rows_bf16": True}}, 2),
    "rows_bf16": ({"rows_bf16": True}, 2),
}
# rows_bf16 in the closest-hit trace: the share of the pixels that must
# agree. Quantized geometry makes a winner depend on the last bit of the
# ray: neighbouring bf16 triangles overlap by a rounding, and a one-ulp
# change of direction flips the triangle of some rays (with float32
# rows: of none; checked below), while the two packages' camera
# directions differ in the last bit on most rays (XLA against ATen), so
# a few pixels take another triangle in each package.
ROWS_BF16_PIXELS = 0.95


def _film(mod_scenes, renderer, options, kw):
    return renderer(mod_scenes.multi_bsdf_scene(W, H), options(**kw), **(
        {"n_devices": 1} if renderer is JRenderer else {"device": "cpu"})).render()


@pytest.mark.parametrize("case", sorted(FILMS))
def test_renderer_film_matches_jax_renderer(rig, case):
    """multi_bsdf_scene 16x16, 2 spp, through each package's Renderer
    with the same tracer_tune: the exact tunables at depth 1 per pixel
    (tests/test_torch_cluster_render.py's depth-1 limits); rows_bf16 in
    the shadow trace alone (its margins) at depth 2 with the depth-2
    limits; rows_bf16 everywhere at depth 2 on ROWS_BF16_PIXELS of the
    pixels (see there), and the winner's one-ulp sensitivity that costs
    the rest, in the port."""
    tune, depth = FILMS[case]
    kw = dict(samples_per_pixel=2, samples_per_pass=2, path_depth=depth, seed=3, use_bvh=True,
              tracer_tune=tune)
    ref = {k: np.asarray(v) for k, v in _film(jscenes, JRenderer, JOptions, kw).items()}
    got = _film(tscenes, Renderer, Options, kw)
    r, g = ref["color"], got["color"]
    assert g.shape == (H, W, 3) and np.isfinite(g).all() and r.max() > 0 and g.max() > 0
    per_pixel = np.isclose(g, r, rtol=1e-3, atol=1e-6).all(axis=-1)
    if depth == 1:
        for k in ("color", "alpha"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got["normal"], ref["normal"], rtol=0, atol=1e-5)
    elif case == "rows_bf16_shadow":
        assert per_pixel.mean() >= 0.99, per_pixel.mean()
        np.testing.assert_allclose(g.mean(), r.mean(), rtol=1e-3)
        np.testing.assert_allclose(g.mean(axis=(0, 1)), r.mean(axis=(0, 1)), rtol=1e-3)
    else:
        assert per_pixel.mean() >= ROWS_BF16_PIXELS, per_pixel.mean()
        _, td, p, d, *_ = rig
        pu = torch.nextafter(p, torch.full_like(p, 10.0))
        du = torch.nextafter(d, torch.full_like(d, 10.0))
        flips = {}
        for bf16 in (False, True):
            a = tct.intersect_clusters(td, p, d, rows_bf16=bf16)
            b = tct.intersect_clusters(td, pu, du, rows_bf16=bf16)
            flips[bf16] = int((a["tri"] != b["tri"]).sum())
        assert flips[False] == 0 and flips[True] > 0, flips

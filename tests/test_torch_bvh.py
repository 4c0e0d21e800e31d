"""The port's BVH builders and cluster tables against the JAX package's.

Everything here is host-side numpy on both sides, so every array must be
equal, not close, NaN positions included (empty slots keep NaN bounds,
which the slab tests rely on). The bf16 tables (the outward-rounded
bounds and the bf16 cluster rows) are compared bit for bit through their
16-bit integer views: a JAX bf16 array reaches numpy as ml_dtypes'
bfloat16, which torch cannot take.

The native (C++) and the numpy builder do NOT build the same tree (they
break SAH ties differently), in either package; what is held is that the
port's native builder returns exactly what the JAX package's returns
(same source, same flags, same host) and that its tree is complete.
"""
import dataclasses
import logging

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from phosphorus_mk2_tpu import scenes as jscenes
from phosphorus_mk2_tpu.accel import bvh_builder as jbb
from phosphorus_mk2_tpu.accel import cluster_traverse as jct
from phosphorus_mk2_tpu.accel import native_bvh as jnative
from phosphorus_mk2_tpu.core.scene import SceneData as JSceneData
from phosphorus_mk2_tpu_torch import scenes as tscenes
from phosphorus_mk2_tpu_torch.accel import bvh_builder as tbb
from phosphorus_mk2_tpu_torch.accel import native_bvh as tnative
from phosphorus_mk2_tpu_torch.accel.build import BUILD_DIR
from phosphorus_mk2_tpu_torch.convert import scene_data_from_numpy

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)

SCENES = {
    "multi_bsdf_scene": lambda mod: mod.multi_bsdf_scene(8, 8),
    "terrain48": lambda mod: mod.terrain_scene(grid=48, width=8, height=8),
}
# tables the port adds to JAX's attach_bvh: the rows a wave gathers (JAX
# stacks them from cluster_a/e0/e1 in every trace)
ROWS = {"cluster_rows", "cluster_rows_bf16"}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    """(JAX SceneData, port SceneData on the CPU, numpy-builder tree)."""
    jd = SCENES[request.param](jscenes).build()
    td = SCENES[request.param](tscenes).build(device="cpu")
    tree = jbb.build_bvh(np.asarray(jd.vertices), np.asarray(jd.faces))
    return jd, td, tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; a bf16 one as its 16-bit integer view."""
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ref_numpy(v) -> np.ndarray:
    """A JAX array as numpy; a bf16 one as its 16-bit integer view."""
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype.name == "bfloat16" else v


def _assert_tables_equal(got: dict, ref: dict):
    ref = {k: _ref_numpy(v) for k, v in ref.items()}
    extra = set(got) - set(ref) - ROWS
    assert not extra and set(ref) <= set(got), (sorted(got), sorted(ref))
    assert {k for k in ref if k.endswith("_bf16")} == {k + "_bf16" for k in tbb.BOUNDS_TABLES}
    for name, r in ref.items():
        g = _numpy(got[name])
        assert g.dtype == r.dtype and g.shape == r.shape, (name, g.dtype, r.dtype, g.shape, r.shape)
        np.testing.assert_array_equal(g, r, err_msg=name)  # NaN == NaN here


def test_terrain_scene_matches_jax():
    jd = jscenes.terrain_scene(grid=48, width=8, height=8).build()
    td = tscenes.terrain_scene(grid=48, width=8, height=8).build(device="cpu")
    assert td.num_tris == 2 * 48 * 48 + 3 * (2 * 24 * 48 - 2 * 48)
    for f in dataclasses.fields(JSceneData):
        if f.name in JSceneData.STATIC_FIELDS or f.name == "bvh":
            continue
        np.testing.assert_array_equal(getattr(td, f.name).numpy(),
                                      np.asarray(getattr(jd, f.name)), err_msg=f.name)
    for k in JSceneData.STATIC_FIELDS:
        assert getattr(td, k) == getattr(jd, k), k


def test_build_bvh_matches_jax(pair):
    jd, td, tree = pair
    got = tbb.build_bvh(td.vertices.numpy(), td.faces.numpy())
    assert set(got) == set(tree)
    for k in tree:
        assert got[k].dtype == tree[k].dtype, k
        np.testing.assert_array_equal(got[k], tree[k], err_msg=k)


@pytest.mark.parametrize("mode", ["treelet", "treelet_nested", "flat"])
def test_attach_bvh_tables_match_jax(pair, mode):
    jd, td, tree = pair
    jref = jbb.attach_bvh(jd, tree, cluster_mode=mode)
    ref = jref.bvh
    got = tbb.attach_bvh(td, tree, cluster_mode=mode).bvh
    _assert_tables_equal(got, ref)
    # the bf16 rows: JAX casts its stacked rows in every trace (round to
    # nearest even); the port casts once, at attach time
    assert got["cluster_rows_bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_numpy(got["cluster_rows_bf16"]),
                                  _ref_numpy(jct._cluster_rows(jref, bf16=True)))
    # the padded levels stay NaN in bf16 too: a NaN box never hits
    for name in ("sc_member_bmin", "ssc_member_bmax"):
        assert np.array_equal(torch.isnan(got[name + "_bf16"].float()).numpy(),
                              np.isnan(got[name].numpy())), name
    # empty slots: the supercluster padding is NaN, and NaN stays NaN
    k = got["cluster_bmin"].shape[0]
    if k % tbb.SUPER_CLUSTERS:
        assert torch.isnan(got["sc_member_bmin"][-1, -1]).all()
    assert np.array_equal(np.isnan(got["cluster_bmin"].numpy()),
                          np.isnan(np.asarray(ref["cluster_bmin"])))
    rows = got["cluster_rows"]
    assert rows.shape == (k, 9, got["cluster_a"].shape[1])
    assert torch.equal(rows[:, 3:6].transpose(1, 2), got["cluster_e0"])


def test_python_builder_end_to_end(pair):
    jd, td, tree = pair
    got = tbb.attach_bvh(td, builder="python").bvh
    _assert_tables_equal(got, jbb.attach_bvh(jd, tree).bvh)


def _needs_compiler():
    if tnative.compiler() is None:
        pytest.skip("no host C++ compiler")


def test_native_builder_matches_jax_native(pair):
    _needs_compiler()
    jd, td, _ = pair
    v, f = np.asarray(jd.vertices), np.asarray(jd.faces)
    ref = jnative.build_bvh_native(v, f)
    assert ref is not None
    got = tnative.build_bvh_native(v, f)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _assert_tables_equal(tbb.attach_bvh(td, builder="native").bvh, jbb.attach_bvh(jd, ref).bvh)


def test_native_tree_is_valid_and_complete(pair):
    _needs_compiler()
    _, td, _ = pair
    bvh = tnative.build_bvh_native(td.vertices.numpy(), td.faces.numpy())
    nc, cc = bvh["node_count"], bvh["node_child"]
    leaves = []
    for i, k in zip(*np.nonzero(nc > 0)):
        assert cc[i, k] % tbb.MAX_LEAF == 0  # group alignment
        leaves.extend(bvh["leaf_tris"][cc[i, k] : cc[i, k] + nc[i, k]].tolist())
    assert sorted(leaves) == list(range(td.num_tris))


def test_native_library_is_built_inside_the_build_directory():
    _needs_compiler()
    tnative.build()
    libs = list(BUILD_DIR.glob("libphbvh_*.so"))
    assert libs, "the native builder was not built into build/torch_kernels"
    with pytest.raises(ValueError):
        tnative.build_bvh_native(np.zeros((3, 3), np.float32), np.array([[0, 1, 5]], np.int32))


def test_builder_choice_is_logged_and_never_silent(monkeypatch, caplog):
    td = tscenes.cornell_box(8, 8).build(device="cpu")
    with caplog.at_level(logging.INFO, logger=tbb.__name__):
        tbb.attach_bvh(td, builder="python")
    assert "python builder" in caplog.text and "36 triangles" in caplog.text
    with pytest.raises(ValueError, match="unknown builder"):
        tbb.attach_bvh(td, builder="fastest")
    # no host compiler: a CPU scene takes the numpy builder and says so;
    # asking for the native builder raises instead of giving way
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    monkeypatch.setattr(tnative, "_lib", None)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=tbb.__name__):
        auto = tbb.attach_bvh(td)
    assert "python builder" in caplog.text
    assert auto.bvh["cluster_id"].shape[1] == tbb.CLUSTER_TRIS
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbb.attach_bvh(td, builder="native")


def test_scene_data_from_numpy_carries_the_bvh(pair):
    jd, td, tree = pair
    jb = jbb.attach_bvh(jd, tree)
    arrays = {
        f.name: np.asarray(getattr(jb, f.name))
        for f in dataclasses.fields(JSceneData)
        if f.name not in JSceneData.STATIC_FIELDS and f.name != "bvh"
    }
    arrays["bvh"] = {k: np.asarray(v) for k, v in jb.bvh.items()}
    static = {k: getattr(jb, k) for k in JSceneData.STATIC_FIELDS}
    assert any(v.dtype.name == "bfloat16" for v in arrays["bvh"].values())
    carried = scene_data_from_numpy(arrays, static, device="cpu")
    assert set(carried.bvh) == set(jb.bvh) | ROWS
    own = tbb.attach_bvh(td, tree).bvh
    for k, v in carried.bvh.items():
        assert v.dtype == own[k].dtype, k
        np.testing.assert_array_equal(_numpy(v), _numpy(own[k]), err_msg=k)
    assert set(carried.to("cpu").bvh) == set(carried.bvh)
    # without the rows in the arrays, the carried rows are made from
    # cluster_a/e0/e1, in both types
    assert "cluster_rows" not in arrays["bvh"]
    assert torch.equal(carried.bvh["cluster_rows_bf16"].view(torch.int16),
                       own["cluster_rows_bf16"].view(torch.int16))


_EDGES = [0.0, -0.0, np.nan, 3.38e38, -3.38e38, 3.3799999e38, -3.3799999e38, 3.39e38,
          -3.39e38, np.inf, -np.inf, 1e-45, -1e-45, 1.0, -1.0]


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True), min_size=1,
                max_size=64),
       st.booleans())
def test_bf16_outward_matches_jax(values, up):
    """The outward bf16 rounding of the bounds tables against the JAX
    package's, bit for bit, on random float32 values and the edges (+-0,
    NaN, the clip at +-3.38e38 and beyond, denormals): every output is
    representable in bf16 (its low 16 bits are zero), lies on the outer
    side of the clipped input, and NaN stays NaN."""
    x = np.array(values + _EDGES, np.float32)
    got = tbb._bf16_outward(x, up=up)
    ref = jbb._bf16_outward(x, up=up)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert not (got.view(np.uint32) & 0xFFFF).any()
    nan = np.isnan(x)
    assert np.array_equal(np.isnan(got), nan)
    clipped = np.clip(x[~nan], -3.38e38, 3.38e38)
    assert ((got[~nan] >= clipped) if up else (got[~nan] <= clipped)).all()
    assert np.isfinite(got[~nan]).all()
    # as a torch bf16 tensor: the same values, exactly
    t = tbb.bf16_from_bits(got, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy().view(np.uint32), got.view(np.uint32))

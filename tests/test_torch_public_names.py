"""Every public name of a JAX module has its counterpart in the port, but
for an allow-list with a reason each; and value tests of the names this
check found missing (make_frame_with_tangent, length,
in_same_hemisphere, stratified_2d, native_bvh.available) against the JAX
package on inputs drawn with numpy.

Tolerances: the vector helpers compute one float32 expression in the
same order on both sides, and are held to rtol 1e-6 (a fused multiply-add
in XLA may round once where PyTorch rounds twice); the hemisphere test
and the strata are exact.
"""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.math import frame as jframe
from phosphorus_mk2_tpu.math import sampling as jsampling
from phosphorus_mk2_tpu.math import vec as jvec
from phosphorus_mk2_tpu_torch.accel import native_bvh
from phosphorus_mk2_tpu_torch.math import frame, sampling, vec

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "phosphorus_mk2_tpu"
PORT_PKG = ROOT / "phosphorus_mk2_tpu_torch"

# JAX modules the port has under another name
NO_COUNTERPART = {
    "accel/pallas_mt.py": "its Pallas kernels are csrc/mt.cu, bound in accel/mt.py",
    "accel/pallas_front.py": "its Pallas kernels are csrc/front.cu, bound in accel/front.py",
}
ONE_DISPATCH = ("the port has one eager lobe dispatch (bsdf/lobes.py, dense), and the tests "
                "hold it against both of JAX's (tests/test_torch_lobe_dispatch.py)")
# public names deliberately absent from the port
ABSENT = {
    ("bsdf/lobes.py", "eval_lobe_sorted"): ONE_DISPATCH,
    ("bsdf/lobes.py", "sample_lobe_sorted"): ONE_DISPATCH,
    ("math/vec.py", "jax_rsqrt"): "lax.rsqrt; torch.rsqrt is its torch form (vec.normalize)",
    ("utils/profiling.py", "RenderMeter"):
        "nominal rays (N x depth x 2, whatever the paths do) that nothing calls; the "
        "port's spans time a pass and its stages (utils/profiling.py span)",
    ("parallel/distributed.py", "wave_spec"):
        "a jax PartitionSpec; torch has none, parallel/sharding.DeviceMesh splits the wavefront",
    ("parallel/distributed.py", "wave_sharding"):
        "a jax NamedSharding; torch has none, parallel/sharding.DeviceMesh splits the wavefront",
    ("parallel/distributed.py", "replicated_sharding"):
        "a jax NamedSharding; torch has none, the scene is copied to each device whole",
}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _public(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def test_every_jax_module_has_a_counterpart():
    missing = [m for m in _jax_modules()
               if not (PORT_PKG / m).exists() and m not in NO_COUNTERPART]
    assert missing == []
    assert all(not (PORT_PKG / m).exists() for m in NO_COUNTERPART)


@pytest.mark.parametrize("module", [m for m in _jax_modules() if m not in NO_COUNTERPART])
def test_public_names_ported(module):
    port = importlib.import_module(
        "phosphorus_mk2_tpu_torch." + module[:-3].replace("/", ".").removesuffix(".__init__"))
    names = _public(JAX_PKG / module)
    missing = [n for n in names if not hasattr(port, n) and (module, n) not in ABSENT]
    assert missing == [], f"{module}: {missing}"
    stale = [n for (m, n) in ABSENT if m == module and (n not in names or hasattr(port, n))]
    assert stale == [], f"{module}: allow-listed but {stale} are ported or gone from JAX"


def _vectors(seed, n=500):
    rs = np.random.RandomState(seed)
    a = rs.normal(size=(n, 3)).astype(np.float32)
    b = rs.normal(size=(n, 3)).astype(np.float32)
    a[::17] = 0.0  # the zero vector
    b[3::17] = -a[3::17]  # opposite
    b[5::17] = a[5::17]
    return a, b


def test_length_matches_jax():
    a, _ = _vectors(0)
    got = vec.length(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvec.length(jnp.asarray(a))), rtol=1e-6)
    assert (got[::17] == 0).all()


def test_in_same_hemisphere_matches_jax():
    a, b = _vectors(1)
    got = vec.in_same_hemisphere(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jvec.in_same_hemisphere(jnp.asarray(a), jnp.asarray(b))))
    assert got.any() and not got.all()


def test_make_frame_with_tangent_matches_jax():
    rs = np.random.RandomState(2)
    n = rs.normal(size=(400, 3)).astype(np.float32)
    t = rs.normal(size=(400, 3)).astype(np.float32)
    t -= (t * n).sum(-1, keepdims=True) * n / (n * n).sum(-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    got = frame.make_frame_with_tangent(torch.from_numpy(t), torch.from_numpy(n))
    ref = jframe.make_frame_with_tangent(jnp.asarray(t), jnp.asarray(n))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert got[2] is not None and torch.equal(got[2], torch.from_numpy(t))
    # an orthonormal frame for an orthogonal unit tangent
    m = torch.stack(got, dim=-1)
    eye = torch.eye(3).expand_as(m)
    assert torch.allclose(m.transpose(-1, -2) @ m, eye, atol=1e-5)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_stratified_2d_layout_and_strata(n):
    u = sampling.stratified_2d(11, n, device="cpu")
    assert u.shape == (n * n, 2) and u.dtype == torch.float32
    cell = torch.floor(u * n).long()
    i, j = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    assert torch.equal(cell, torch.stack([i, j], dim=-1).reshape(-1, 2))
    assert torch.equal(u, sampling.stratified_2d(11, n, device="cpu"))  # a function of the seed
    assert not torch.equal(u, sampling.stratified_2d(12, n, device="cpu"))


def test_stratify_is_jax_formula_on_a_given_jitter():
    """The random bits differ by design (the port's counter-based RNG under
    an integer seed); JAX's formula on JAX's own jitter is bit-equal."""
    key = jax.random.key(3)
    n = 6
    jitter = np.asarray(jax.random.uniform(key, (n * n, 2)))
    ref = np.asarray(jsampling.stratified_2d(key, n))
    got = sampling.stratify(torch.from_numpy(jitter.copy()), n)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stratified_2d_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sampling.stratified_2d(0, 2)


def test_native_bvh_available(monkeypatch):
    assert native_bvh.available() is (native_bvh.compiler() is not None)

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native_bvh, "build", broken)
    assert native_bvh.available() is False

"""The port's gather_rows (math/grad_gather.py) against the JAX
package's, the cases of tests/test_grad_gather.py on the same inputs.

Tolerances, and why:
  * the primal: equal bit for bit to table[idx] (it is table[idx]);
  * gradients: rtol 1e-5, atol 1e-6 of jax.grad of the JAX gather_rows.
    The sums are reassociated (a sort, then segment sums), as they are
    between JAX's scatter-add and segment_sum. With unique indices there
    is no sum, and the gradients are equal exactly; untouched rows get
    exactly 0;
  * two segsum backwards of the same inputs: equal bit for bit (no
    atomics);
  * the port's "float64" backward (no JAX counterpart): within rtol
    1e-6, atol 1e-7 of a float64 scatter-add (one float32 rounding of a
    float64 sum), also where 65,536 indices name a few rows; bit-equal
    twice.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phosphorus_mk2_tpu.math.grad_gather import gather_rows as j_gather_rows
from phosphorus_mk2_tpu_torch.math.grad_gather import gather_rows

# the tier-1 run puts several pytest workers on few cores and the tensors
# here are small: one intra-op thread per worker avoids oversubscription
torch.set_num_threads(1)


def _grad(table, idx, w, transpose):
    t = torch.from_numpy(table).requires_grad_()
    (gather_rows(t, torch.from_numpy(idx), transpose) * torch.from_numpy(w)).sum().backward()
    return t.grad.numpy()


def _jgrad(table, idx, w, transpose):
    return np.asarray(jax.grad(
        lambda t: (j_gather_rows(t, jnp.asarray(idx), transpose) * jnp.asarray(w)).sum()
    )(jnp.asarray(table)))


@pytest.mark.parametrize("transpose", ["segsum", "scatter"])
def test_primal_and_grad_match_jax(transpose):
    rng = np.random.default_rng(3)
    F, W, N = 50, 7, 400
    table = rng.random((F, W)).astype(np.float32)
    idx = rng.integers(0, F - 10, size=(N,)).astype(np.int32)  # the last 10 rows untouched
    w = rng.random((N, W)).astype(np.float32)
    out = gather_rows(torch.from_numpy(table), torch.from_numpy(idx), transpose)
    np.testing.assert_array_equal(out.numpy(), table[idx])
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(j_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                                           transpose)))
    g = _grad(table, idx, w, transpose)
    np.testing.assert_allclose(g, _jgrad(table, idx, w, transpose), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, _jgrad(table, idx, w, "scatter"), rtol=1e-5, atol=1e-6)
    touched = np.zeros(F, bool)
    touched[idx] = True
    assert (g[~touched] == 0).all() and (~touched).any()


def test_unique_indices_exact():
    rng = np.random.default_rng(4)
    F, W = 64, 3
    table = rng.random((F, W)).astype(np.float32)
    idx = rng.permutation(F)[:32].astype(np.int32)
    w = rng.random((32, W)).astype(np.float32)
    g = _grad(table, idx, w, "segsum")
    np.testing.assert_array_equal(g, _jgrad(table, idx, w, "segsum"))
    np.testing.assert_array_equal(g, _grad(table, idx, w, "scatter"))


def test_scatter_mode_passthrough():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.random((10, 4)).astype(np.float32)).requires_grad_()
    idx = torch.tensor([1, 1, 3], dtype=torch.int32)
    gather_rows(table, idx, "scatter").sum().backward()
    assert table.grad[1, 0] == 2.0 and table.grad[3, 0] == 1.0 and table.grad[0, 0] == 0.0
    with pytest.raises(ValueError, match="unknown transpose"):
        gather_rows(table, idx, "sorted")


def test_reuse_across_a_loop_of_steps():
    """The JAX test's scan: one table gathered at three index sets, the
    gradient summed over the steps."""
    rng = np.random.default_rng(6)
    F, W, N = 20, 5, 64
    table = rng.random((F, W)).astype(np.float32)
    idx = rng.integers(0, F, size=(3, N)).astype(np.int32)
    t = torch.from_numpy(table).requires_grad_()
    sum(gather_rows(t, torch.from_numpy(i)).sum() for i in idx).backward()

    @jax.jit
    def loss(tab):
        def body(acc, i):
            return acc + j_gather_rows(tab, i).sum(), None
        out, _ = jax.lax.scan(body, 0.0, jnp.asarray(idx))
        return out

    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jax.grad(loss)(jnp.asarray(table))),
                               rtol=1e-6)


def test_segsum_backward_is_deterministic():
    rng = np.random.default_rng(7)
    F, W, N = 36, 36, 65536  # cornell_box's hit rows: many indices a row
    table = rng.random((F, W)).astype(np.float32)
    idx = rng.integers(0, F, size=(N,)).astype(np.int32)
    w = rng.standard_normal((N, W)).astype(np.float32)
    g1 = _grad(table, idx, w, "segsum")
    g2 = _grad(table, idx, w, "segsum")
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_allclose(g1, _grad(table, idx, w, "scatter"), rtol=1e-4, atol=1e-4)


def test_empty_indices_and_half_cotangents():
    table = torch.ones((5, 2), requires_grad=True)
    gather_rows(table, torch.zeros((0,), dtype=torch.int64)).sum().backward()
    assert torch.equal(table.grad, torch.zeros((5, 2)))
    half = torch.ones((5, 2), dtype=torch.float16, requires_grad=True)
    out = gather_rows(half, torch.tensor([0, 0, 4]))
    out.sum().backward()
    assert half.grad.dtype == torch.float16 and half.grad[0, 0] == 2.0


@pytest.mark.parametrize("n", [0, 1, 255, 256, 1000])
def test_float64_primal_and_grad(n):
    """The port's "float64" backward: the primal table[idx]; the gradient
    a float64 scatter-add's rounded once (rtol 1e-6, atol 1e-7), on a 3-D
    table as the material tables are (JAX's gather_rows takes 2-D tables
    only); float32 out; bit-equal twice; untouched rows exactly 0."""
    rng = np.random.default_rng(8)
    F = 6
    table = rng.random((F, 4, 3)).astype(np.float32)
    idx = rng.integers(0, F - 1, size=(n,)).astype(np.int32)  # the last row untouched
    w = rng.random((n, 4, 3)).astype(np.float32)
    out = gather_rows(torch.from_numpy(table), torch.from_numpy(idx), "float64")
    np.testing.assert_array_equal(out.numpy(), table[idx])
    g = _grad(table, idx, w, "float64")
    assert g.dtype == np.float32
    np.testing.assert_array_equal(g, _grad(table, idx, w, "float64"))
    ref = np.zeros(table.shape)
    np.add.at(ref, idx, w.astype(np.float64))
    np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-7)
    assert (g[F - 1] == 0).all()


def test_float64_sums_skewed_indices_accurately():
    """65,536 indices into 3 rows, six in seven on row 0 (a wavefront's
    material ids on a scene of one surface): within 1e-7 of a float64 sum
    of the same contributions, relative to the row's value, where the
    float32 segment sum is off by more than 1e-5."""
    rng = np.random.default_rng(9)
    n = 65536
    idx = np.where(np.arange(n) % 7 == 0, 1, 0).astype(np.int64)
    w = (1.0 + 0.01 * rng.random((n, 5))).astype(np.float32)
    ref = np.zeros((3, 5))
    np.add.at(ref, idx, w.astype(np.float64))
    g = _grad(np.ones((3, 5), np.float32), idx, w, "float64")
    assert np.abs(g - ref).max() <= 1e-7 * np.abs(ref).max()
    assert (g[2] == 0).all()
    seg = _grad(np.ones((3, 5), np.float32), idx, w, "segsum")
    assert np.abs(seg - ref).max() > 1e-5 * np.abs(ref).max()


def test_float64_half_table():
    """A float16 table's gradient comes back float16: the float64 sum
    rounded once to the cotangent's dtype."""
    half = torch.zeros((5, 2), dtype=torch.float16, requires_grad=True)
    gather_rows(half, torch.tensor([0, 0, 4]), "float64").sum().backward()
    assert half.grad.dtype == torch.float16
    np.testing.assert_array_equal(half.grad.numpy()[:, 0], [2, 0, 0, 0, 1])

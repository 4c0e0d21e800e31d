"""The port's threefry keys (math/rng.py ``key_data``, ``split``,
``key_seed``) against jax.random on the installed jax (threefry2x32, the
default key type; ``jax_threefry_partitionable`` on, jax's default since
0.5). Bit for bit: the same integer arithmetic."""
import jax
import numpy as np
import pytest

from phosphorus_mk2_tpu_torch.math import rng

SEEDS = [0, 1, 5, -1, 123456789, 2**31, 2**32 - 1]


def _words(key):
    return np.asarray(jax.random.key_data(key))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_matches_jax(seed):
    np.testing.assert_array_equal(rng.key_data(seed), _words(jax.random.key(seed)))
    assert rng.key_seed(rng.key_data(seed)) == rng.seed_word(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chains_match_jax(seed):
    """InverseRenderer's chain: key, sub = split(key) each step, and the
    unbiased loss's k1, k2 = split(sub)."""
    assert jax.config.jax_threefry_partitionable
    jk, pk = jax.random.key(seed), rng.key_data(seed)
    for _ in range(6):
        jk, jsub = jax.random.split(jk)
        pk, psub = rng.split(pk)
        np.testing.assert_array_equal(pk, _words(jk))
        np.testing.assert_array_equal(psub, _words(jsub))
        j1, j2 = jax.random.split(jsub)
        p1, p2 = rng.split(psub)
        np.testing.assert_array_equal(np.stack([p1, p2]), np.stack([_words(j1), _words(j2)]))
        assert rng.key_seed(p2) == int(_words(j2)[-1])


@pytest.mark.parametrize("num", [1, 3, 8])
def test_split_num_matches_jax(num):
    key = rng.split(rng.key_data(11))[1]
    ref = jax.random.split(jax.random.wrap_key_data(key), num)
    np.testing.assert_array_equal(rng.split(key, num), _words(ref))


def test_threefry_hash_matches_jax():
    from jax._src import prng

    g = np.random.default_rng(3)
    key = g.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x0, x1 = (g.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32) for _ in range(2))
    ref = prng.threefry2x32_p.bind(*map(jax.numpy.asarray, (key[0], key[1], x0, x1)))
    got = rng.threefry2x32(key, x0, x1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))

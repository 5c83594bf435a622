"""The port's threefry PRNG is bit-exact to ``jax.random`` at every call the
engine makes: ``PRNGKey`` of a normalised seed, ``split``, ``fold_in`` per
worker, float32 ``uniform`` of shape (S,)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.engine import normalize_seed as ref_normalize_seed
from repro.core.engine import prng_key
from repro_torch.core import prng

SEEDS = (0, 7, -1, 2 ** 33 + 5)


def words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    assert prng.normalize_seed(seed) == int(ref_normalize_seed(seed))
    kj = prng_key(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(words(kj), kt.numpy())
    a, b = jax.random.split(kj)
    st = prng.split(kt)
    np.testing.assert_array_equal(words(a), st[0].numpy())
    np.testing.assert_array_equal(words(b), st[1].numpy())
    np.testing.assert_array_equal(words(jax.random.split(kj, 5)),
                                  prng.split(kt, 5).numpy())


@pytest.mark.parametrize("s", (1, 8, 128))
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_uniform(seed, s):
    _, sub = jax.random.split(prng_key(seed))
    sub_t = prng.split(prng.PRNGKey(seed))[1]
    for w in range(4):
        kj = jax.random.fold_in(sub, w)
        kt = prng.fold_in(sub_t, w)
        np.testing.assert_array_equal(words(kj), kt.numpy())
        uj = np.asarray(jax.random.uniform(kj, (s,)))
        ut = prng.uniform(kt, (s,)).numpy()
        assert ut.dtype == np.float32
        np.testing.assert_array_equal(uj.view(np.uint32), ut.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_draws_match_per_worker_draws(seed):
    """The fused tick draws all W workers in one batched call; it must give
    the per-worker stream bit for bit."""
    sub = prng.split(prng.PRNGKey(seed))[1]
    batched = prng.uniform(prng.fold_in(sub, torch.arange(4)), (8,))
    for w in range(4):
        one = prng.uniform(prng.fold_in(sub, w), (8,))
        assert torch.equal(batched[w], one)


def test_key_trajectory_over_ticks():
    """200 ticks of ``key, sub = split(key)`` stay on the reference's track."""
    kj, kt = prng_key(3), prng.PRNGKey(3)
    for _ in range(200):
        kj, _ = jax.random.split(kj)
        kt = prng.split(kt)[0]
    np.testing.assert_array_equal(words(kj), kt.numpy())

"""The port's threefry PRNG is bit-exact to ``jax.random`` at every call the
engine makes: ``PRNGKey`` of a normalised seed, ``split``, ``fold_in`` per
worker, float32 ``uniform`` of shape (S,)."""
import math

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


def test_split_takes_a_batch_of_keys():
    keys = torch.stack([prng.PRNGKey(s) for s in SEEDS])
    got = prng.split(keys, 3)
    for i, s in enumerate(SEEDS):
        assert torch.equal(got[i], prng.split(prng.PRNGKey(s), 3))


#: Rates on both sides of the Knuth/PTRS switch at 10, 0, and the 1e5 PTRS
#: draws in the Knuth lanes.
POISSON_RATES = (0.0, 0.05, 0.7, 3.0, 9.9, 10.0, 10.5, 37.0, 400.0, 2e4, 1e5)
#: Below this rate every lane must equal jax's; at and above it, where
#: PTRS's acceptance test cancels large terms, a lane may be decided by an
#: ulp of XLA's log against the port's (see ``prng.py``): counted, named,
#: and held under 0.5 % of those lanes.
POISSON_EXACT_BELOW = 400.0


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_matches_jax(seed):
    """``prng.poisson`` against ``jax.random.poisson`` over 2000 lanes per
    rate; mismatches are counted and named."""
    lam = np.repeat(np.asarray(POISSON_RATES, np.float32)[:, None], 2000, 1)
    want = np.asarray(jax.random.poisson(prng_key(seed), lam))
    knuth = (lam > 0) & (lam < 10)
    got, unfinished = prng.poisson(
        prng.PRNGKey(seed), torch.from_numpy(lam),
        knuth_iters=prng.poisson_iters(float(lam[knuth].max()), knuth.sum()),
        rejection_iters=prng.rejection_iters(lam.size))
    assert not bool(unfinished)
    assert got.dtype == torch.int32
    bad = np.argwhere(got.numpy() != want)
    for r, c in bad:
        print(f"seed {seed}: λ={lam[r, c]} lane {c}: port {int(got[r, c])}, "
              f"jax {want[r, c]}")
    print(f"seed {seed}: {len(bad)} of {lam.size} lanes differ")
    assert all(lam[r, c] >= POISSON_EXACT_BELOW for r, c in bad)
    assert len(bad) <= 0.005 * (lam >= POISSON_EXACT_BELOW).sum()
    assert (got.numpy()[0] == 0).all()
    means = got.numpy().mean(axis=1)
    np.testing.assert_allclose(means[1:], lam[1:, 0], rtol=0.12)


def test_poisson_batched_keys_equal_single_keys():
    keys = torch.stack([prng.PRNGKey(s) for s in (1, 2)])
    lam = torch.tensor([[0.5, 12.0, 0.0, 3.0]] * 2)
    got, _ = prng.poisson(keys, lam, knuth_iters=20, rejection_iters=30)
    for i, s in enumerate((1, 2)):
        one, _ = prng.poisson(prng.PRNGKey(s), lam[i], knuth_iters=20,
                              rejection_iters=30)
        assert torch.equal(got[i], one)


def test_poisson_reports_too_few_iterations():
    lam = torch.full((64,), 9.0)
    _, unfinished = prng.poisson(prng.PRNGKey(0), lam, knuth_iters=3,
                                 rejection_iters=0)
    assert bool(unfinished)
    lam = torch.full((4096,), 10.0)
    _, unfinished = prng.poisson(prng.PRNGKey(0), lam, knuth_iters=0,
                                 rejection_iters=1)
    assert bool(unfinished)


def test_iteration_counts():
    assert prng.poisson_iters(0.0, 100) == 0
    n = prng.poisson_iters(0.5, 10 ** 5)
    tail = 1 - sum(np.exp(-0.5) * 0.5 ** k / math.factorial(k)
                   for k in range(n))
    assert 10 ** 5 * tail <= 1e-12 < 10 ** 5 * (tail + np.exp(-0.5) * 0.5 ** (n - 1)
                                                / math.factorial(n - 1))
    assert prng.rejection_iters(10 ** 5) == int(np.ceil(
        np.log(1e-12 / 10 ** 5) / np.log(prng.PTRS_REJECT)))


def test_ptrs_rejects_under_its_bound():
    """One PTRS iteration at λ = 10, where it rejects most, over 2**20
    lanes: the share rejected stays under ``PTRS_REJECT``."""
    k, _ = prng._poisson_rejection(prng.PRNGKey(3), torch.full((2 ** 20,), 10.0),
                                   1)
    assert float((k < 0).float().mean()) < prng.PTRS_REJECT

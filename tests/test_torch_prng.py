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

#: Every 4093rd float32 bit pattern (1,049,344 inputs: both signs, zeros,
#: subnormals, normals, infinities and NaNs), the values next to 1, and the
#: edges of the expansions.
_EDGES = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45,
                   -1e-45, 1e-40, 2.0 ** -126, 0.70710677, 0.41421357,
                   -0.41421357, 7.5, 1e5, 3.4e38], np.float32)
LOG_INPUTS = np.concatenate([
    np.arange(0, 2 ** 32, 4093, dtype=np.uint64).astype(np.uint32)
    .view(np.float32),
    (np.arange(-4096, 4097, dtype=np.int64) + 0x3F800000).astype(np.uint32)
    .view(np.float32),
    _EDGES])


@pytest.mark.parametrize("name", ("log", "log1p"))
def test_log_is_xlas_float32_expansion(name):
    """``prng.log_f32`` / ``log1p_f32`` equal the reference's compiled
    ``jnp.log`` / ``jnp.log1p`` bit for bit (NaN for NaN)."""
    x = LOG_INPUTS
    want = np.asarray(jax.jit(getattr(jax.numpy, name))(x))
    got = getattr(prng, f"{name}_f32")(torch.from_numpy(x.copy())).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert x.size > 10 ** 6
    assert same.all(), x[~same][:10]


def test_sqrt_is_correctly_rounded():
    """``prng.sqrt_f32`` (PTRS's ``sqrt(λ)``) is IEEE's float32 square root
    on every input, as XLA's is, where torch's CPU ``sqrt`` is not."""
    x = LOG_INPUTS
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = prng.sqrt_f32(torch.from_numpy(x.copy())).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:10]
    normal = (x > 2.0 ** -126) & np.isfinite(x)
    np.testing.assert_array_equal(
        got[normal], np.asarray(jax.jit(jax.numpy.sqrt)(x[normal])))


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_matches_jax(seed):
    """``prng.poisson`` equals ``jax.random.poisson`` in every one of 2000
    lanes per rate; a lane apart is named."""
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
    assert len(bad) == 0
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


# -- the batch plane's annealer: randint, exp and cooling ** s -----------------

@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 7), (0, 24), (3, 100),
                                   (0, 2 ** 16 + 3), (-5, 2 ** 31 - 1),
                                   (4, 4)])
def test_randint_matches_jax(lo, hi):
    """``prng.randint`` equals ``jax.random.randint(key, (), lo, hi)`` on
    256 keys, spans past 2**16 (where jax's multiplier wraps) included."""
    keys = jax.vmap(lambda i: jax.random.fold_in(prng_key(11), i))(
        np.arange(256, dtype=np.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(
        keys))
    got = prng.randint(torch.from_numpy(words(keys)), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_exp_is_xlas_float32_expansion():
    """``prng.exp_f32`` equals the reference's compiled ``jnp.exp`` bit for
    bit on every 4093rd float32 (the annealer's ``-(c_prop - cost) /
    temp`` reaches any of them) and the values next to 1."""
    x = LOG_INPUTS
    want = np.asarray(jax.jit(jax.numpy.exp)(x))
    got = prng.exp_f32(torch.from_numpy(x.copy())).numpy()
    same = (got.view(np.uint32) == want.view(np.uint32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:10]


#: Every 4093rd float32 in [0, 1] (the cooling factors), zero and one.
POW_BASES = np.concatenate([
    np.arange(0, 0x3F800001, 4093, dtype=np.int64).astype(np.uint32)
    .view(np.float32), np.float32([0.0, 1.0, 0.985, 2.0 ** -126])])
POW_STEPS = (0, 1, 2, 3, 5, 7, 13, 31, 64, 99, 128, 255, 299, 399, 1000, 4000)


def test_pow_is_glibcs_powf():
    """``prng.pow_f32`` equals the reference's compiled ``p.cooling ** s``
    (float32 base, int32 step) bit for bit over every 4093rd base in
    [0, 1] at the steps listed, and over the default cooling's first
    20,000 steps (into the flushed subnormals)."""
    f = jax.jit(lambda c, s: c ** s)
    base = torch.from_numpy(POW_BASES.copy())
    for s in POW_STEPS:
        want = np.asarray(f(POW_BASES, np.int32(s)))
        got = prng.pow_f32(base, torch.full(base.shape, float(s))).numpy()
        bad = got.view(np.uint32) != want.view(np.uint32)
        assert not bad.any(), (s, POW_BASES[bad][:5])
    steps = np.arange(20000, dtype=np.int32)
    want = np.asarray(f(np.float32(0.985), steps))
    got = prng.pow_f32(torch.tensor(0.985), torch.from_numpy(steps).float())
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))

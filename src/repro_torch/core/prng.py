"""Counter-based threefry2x32 PRNG, bit-exact to ``jax.random``.

The engine's randomness is the JAX reference's stream: ``PRNGKey(seed)``,
``split`` once per tick, ``fold_in(sub, w)`` per worker and a float32
``uniform`` of shape ``(S,)``.  These functions reproduce those bits under
``jax_threefry_partitionable=True`` (the default of the reference's JAX),
which fixes the counter layout: element ``i`` of a flat draw hashes the
64-bit counter ``i`` split into its (hi, lo) 32-bit words.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words.  All
uint32 arithmetic is done in int64 and masked with ``0xFFFFFFFF``, so the
same code runs on the CPU and the card.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .ordered import fma

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def normalize_seed(seed) -> int:
    """One seed normalization for every PRNG path: uint32, two's complement
    for negatives, truncation above 2**32 (the reference's
    ``repro.core.engine.normalize_seed``)."""
    return int(seed) & _M32


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on broadcastable int64 tensors holding
    uint32 values; returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(normalize_seed(seed))``: words ``(0, seed)``."""
    return torch.tensor([0, normalize_seed(seed)], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for one key and uint32 ``data``
    (a Python int or an integer tensor; a tensor gives one key per
    element, shape ``data.shape + (2,)``)."""
    if not torch.is_tensor(data):
        # A fill on the key's device: no host-to-device copy, no sync.
        data = torch.full((), int(data) & _M32, dtype=torch.int64,
                          device=key.device)
    data = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> int64 ``[num, 2]``; a batch of keys
    ``[..., 2]`` gives ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], idx)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element for a flat draw of ``n`` elements from each
    key in ``key[..., 2]`` -> int64 ``key.shape[:-1] + (n,)``."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0 ^ y1


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1) by the mantissa trick
    ``(bits >> 9) | 0x3F800000`` reinterpreted, minus 1.0."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)); a batch of
    keys ``[..., 2]`` gives ``key.shape[:-1] + shape``."""
    shape = tuple(shape) if isinstance(shape, (tuple, list)) else (int(shape),)
    n = int(np.prod(shape)) if shape else 1
    u = bits_to_unit_float(random_bits(key, n))
    return u.reshape(key.shape[:-1] + shape)


# -- Poisson ------------------------------------------------------------------
#
# ``jax.random.poisson`` of the reference's jax (0.9.0), on the same keys:
# Knuth's product of uniforms for λ < 10 and Hörmann's transformed rejection
# (PTRS) otherwise.  Both branches run over the whole shape from the same
# key (the rejection branch with λ = 1e5 in the Knuth lanes, the Knuth
# branch with λ = 0 in the others) and a select picks per lane; λ = 0 gives
# 0.  Each branch is a while loop that splits its key once per iteration
# and stops when every lane of the shape is done.  Here the iteration count
# is fixed by the caller, so no iteration reads the card:
#
# * Knuth: a lane done after ``n`` iterations stays done (``log(u) <= 0``),
#   so more iterations never change a result;
# * PTRS overwrites a lane's result at every later acceptance, so the
#   result depends on when the whole shape is done.  The loop carries that
#   point as a device flag and freezes every lane there.
#
# The engine gives each loop the iterations that finish every lane of a
# tick except with probability 1e-12 (:func:`poisson_iters` from the
# largest Knuth rate, e.g. 17 for 131,072 lanes at λ <= 0.7;
# :func:`rejection_iters` from PTRS's rejection share, 30 for 131,072
# lanes).  A lane still running after the last iteration is reported, not
# guessed: :func:`poisson` returns an ``unfinished`` flag per key and the
# engine raises if it is ever set.  ``log`` and ``log1p`` are the float32
# expansions XLA's CPU backend emits (:func:`log_f32`, :func:`log1p_f32`).
# XLA also rewrites PTRS's arithmetic before it emits it (read off the
# optimized HLO of ``jax.random.poisson``): it contracts products into fused
# multiply-adds (``b``, ``a``, ``k``'s argument, ``k * log(λ) - λ`` and
# lgamma's last product), folds constants into ``b - 3.4`` and ``b - 2``,
# and multiplies by ``1 / 7.5`` where lgamma divides; the port takes the
# same steps.  With these every lane of ``tests/test_torch_prng.py`` (4 keys x
# 2000 lanes per rate, λ up to 1e5) equals ``jax.random.poisson``.  PTRS's
# result depends on the iteration at which every lane has accepted, so one
# lane decided otherwise could move the others of its shape.

_LANCZOS = (676.520368121885098567009190444019,
            -1259.13921672240287047156078755283,
            771.3234287776530788486528258894,
            -176.61502916214059906584551354,
            12.507343278686904814458936853,
            -0.13857109526572011689554707,
            9.984369578019570859563e-6,
            1.50563273514931155834e-7)
_LANCZOS_BASE = 0.99999999999980993227684700473478


def _f32(v: float) -> float:
    return float(np.float32(v))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 tensor shaped like ``like``: a quotient of two
    tensors is one correctly rounded division on the CPU and the card
    alike, where a Python number over a tensor is its reciprocal times the
    number, and a tensor over a Python number on the card is the tensor
    times the number's reciprocal."""
    return torch.full_like(like, _f32(v))


# XLA's CPU backend expands float32 ``log`` itself (read off the LLVM IR of
# ``jax.jit(jnp.log)``, ``XLA_FLAGS=--xla_dump_to``): Cephes's polynomial on
# the mantissa in [sqrt(1/2), sqrt(2)) with ``ln 2`` split in two, its
# multiply-adds contracted into fused ones.  Two contractions the IR leaves
# open (``x - 0.5 * x2`` and the last ``C1 * e``) cannot change a bit: both
# products are exact.  Subnormal inputs are read as zero (the CPU runs with
# denormals-are-zero).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_C1, _LOG_C2 = 0.693359375, -2.12194440e-4
_SQRT_HALF = 0.70710678
_MIN_NORMAL = 2.0 ** -126
# ``log1p`` for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 * N(x) / D(x), both
# polynomials by Horner's rule from the highest coefficient.
_LOG1P_BELOW = 0.41421357
_LOG1P_D = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
            60.11866)
_LOG1P_N = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
            57.112965, 20.039553)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt`` (IEEE's, and XLA's for normal
    inputs), whatever computes the first guess: torch's CPU ``sqrt`` is an
    ulp off for some inputs and, on a large tensor, has given one thread's
    chunk other roundings than the rest.  The guess is moved to the float32
    nearest the root by comparing ``x`` with the squares of the midpoints
    beside it, exact in float64 (twice: a guess within two ulps)."""
    r = torch.sqrt(x)
    xd = x.to(torch.float64)
    ok = (x > 0) & (x < float("inf"))
    inf = torch.full_like(x, float("inf"))
    for _ in range(2):
        up = torch.nextafter(r, inf)
        down = torch.nextafter(r, -inf)
        rd = r.to(torch.float64)
        m_up = (rd + up.to(torch.float64)) * 0.5
        m_down = (rd + down.to(torch.float64)) * 0.5
        r = torch.where(ok & (xd >= m_up * m_up), up,
                        torch.where(ok & (xd < m_down * m_down), down, r))
    return r


def _daz(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def _log_finite(x: torch.Tensor) -> torch.Tensor:
    """The expansion for a positive normal float32 ``x`` (anything below
    the smallest normal, NaN too, is read as the smallest normal)."""
    x = torch.where(x > _MIN_NORMAL, x, torch.full_like(x, _MIN_NORMAL))
    bits = x.view(torch.int32)
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    low = m < _f32(_SQRT_HALF)
    f = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    f2 = f * f
    f3 = f2 * f
    p = _LOG_P
    y0, y1, y2 = fma(f, p[0], p[1]), fma(f, p[3], p[4]), fma(f, p[6], p[7])
    y0, y1, y2 = fma(y0, f, p[2]), fma(y1, f, p[5]), fma(y2, f, p[8])
    y0 = fma(fma(y0, f3, y1), f3, y2)
    t = fma(y0, f3, e * _f32(_LOG_C2))
    return fma(e, _LOG_C1, (f - f2 * 0.5) + t)


def _log_special(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    r = torch.where(x == float("inf"), x, r)
    r = torch.where(x == 0, torch.full_like(x, -float("inf")), r)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(x, float("nan")), r)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` of float32 ``x`` as the reference's compiled code
    computes it, bit for bit."""
    x = _daz(x)
    return _log_special(x, _log_finite(x))


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 ``x`` as the reference's compiled code
    computes it, bit for bit: the rational form near 0, else ``log(1 + x)``
    by :func:`log_f32`'s expansion."""
    x = _daz(x)
    y = x + 1.0
    big = _log_special(y, _log_finite(y))
    zero = x * 0.0
    d = zero + 1.0
    for c in _LOG1P_D[1:]:
        d = fma(d, x, c)
    n = zero + _f32(_LOG1P_N[0])
    for c in _LOG1P_N[1:]:
        n = fma(n, x, c)
    x2 = x * x
    small = x + fma(x2, -0.5, (x * x2) * (n / d))
    return torch.where(x.abs() < _f32(_LOG1P_BELOW), small, big)


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 Lanczos ``lgamma`` (g = 7, 8 terms) for ``x >= 0.5``
    (the Poisson sampler's ``k + 1``); no reflection branch."""
    z = x - 1.0
    a = torch.full_like(x, _f32(_LANCZOS_BASE))
    for i, c in enumerate(_LANCZOS):
        a = a + _const(c, x) / (z + float(i + 1))
    t = _f32(7.5) + z
    # XLA folds the division by 7.5 into a product with its reciprocal.
    log_t = _f32(np.log(7.5)) + log1p_f32(z * _f32(1 / 7.5))
    half_log_2pi = torch.full_like(x, _f32((np.log(2.0) + np.log(np.pi)) / 2))
    return fma((z + 0.5) - t / log_t, log_t, half_log_2pi) + log_f32(a)


def _key_chain(key: torch.Tensor, n_iters: int, n_sub: int):
    """The sampler loop's keys: ``key, *subs = split(key, 1 + n_sub)`` per
    iteration -> ``[n_iters, n_sub, ..., 2]``."""
    subs = []
    for _ in range(n_iters):
        ks = split(key, 1 + n_sub)
        key = ks[..., 0, :]
        subs.append(torch.movedim(ks[..., 1:, :], -2, 0))
    return torch.stack(subs)


def _flat(x: torch.Tensor, lead: int) -> torch.Tensor:
    return x.reshape(x.shape[:lead] + (-1,))


def _poisson_knuth(key, lam, n_iters: int):
    lead = key.dim() - 1
    u = uniform(_key_chain(key, n_iters, 1)[:, 0], lam.shape[lead:])
    log_u = log_f32(u)
    k = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    log_prod = torch.zeros_like(lam)
    for i in range(n_iters):
        k = k + (log_prod > -lam).to(torch.int32)
        log_prod = log_prod + log_u[i]
    unfinished = _flat(log_prod > -lam, lead).any(dim=-1)
    return k - 1, unfinished


def _poisson_rejection(key, lam, n_iters: int):
    lead = key.dim() - 1
    shape = lam.shape[lead:]
    keys = _key_chain(key, n_iters, 2)
    us = uniform(keys[:, 0], shape) - 0.5
    vs = uniform(keys[:, 1], shape)
    log_lam = log_f32(lam)
    # XLA contracts b's product and a's into fused multiply-adds, and folds
    # the constants of ``b - 3.4`` and ``b - 2`` into b's.
    sqrt_lam = sqrt_f32(lam)
    b = fma(sqrt_lam, 2.53, 0.931)
    a = fma(b, 0.02483, -0.059)
    inv_alpha = 1.1239 + _const(1.1328, b) / fma(
        sqrt_lam, 2.53, _f32(_f32(0.931) - _f32(3.4)))
    v_r = 0.9277 - _const(3.6224, b) / fma(
        sqrt_lam, 2.53, _f32(_f32(0.931) - 2.0))
    # No iteration's candidate depends on an earlier one's, so every
    # iteration's k, s and t are taken at once over ``[n_iters, ...]``; only
    # the acceptance walks the iterations.
    u_shifted = 0.5 - us.abs()
    k = torch.floor(fma(2 * a / u_shifted + b, us, lam) + 0.43)
    s = log_f32(vs * inv_alpha / (a / (u_shifted * u_shifted) + b))
    t = fma(k, log_lam, -lam) - lgamma(k + 1)
    accept1 = (u_shifted >= 0.07) & (vs <= v_r)
    reject = (k < 0) | ((u_shifted < 0.013) & (vs > u_shifted))
    accepts = accept1 | (~reject & (s <= t))
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    for i in range(n_iters):
        # The reference's loop has stopped for this key once every lane
        # accepted: later iterations change nothing.
        running = ~_flat(accepted, lead).all(dim=-1)
        accept = accepts[i] & running.reshape(running.shape + (1,) * len(shape))
        k_out = torch.where(accept, k[i], k_out)
        accepted = accepted | accept
    return k_out.to(torch.int32), ~_flat(accepted, lead).all(dim=-1)


def poisson(key: torch.Tensor, lam: torch.Tensor, *, knuth_iters: int,
            rejection_iters: int):
    """``jax.random.poisson(key, lam)`` (int32) for keys ``[..., 2]`` and
    float32 rates ``[..., *shape]`` (one shape per key).  ``knuth_iters``
    bounds the Knuth loop (0 skips it: no lane with 0 < λ < 10),
    ``rejection_iters`` the PTRS loop (0 skips it: no lane with λ >= 10).
    Returns ``(counts, unfinished)``; ``unfinished[...]`` is set for a key
    whose loops needed more iterations than given."""
    use_knuth = torch.isnan(lam) | (lam < 10)
    result = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    unfinished = torch.zeros(key.shape[:-1], dtype=torch.bool,
                             device=lam.device)
    if knuth_iters:
        kn, unf = _poisson_knuth(key, torch.where(use_knuth, lam, 0.0),
                                 knuth_iters)
        result = torch.where(use_knuth, kn, result)
        unfinished = unfinished | unf
    if rejection_iters:
        rj, unf = _poisson_rejection(key, torch.where(use_knuth, 1e5, lam),
                                     rejection_iters)
        result = torch.where(use_knuth, result, rj)
        unfinished = unfinished | unf
    return torch.where(lam == 0, 0, result), unfinished


def poisson_iters(lam_max: float, n_lanes: int, odds: float = 1e-12
                  ) -> int:
    """Knuth iterations that finish ``n_lanes`` lanes of rate at most
    ``lam_max`` (< 10) except with probability ``odds``: a lane with count
    ``X`` needs ``X + 1`` iterations, so this is the smallest ``n`` with
    ``n_lanes * P(X >= n) <= odds``."""
    if lam_max <= 0 or n_lanes <= 0:
        return 0

    def tail(n):
        return sum(math.exp(-lam_max + k * math.log(lam_max)
                            - math.lgamma(k + 1)) for k in range(n, n + 200))

    n = 1
    while n_lanes * tail(n) > odds:
        n += 1
    return n


#: Bound on the share of lanes PTRS rejects in one iteration, over λ >= 10
#: and the λ = 1e5 of the Knuth lanes: the share falls with λ, from 0.2478
#: at λ = 10 to 0.120 at λ = 1e5 (the largest over 4 keys x 2**20 draws per
#: λ; ``tests/test_torch_prng.py`` holds λ = 10 under it).
PTRS_REJECT = 0.26


def rejection_iters(n_lanes: int, odds: float = 1e-12) -> int:
    """PTRS iterations after which all ``n_lanes`` lanes have accepted
    except with probability ``odds``: ``n_lanes * PTRS_REJECT**n <= odds``."""
    if n_lanes <= 0:
        return 0
    return int(np.ceil(np.log(odds / n_lanes) / np.log(PTRS_REJECT)))


# -- randint, and the float32 exp and pow of the batch plane's annealer -------

def randint(key: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, (), minval, maxval)`` (int32) for a key
    ``[2]`` or a batch of keys ``[..., 2]`` and Python int bounds: two
    32-bit draws from ``split(key)``, folded into the span by jax's
    ``2**32 % span`` multiplier in uint32 arithmetic."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint bounds must lie in int32")
    span = max(maxval - minval, 1)
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], 1)[..., 0]
    lower = random_bits(ks[..., 1, :], 1)[..., 0]
    off = (((higher % span) * mult) & _M32) + lower % span
    return (minval + (off & _M32) % span).to(torch.int32)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Results below the smallest normal read as zero (the CPU backend
    runs with flush-to-zero)."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


# XLA's CPU backend expands float32 ``exp`` itself (read off the LLVM IR and
# the object code of the annealer's fused ``exp``, ``XLA_FLAGS=--xla_dump_to``):
# the argument clamped to [-87.8, 88.8], ``n = floor(x log2(e) + 0.5)``
# clamped to [-127, 127], ``r = x - n ln 2`` with ``ln 2`` split in two, a
# degree-5 polynomial, ``1 + r + r^2 p(r)`` scaled by ``2^n`` built in the
# exponent bits (``n = -127`` builds zero).  Every multiply-add is fused.
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_EXP_LOG2E = 1.4426950216293335
_EXP_C2 = -2.1219444170128554e-4
_EXP_P = (1.9875691e-4, 1.3981999e-3, 8.3334519e-3, 4.1665796e-2,
          1.6666666e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of float32 ``x`` as the reference's compiled code
    computes it, bit for bit (subnormal inputs and results read as zero)."""
    x = _daz(x)
    xc = torch.where(torch.isnan(x), x, torch.clamp(x, _EXP_LO, _EXP_HI))
    n = torch.clamp(torch.floor(fma(xc, _EXP_LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_LOG_C1, xc)
    r = fma(n, -_EXP_C2, r)
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        p = fma(p, r, c)
    y = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * scale)


# ``p.cooling ** s`` (a float32 base, the int32 step converted to float32)
# compiles to ``llvm.pow.f32``, a call into the host's libm: glibc's
# ``powf``.  It takes ``log2(x)`` from a 16-entry table of ``1/c`` and
# ``log2(c)`` plus a degree-5 polynomial, multiplies by ``y`` and takes
# ``2^(y log2 x)`` from a 32-entry table of ``2^(i/32)`` plus a cubic, all
# in double, rounding once to float32 at the end.  The tables are glibc's
# (``__powf_log2_data``, ``__exp2f_data``); the double steps are taken
# without glibc's fused multiply-adds, which moves no float32 result over
# the tested inputs.
_POWF_INVC_LOGC = (
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
_POWF_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp0"))
_POWF_EXP2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_POWF_SHIFT = float.fromhex("0x1.8p+47")          # rounds to a multiple of 1/32
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")


def _powf_tables(device):
    tab = torch.tensor([[float.fromhex(a), float.fromhex(b)]
                        for a, b in _POWF_INVC_LOGC], dtype=torch.float64,
                       device=device)
    exp2 = torch.tensor([2.0 ** (i / 32) for i in range(32)],
                        dtype=torch.float64, device=device)
    return tab, exp2


def pow_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x ** y`` of float32 tensors as the reference's compiled code
    computes it (glibc's ``powf`` with subnormal inputs and results read as
    zero), bit for bit, for ``x >= 0`` and finite ``y``."""
    x, y = torch.broadcast_tensors(_daz(x), y.to(torch.float32))
    tab, exp2 = _powf_tables(x.device)
    a = _POWF_LOG2_POLY
    c = _POWF_EXP2_POLY
    # log2(x) = log1p(z / c - 1) / ln 2 + log2(c) + k, z in [OFF, 2 OFF).
    ix = x.view(torch.int32).to(torch.int64) & _M32
    tmp = (ix - 0x3F330000) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = ((top ^ 0x80000000) - 0x80000000) >> 23
    z = (ix - top).to(torch.int32).view(torch.float32).to(torch.float64)
    r = z * tab[i, 0] - 1.0
    y0 = tab[i, 1] + k.to(torch.float64)
    r2 = r * r
    q = a[4] * r + y0
    q = (a[2] * r + a[3]) * r2 + q
    logx = (a[0] * r + a[1]) * (r2 * r2) + q
    ylogx = y.to(torch.float64) * logx
    # 2^ylogx = 2^(k / 32) 2^r, |r| <= 1/64.
    kd = (ylogx + _POWF_SHIFT) - _POWF_SHIFT
    r = ylogx - kd
    kk = (kd * 32).to(torch.int64)
    j = kk & 31
    scale = (((kk - j) >> 5) + 1023).clamp(1, 2046) << 52
    s = exp2[j] * scale.view(torch.float64)
    out = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s
    out = torch.where(ylogx > _POWF_OFLOW, torch.inf, out)
    out = torch.where(ylogx <= -150.0, 0.0, out).to(torch.float32)
    out = torch.where(x == 0, torch.where(y > 0, 0.0, torch.inf), out)
    return _ftz(torch.where(y == 0, 1.0, out))

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
# engine raises if it is ever set.  ``log`` and ``log1p`` are taken in float64
# and rounded once (the same bits on the CPU and the card); XLA's float32
# versions differ from correctly rounded values in the last bit for some
# inputs.  XLA also contracts two of PTRS's products into fused
# multiply-adds (``k * log(λ) - λ`` and lgamma's last product), which the
# port rounds once as well.  A lane whose acceptance test lies within an ulp
# of its threshold may still be decided otherwise, where ``t`` cancels
# large terms: over the 4 keys x 2000 lanes per rate of
# ``tests/test_torch_prng.py``, none below λ = 2e4, 10 lanes at 2e4 and 26
# at 1e5 (the Knuth lanes' stand-in), counted and named there.  PTRS's
# result also depends on the iteration at which every lane has accepted,
# so such a lane can move the others of its shape.

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


def _log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.to(torch.float64)).to(torch.float32)


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 Lanczos ``lgamma`` (g = 7, 8 terms) for ``x >= 0.5``
    (the Poisson sampler's ``k + 1``); no reflection branch."""
    z = x - 1.0
    a = torch.full_like(x, _f32(_LANCZOS_BASE))
    for i, c in enumerate(_LANCZOS):
        a = a + _const(c, x) / (z + float(i + 1))
    t = _f32(7.5) + z
    log_t = _f32(np.log(7.5)) + torch.log1p(
        (z / _const(7.5, x)).to(torch.float64)).to(torch.float32)
    half_log_2pi = torch.full_like(x, _f32((np.log(2.0) + np.log(np.pi)) / 2))
    return fma((z + 0.5) - t / log_t, log_t, half_log_2pi) + _log(a)


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
    log_u = _log(u)
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
    log_lam = _log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + _const(1.1328, b) / (b - 3.4)
    v_r = 0.9277 - _const(3.6224, b) / (b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=lam.device)
    for i in range(n_iters):
        u, v = us[i], vs[i]
        u_shifted = 0.5 - u.abs()
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = _log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = fma(k, log_lam, -lam) - lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        # The reference's loop has stopped for this key once every lane
        # accepted: later iterations change nothing.
        running = ~_flat(accepted, lead).all(dim=-1)
        accept = accept & running.reshape(running.shape + (1,) * len(shape))
        k_out = torch.where(accept, k, k_out)
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

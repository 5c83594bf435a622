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

import numpy as np
import torch

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
    """``jax.random.split(key, num)`` -> int64 ``[num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key, idx)


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

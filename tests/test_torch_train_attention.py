"""The port's attention backward against the JAX package, on the CPU.

``blocked_attention`` is a ``torch.autograd.Function`` whose backward on a
CPU tensor is the reference's tile-recompute backward
(``flash_attention_bwd_ref``, the port of ``_flash_bwd``).  Its gradients
are held to ``jax.grad`` of the reference's ``blocked_attention`` on the
same numpy inputs in float32, within 2e-5; the forward's row statistics to
the reference's ``_flash_fwd``.  The card's kernel is held to the plain
version by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.models import attention as TA

#: float32 on both sides: sums in other orders over at most 100 keys.
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
#: GQA H = 4 over Hk = 2, tiles of 32: window, S, D, schedule.
CASES = list(itertools.product((0, 24), (64, 100), (16, 32),
                               ("masked", "tri")))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def inputs(s, d, seed, b=2, h=4, hk=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d),
                          (b, s, h, d))]


@functools.lru_cache(maxsize=None)
def ref_grad(window, schedule):
    """jax.grad of <blocked_attention(q, k, v), g> for one mask, jitted."""
    kw = dict(causal=True, window=window, block_q=32, block_k=32,
              schedule=schedule)

    def f(q, k, v, g):
        return jnp.sum(RA.blocked_attention(q, k, v, **kw) * g)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))


@pytest.mark.parametrize("window,s,d,schedule", CASES)
def test_blocked_attention_grads_match_reference(window, s, d, schedule):
    q, k, v, g = inputs(s, d, seed=s + d + window)
    want = ref_grad(window, schedule)(q, k, v, g)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = TA.blocked_attention(tq, tk, tv, causal=True, window=window,
                               block_q=32, block_k=32, schedule=schedule)
    (out * torch.tensor(g)).sum().backward()
    for got, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   **GRAD_TOL)


def test_row_statistics_match_reference():
    """m and l of the plain forward equal the reference's _flash_fwd's
    (tile layout [B, H, nq, bq] read as [B, H, Sq])."""
    q, k, v, _ = inputs(100, 16, seed=1)
    kw = dict(causal=True, window=24, q_offset=0, block_q=32, block_k=32,
              schedule="masked", scale=None)
    out, (m, l) = RA._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    kw.pop("schedule")
    got, tm, tl = flash_attention_ref(*(torch.tensor(a) for a in (q, k, v)),
                                      return_stats=True, **kw)
    b, h = m.shape[:2]
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **GRAD_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(m).reshape(b, h, -1)
                               [..., :100], **GRAD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(l).reshape(b, h, -1)
                               [..., :100], **GRAD_TOL)


def test_backward_wrapper_on_cpu_runs_the_plain_version():
    """The wrapper's CPU path is flash_attention_bwd_ref with the caller's
    tiles (bit for bit), checks its inputs, and launches nothing."""
    q, k, v, g = (torch.tensor(a) for a in inputs(64, 16, seed=2))
    out, m, l = fa_ops.flash_attention(q, k, v, window=24, block_q=32,
                                       block_k=32, return_stats=True)
    assert m.shape == l.shape == (2, 4, 64) and m.dtype == torch.float32
    before = fa_ops.BWD_LAUNCHES
    got = fa_ops.flash_attention_bwd(q, k, v, out, m, l, g, window=24,
                                     block_q=32, block_k=32)
    want = flash_attention_bwd_ref(q, k, v, out, m, l, g, window=24,
                                   block_q=32, block_k=32)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fa_ops.BWD_LAUNCHES == before
    with pytest.raises(ValueError, match="m must be float32"):
        fa_ops.flash_attention_bwd(q, k, v, out, m[:, :2], l, g)
    with pytest.raises(ValueError, match="dout must be like q"):
        fa_ops.flash_attention_bwd(q, k, v, out, m, l, g[:, :10])


def test_no_statistics_without_a_gradient():
    """Serving (no gradient wanted) calls the plain forward without row
    statistics; a gradient goes through the autograd Function, whose
    output is the same."""
    q, k, v, _ = (torch.tensor(a) for a in inputs(64, 16, seed=3))
    calls = []
    real = TA.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("return_stats", False))
        return real(*args, **kw)

    TA.flash_attention = spy
    try:
        with torch.no_grad():
            plain = TA.blocked_attention(q, k, v, block_q=32, block_k=32)
        graded = TA.blocked_attention(q.requires_grad_(True), k, v,
                                      block_q=32, block_k=32)
    finally:
        TA.flash_attention = real
    assert calls == [False, True]
    assert graded.grad_fn is not None
    assert torch.equal(plain, graded.detach())

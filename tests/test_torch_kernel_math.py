"""The arithmetic of the port's redesigned kernels, on the CPU.

The card's kernels run only on the card, so what this file holds to the
JAX package is their arithmetic, written out in PyTorch:

* the bf16 flash-attention kernel (``csrc/flash_attention.cu``,
  ``flash_bf16_kernel``): scores in float32 from bf16 q/k, the scale times
  log2(e) folded into the exponent of ``exp2``, P rounded to bf16 before
  P V, float32 accumulation, 64 x 64 tiles over the live key tiles only.
  It must stay within the bf16 tolerance of tests/test_kernels.py (2e-2,
  compared in float32) of the Pallas kernel in interpret mode and of the
  reference's ``blocked_attention``; offset cases, which the Pallas kernel
  does not take, go against the port's float32 plain version;
* the rows with no live key (a window that ends before the first key):
  the reference's -1e30 mask makes them the sum of V over the key slots of
  its tiles, which the wrapper's ``first_dead_row`` / ``key_slots`` and the
  card's ``dead_rows_kernel`` reproduce;
* the three passes of the Mamba-2 SSD kernel (``csrc/mamba2_ssd.cu``) and
  of the RWKV-6 WKV kernel (``csrc/wkv6.cu``), whose plain versions
  ``chunk_state_ref``, ``state_pass_ref`` and ``chunk_scan_ref`` composed
  must equal the reference's ``ssd_chunked`` / ``wkv6_chunked`` and the
  Pallas kernel, output and final state, within ``SCAN_TOL`` (both
  packages sum the log decay's prefix in float32 in XLA CPU's order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.mamba2.kernel import mamba2_ssd_pallas
from repro.kernels.rwkv6.kernel import wkv6_pallas
from repro.models import attention as RA
from repro.models import rwkv as RR
from repro.models import ssm as RS
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2.ref import (chunk_scan_ref, chunk_state_ref,
                                            state_pass_ref)
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref

#: tests/test_kernels.py:129: bf16 against float32 references.
BF16_TOL = 2e-2
SCAN_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A fixed summation order for the port's CPU sums."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def flash_bf16_emulation(q, k, v, *, causal=True, window=0, q_offset=0,
                         round_p=True):
    """What ``flash_bf16_kernel`` computes, tile by tile: 64 queries by 64
    keys, the live key tiles of each query tile only, S = q k^T in float32
    (products of bf16 values are exact in float32), masked to -inf, the
    running max m in score units, p = exp2(s c - m c) with c = D^-0.5
    log2(e) in float32, l from the float32 p, acc from p rounded to bf16,
    out = acc / max(l, 1e-30) rounded to bf16; then, as the wrapper's
    second kernel, the rows with no live key set to the sum of V over the
    keys (float32) divided by ``key_slots(Sk, 512)`` (the wrapper's default
    ``block_k``).  ``round_p`` False keeps P in float32 (only to show what
    the rounding of P changes)."""
    b, sq, h, d = q.shape
    sk, rep = k.shape[1], h // k.shape[2]
    c = torch.tensor(d ** -0.5, dtype=torch.float32) \
        * torch.tensor(1 / math.log(2), dtype=torch.float32)
    pad = (-sk) % 64
    qf = q.float().permute(0, 2, 1, 3)                        # [B,H,Sq,D]
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
              .repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))                                # [B,H,Sk',D]
    out = torch.empty_like(qf)
    for q0 in range(0, sq, 64):
        q1 = min(q0 + 64, sq)
        qpos = torch.arange(q0, q1) + q_offset
        kt_end = -(-sk // 64)
        if causal:
            kt_end = min(kt_end, (q1 - 1 + q_offset) // 64 + 1)
        kt_begin = 0
        if window > 0 and q0 + q_offset - window + 1 > 0:
            kt_begin = (q0 + q_offset - window + 1) // 64
        m = torch.full((b, h, q1 - q0), -torch.inf)
        l = torch.zeros((b, h, q1 - q0))
        acc = torch.zeros((b, h, q1 - q0, d))
        for kt in range(kt_begin, kt_end):
            kpos = torch.arange(kt * 64, kt * 64 + 64)
            kt_keys = slice(kt * 64, kt * 64 + 64)
            s = qf[:, :, q0:q1] @ kf[:, :, kt_keys].transpose(-1, -2)
            rel = qpos[:, None] - kpos[None, :]
            ok = (kpos < sk)[None, :].expand_as(rel)
            if causal:
                ok = ok & (rel >= 0)
            if window > 0:
                ok = ok & (rel < window)
            s = torch.where(ok, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            ms = torch.where(m_new == -torch.inf, 0.0, m_new * c)
            corr = torch.exp2(m * c - ms)
            p = torch.exp2(s * c - ms[..., None])
            l = l * corr + p.sum(-1)                  # before rounding P
            if round_p:
                p = p.bfloat16().float()
            acc = acc * corr[..., None] + p @ vf[:, :, kt_keys]
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    first = fa_ops.first_dead_row(sq, sk, window, q_offset)
    out[:, :, first:] = (vf[:, :, :sk].sum(2, keepdim=True)
                         / fa_ops.key_slots(sk, 512))
    return out.permute(0, 2, 1, 3).bfloat16()


def bf16_qkv(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
            .bfloat16() for shape in ((b, sq, h, d), (b, sk, hk, d),
                                      (b, sk, hk, d))]


def within_bf16_tol(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    excess = np.abs(got - want) - (BF16_TOL + BF16_TOL * np.abs(want))
    assert excess.max() <= 0, (
        f"{what}: max |diff| {np.abs(got - want).max():.4g}, beyond "
        f"atol = rtol = {BF16_TOL} by {excess.max():.4g}")
    return float(np.abs(got - want).max())


#: (B, S, H, Hk, D, window, causal): GQA with a window at danube's head
#: width, MHA at gemma3's 256, a non-causal case, GQA with a ragged S.
EMULATION_CASES = [(1, 200, 4, 2, 80, 64, True), (1, 160, 4, 4, 256, 0, True),
                   (1, 150, 4, 2, 80, 0, False), (2, 130, 8, 2, 80, 0, True)]


@pytest.mark.parametrize("b,s,h,hk,d,window,causal", EMULATION_CASES)
def test_flash_bf16_arithmetic_matches_pallas_and_blocked(b, s, h, hk, d,
                                                          window, causal):
    q, k, v = bf16_qkv(b, s, s, h, hk, d, seed=s + d)
    got = flash_bf16_emulation(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_k=64, interpret=True)
    blocked = RA.blocked_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=64, block_k=64)
    worst = max(within_bf16_tol(got.float(), pallas, "against Pallas"),
                within_bf16_tol(got.float(), blocked, "against blocked"))
    # Rounding P to bf16 moves the output by a bf16 ulp or two at most.
    assert worst <= 2 ** -5


@pytest.mark.parametrize("sq,sk,hk,d,window", [(70, 170, 2, 80, 48),
                                               (64, 300, 1, 256, 0)])
def test_flash_bf16_arithmetic_with_offset(sq, sk, hk, d, window):
    """Prefill of a continuation (query i at key position i + Sk - Sq):
    against the port's float32 plain version of the same bf16 inputs."""
    q, k, v = bf16_qkv(1, sq, sk, 4, hk, d, seed=sk)
    kw = dict(causal=True, window=window, q_offset=sk - sq)
    got = flash_bf16_emulation(q, k, v, **kw)
    want = flash_attention_ref(q.float(), k.float(), v.float(), block_q=64,
                               block_k=64, **kw)
    within_bf16_tol(got.float(), want, "against the float32 plain version")


def test_flash_bf16_arithmetic_rounds_only_p():
    """With P kept in float32 the emulation is the float32 plain version
    up to the output's own rounding to bf16 (one bf16 ulp): the one
    numerical change of the bf16 kernel is P in bf16."""
    q, k, v = bf16_qkv(1, 130, 130, 4, 2, 80, seed=3)
    want = flash_attention_ref(q.float(), k.float(), v.float(), window=64,
                               block_q=64, block_k=64)
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(2 ** -20)))
                  - 7)
    exact_p = flash_bf16_emulation(q, k, v, window=64, round_p=False)
    assert float(((exact_p.float() - want).abs() / ulp).max()) <= 1
    rounded_p = flash_bf16_emulation(q, k, v, window=64)
    assert not torch.equal(rounded_p, exact_p)


#: (Sq, Sk, window, causal, q_offset): windows that end before the first
#: key for the last rows of a continuation, causal and not, with Sk below
#: and above the reference's 512-key tile.
DEAD_ROW_CASES = [(100, 60, 16, False, 50), (130, 70, 32, True, 60),
                  (80, 600, 64, True, 600)]


def test_first_dead_row_is_the_first_row_without_a_live_key():
    """Against the mask itself, over windows, offsets and both causalities."""
    for sq, sk, window, q_offset in [(8, 5, 2, 3), (8, 5, 2, 0), (6, 6, 0, 9),
                                     (5, 3, 1, 1), (9, 4, 3, 7), (4, 7, 2, 0)]:
        for causal in (True, False):
            qpos = np.arange(sq)[:, None] + q_offset
            rel = qpos - np.arange(sk)[None, :]
            ok = (rel >= 0) if causal else np.ones_like(rel, bool)
            if window:
                ok &= rel < window
            dead = np.flatnonzero(~ok.any(1))
            want = int(dead[0]) if dead.size else sq
            assert (dead == np.arange(want, sq)).all()
            assert fa_ops.first_dead_row(sq, sk, window, q_offset) == want
    assert fa_ops.key_slots(600, 512) == 1024
    assert fa_ops.key_slots(60, 512) == 60


@pytest.mark.parametrize("sq,sk,window,causal,q_offset", DEAD_ROW_CASES)
def test_flash_rows_without_a_live_key(sq, sk, window, causal, q_offset):
    """The reference's blocked_attention (masked schedule, -1e30) makes a row
    with no live key the sum of V over the key slots of its tiles; the
    port's plain version agrees in float32, and the bf16 kernel's
    arithmetic with the wrapper's second kernel within the bf16
    tolerance."""
    q, k, v = bf16_qkv(1, sq, sk, 4, 2, 64, seed=sk + q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    first = fa_ops.first_dead_row(sq, sk, window, q_offset)
    assert 0 < first < sq
    plain = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    blocked = RA.blocked_attention(jq, jk, jv, **kw)
    np.testing.assert_allclose(plain.numpy(), np.asarray(blocked),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    mean = (v.float().sum(1, keepdim=True)
            / fa_ops.key_slots(sk, 512)).repeat_interleave(2, dim=2)
    np.testing.assert_allclose(plain[:, first:].numpy(),
                               mean.expand(-1, sq - first, -1, -1).numpy(),
                               rtol=SCAN_TOL, atol=SCAN_TOL)
    got = flash_bf16_emulation(q, k, v, **kw)
    within_bf16_tol(got.float(), plain, "against the float32 plain version")


# -- the SSD passes ----------------------------------------------------------

def ssd_inputs(s, h, p, n, seed, decay="normal"):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, s, h, p)) * 0.5).astype(np.float32)
    if decay == "strong":
        a = np.exp(-rng.uniform(2.0, 46.0, (2, s, h))).astype(np.float32)
        a[:, ::7] = 1e-30
    else:
        a = (1 / (1 + np.exp(-rng.standard_normal((2, s, h)))) * 0.5
             + 0.45).astype(np.float32)
    b = (rng.standard_normal((2, s, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((2, s, n)) * 0.3).astype(np.float32)
    return x, a, b, c


def composed(x, a, b, c, chunk, h0=None):
    t = [torch.as_tensor(v) for v in (x, a, b, c)]
    cum, states = chunk_state_ref(t[0], t[1], t[2], chunk=chunk)
    h_in, hf = state_pass_ref(states, cum,
                              h0=None if h0 is None else torch.as_tensor(h0))
    return chunk_scan_ref(t[0], t[2], t[3], cum, h_in, chunk=chunk), hf


#: (S, H, P, N, chunk, with h0, decay).
SSD_PASS_CASES = [(128, 3, 16, 16, 32, False, "normal"),
                  (128, 2, 8, 16, 64, True, "normal"),
                  (128, 2, 8, 16, 32, False, "strong"),
                  (192, 2, 16, 8, 64, True, "strong")]


@pytest.mark.parametrize("s,h,p,n,chunk,with_h0,decay", SSD_PASS_CASES)
def test_ssd_passes_compose_to_the_reference(s, h, p, n, chunk, with_h0,
                                             decay):
    x, a, b, c = ssd_inputs(s, h, p, n, seed=s + p, decay=decay)
    h0 = (np.random.default_rng(7).standard_normal((2, h, p, n))
          .astype(np.float32) if with_h0 else None)
    y, hf = composed(x, a, b, c, chunk, h0)
    assert y.dtype == hf.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    tol = SCAN_TOL
    ry, rh = RS.ssd_chunked(*(jnp.asarray(v) for v in (x, a, b, c)), None,
                            chunk=chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=tol, atol=tol)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rh), rtol=tol, atol=tol)
    if h0 is None:
        py = mamba2_ssd_pallas(*(jnp.asarray(v) for v in (x, a, b, c)),
                               chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(py), rtol=tol,
                                   atol=tol)


def test_state_pass_leaves_the_state_entering_each_chunk():
    """After state_pass_ref, chunk c holds the reference's final state of
    the first c chunks (transposed), and the wrapper's CPU path is the
    plain version with no launch."""
    x, a, b, c = ssd_inputs(128, 2, 8, 16, seed=11)
    tx, ta, tb = (torch.as_tensor(v) for v in (x, a, b))
    cum, states = chunk_state_ref(tx, ta, tb, chunk=32)
    assert cum.shape == (2, 4, 2, 32) and states.shape == (2, 4, 2, 16, 8)
    before = dict(ssd_ops.PASS_LAUNCHES)
    h_in, hf = ssd_ops.state_pass(states.clone(), cum)
    assert ssd_ops.PASS_LAUNCHES == before
    assert torch.equal(h_in[:, 0], torch.zeros_like(h_in[:, 0]))
    for ci in range(1, 4):
        _, rh = RS.ssd_chunked(*(jnp.asarray(v[:, :32 * ci])
                                 for v in (x, a, b, c)), None, chunk=32)
        np.testing.assert_allclose(h_in[:, ci].transpose(-1, -2).numpy(),
                                   np.asarray(rh), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
    _, rh = RS.ssd_chunked(*(jnp.asarray(v) for v in (x, a, b, c)), None,
                           chunk=32)
    np.testing.assert_allclose(hf.numpy(), np.asarray(rh), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_pass_wrappers_take_the_plain_path_on_the_cpu_and_refuse_bad_input():
    x, a, b, c = (torch.as_tensor(v) for v in ssd_inputs(64, 2, 8, 16, seed=1))
    before = dict(ssd_ops.PASS_LAUNCHES), ssd_ops.LAUNCHES
    cum, states = ssd_ops.chunk_state(x, a, b, chunk=32)
    h_in, hf = ssd_ops.state_pass(states, cum)
    y = ssd_ops.chunk_scan(x, b, c, cum, h_in, chunk=32)
    assert (dict(ssd_ops.PASS_LAUNCHES), ssd_ops.LAUNCHES) == before
    want_y, want_hf = ssd_ops.mamba2_ssd(x, a, b, c, chunk=32)
    assert torch.equal(y, want_y) and torch.equal(hf, want_hf)
    with pytest.raises(ValueError, match="cum must be"):
        ssd_ops.chunk_scan(x, b, c, cum[..., :16], h_in, chunk=32)
    with pytest.raises(ValueError, match="states must be"):
        ssd_ops.chunk_scan(x, b, c, cum, h_in.transpose(-1, -2), chunk=32)
    with pytest.raises(ValueError, match="state_pass"):
        ssd_ops.state_pass(states, cum[:, :1])
    with pytest.raises(ValueError, match="h0"):
        ssd_ops.state_pass(states, cum, h0=torch.zeros(2, 2, 16, 8))
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.chunk_state(x.double(), a, b, chunk=32)
    assert ssd_ops.smem_bytes(128, 64, 64) <= ssd_ops.MAX_SMEM


# -- the WKV passes ----------------------------------------------------------

def wkv_inputs(s, h, kd, seed, decay="normal"):
    """tests/test_kernels.py's RWKV-6 distributions (lw down to about -20
    per step under "strong" decay), from numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((2, s, h, kd)) * 0.5).astype(np.float32)
               for _ in range(3))
    if decay == "strong":
        lw = -np.exp(rng.uniform(np.log(2.0), np.log(20.0), (2, s, h, kd)))
    else:
        lw = -np.exp(rng.standard_normal((2, s, h, kd)) * 0.5 - 1.5)
    u = (rng.standard_normal((h, kd)) * 0.1).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u


def wkv_composed(r, k, v, lw, u, chunk, s0=None):
    t = [torch.as_tensor(x) for x in (r, k, v, lw, u)]
    cwl, states = wkv_ref.chunk_state_ref(t[1], t[2], t[3], chunk=chunk)
    s_in, sf = wkv_ref.state_pass_ref(
        states, cwl, s0=None if s0 is None else torch.as_tensor(s0))
    return wkv_ref.chunk_scan_ref(*t, s_in, chunk=chunk), sf


#: (S, H, K, chunk, with s0, decay).
WKV_PASS_CASES = [(128, 3, 16, 32, False, "normal"),
                  (128, 2, 32, 64, True, "normal"),
                  (128, 2, 16, 32, False, "strong"),
                  (192, 2, 8, 64, True, "strong")]


@pytest.fixture(scope="module")
def wkv_reference():
    """The reference's wkv6_chunked and Pallas kernel on every case, compiled
    once for the module."""
    out = {}
    for case in WKV_PASS_CASES:
        s, h, kd, chunk, with_s0, decay = case
        x = wkv_inputs(s, h, kd, seed=s + kd, decay=decay)
        s0 = (np.random.default_rng(7).standard_normal((2, h, kd, kd))
              .astype(np.float32) if with_s0 else None)
        jx = [jnp.asarray(t) for t in x]
        ry, rs = RR.wkv6_chunked(*jx, chunk=chunk,
                                 s0=None if s0 is None else jnp.asarray(s0))
        py = (wkv6_pallas(*jx, chunk=chunk, interpret=True) if s0 is None
              else None)
        out[case] = x, s0, np.asarray(ry), np.asarray(rs), py
    return out


@pytest.mark.parametrize("case", WKV_PASS_CASES,
                         ids=lambda c: "S{}-H{}-K{}-L{}-s0{}-{}".format(*c))
def test_wkv6_passes_compose_to_the_reference(wkv_reference, case):
    (r, k, v, lw, u), s0, ry, rs, py = wkv_reference[case]
    chunk = case[3]
    y, sf = wkv_composed(r, k, v, lw, u, chunk, s0)
    assert y.dtype == sf.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    tol = SCAN_TOL
    np.testing.assert_allclose(y.numpy(), ry, rtol=tol, atol=tol)
    np.testing.assert_allclose(sf.numpy(), rs, rtol=tol, atol=tol)
    if py is not None:
        np.testing.assert_allclose(y.numpy(), np.asarray(py), rtol=tol,
                                   atol=tol)
    # wkv6_ref is the three passes composed, and the CPU path of the wrapper.
    t = [torch.as_tensor(x) for x in (r, k, v, lw, u)]
    s0t = None if s0 is None else torch.as_tensor(s0)
    for got, want in zip(wkv_ref.wkv6_ref(*t, chunk=chunk, s0=s0t), (y, sf)):
        assert torch.equal(got, want)


def test_wkv6_state_pass_leaves_the_state_entering_each_chunk():
    """After state_pass_ref, chunk c holds the reference's final state of
    the first c chunks, and the wrapper's CPU path is the plain version
    with no launch."""
    r, k, v, lw, u = wkv_inputs(128, 2, 8, seed=11)
    cwl, states = wkv_ref.chunk_state_ref(
        *(torch.as_tensor(x) for x in (k, v, lw)), chunk=32)
    assert cwl.shape == (2, 4, 2, 8) and states.shape == (2, 4, 2, 8, 8)
    before = dict(wkv_ops.PASS_LAUNCHES)
    s_in, sf = wkv_ops.state_pass(states.clone(), cwl)
    assert wkv_ops.PASS_LAUNCHES == before
    assert torch.equal(s_in[:, 0], torch.zeros_like(s_in[:, 0]))
    for ci in range(1, 4):
        _, rs = RR.wkv6_chunked(*(jnp.asarray(x[:, :32 * ci])
                                  for x in (r, k, v, lw)), jnp.asarray(u),
                                chunk=32)
        np.testing.assert_allclose(s_in[:, ci].numpy(), np.asarray(rs),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
    _, rs = RR.wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, lw, u)),
                            chunk=32)
    np.testing.assert_allclose(sf.numpy(), np.asarray(rs), rtol=SCAN_TOL,
                               atol=SCAN_TOL)


def test_wkv6_pass_wrappers_take_the_cpu_path_and_refuse_bad_input():
    r, k, v, lw, u = (torch.as_tensor(x) for x in wkv_inputs(64, 2, 8, seed=1))
    before = dict(wkv_ops.PASS_LAUNCHES), wkv_ops.LAUNCHES
    cwl, states = wkv_ops.chunk_state(k, v, lw, chunk=32)
    s_in, sf = wkv_ops.state_pass(states, cwl)
    y = wkv_ops.chunk_scan(r, k, v, lw, u, s_in, chunk=32)
    assert (dict(wkv_ops.PASS_LAUNCHES), wkv_ops.LAUNCHES) == before
    want_y, want_sf = wkv_ops.wkv6(r, k, v, lw, u, chunk=32)
    assert torch.equal(y, want_y) and torch.equal(sf, want_sf)
    with pytest.raises(ValueError, match="s_in must be"):
        wkv_ops.chunk_scan(r, k, v, lw, u, s_in[:, :1], chunk=32)
    with pytest.raises(ValueError, match="state_pass"):
        wkv_ops.state_pass(states, cwl[:, :1])
    with pytest.raises(ValueError, match="s0"):
        wkv_ops.state_pass(states, cwl, s0=torch.zeros(2, 2, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.chunk_state(k, v, lw.double(), chunk=32)
    with pytest.raises(TypeError, match="bfloat16"):
        wkv_ops.chunk_state(k, v.half(), lw, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv_ops.chunk_scan(r, k, v, lw, u, s_in, chunk=48)
    # The serving shape fits two chunk_scan blocks per SM in bf16; chunk 128
    # at K = 64 fits one block in bf16 (r, k, v stay bf16 in shared memory;
    # the kernel before the three passes refused it), not in float32.
    assert 2 * (wkv_ops.smem_bytes(64, 64, 2) + 1024) <= 233472
    assert wkv_ops.smem_bytes(128, 32) <= wkv_ops.MAX_SMEM
    assert wkv_ops.smem_bytes(128, 64, 2) <= wkv_ops.MAX_SMEM
    assert wkv_ops.smem_bytes(128, 64) > wkv_ops.MAX_SMEM
    assert wkv_ops.smem_bytes(256, 64, 2) > wkv_ops.MAX_SMEM

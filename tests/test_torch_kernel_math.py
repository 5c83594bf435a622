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
* the bf16 flash backward (``bwd_tc::dq_kernel`` and ``dkv_kernel``):
  S and dP in float32 from bf16 operands, p from the forward's m and l,
  p and dS rounded to bf16 before the dV, dK and dQ products, float32
  accumulation.  Its chain from the bf16 forward must stay within the card
  check's 2e-2 of each gradient's max (chip_smoke.FLASH_BWD_TOL) of
  ``jax.grad`` through the reference's ``blocked_attention`` in float32;
* the rows with no live key (a window that ends before the first key):
  the reference's -1e30 mask makes them the sum of V over the key slots of
  its tiles, which the wrapper's ``first_dead_row`` / ``key_slots`` and the
  card's ``dead_rows_kernel`` reproduce;
* the three passes of the Mamba-2 SSD kernel (``csrc/mamba2_ssd.cu``) and
  of the RWKV-6 WKV kernel (``csrc/wkv6.cu``), whose plain versions
  ``chunk_state_ref``, ``state_pass_ref`` and ``chunk_scan_ref`` composed
  must equal the reference's ``ssd_chunked`` / ``wkv6_chunked`` and the
  Pallas kernel, output and final state, within ``SCAN_TOL`` (both
  packages sum the log decay's prefix in float32 in XLA CPU's order);
* the SSD backward's ``chunk_bwd`` on the tensor cores in split TF32:
  every float32 operand of its products rounded as the kernel rounds it
  (TF32 to nearest, ties away from zero, hi and lo = TF32(v - hi)), the
  products hi.hi + hi.lo + lo.hi summed in float32 (one or two of them
  where an operand is a bf16 B or C, exact in TF32), composed with the
  plain first two passes into the whole backward, within ``GRAD_TOL`` of
  each gradient's max of ``jax.vjp`` of the reference's ``ssd_chunked``;
* the WKV backward's ``chunk_dstate`` and ``chunk_bwd`` on the tensor
  cores: the same split TF32, the chunk cut into 16-row blocks anchored at
  the cwe of their first rows (A's, P's and Q's off-diagonal blocks as
  products of r exp(cwe - c_a) and k exp(c_a - cwi), the exact gates on
  the diagonal blocks), composed into the backward within ``GRAD_TOL`` of
  ``jax.vjp`` of ``wkv6_chunked`` on tests/test_torch_wkv_bwd.py's
  strong-decay and bf16 cases (lw down to -40 a step); single TF32 leaves
  that tolerance; every anchored factor is finite and at most 1 up to the
  prefix's rounding.
"""
import math

import jax
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
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.mamba2 import ops as ssd_ops
from repro_torch.kernels.mamba2.ref import (chunk_dstate_ref, chunk_scan_ref,
                                            chunk_state_ref, mamba2_ssd_ref,
                                            state_pass_bwd_ref,
                                            state_pass_ref)
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from test_torch_wkv_bwd import to_torch as wkv_bwd_torch
from test_torch_wkv_bwd import wkv_inputs as wkv_bwd_inputs

#: tests/test_kernels.py:129: bf16 against float32 references.
BF16_TOL = 2e-2
SCAN_TOL = 2e-5
#: The SSD backward's gradients against jax.vjp: max abs error over each
#: gradient's max (tests/test_torch_ssd_bwd.py, chip_smoke.SSD_BWD_TOL).
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A fixed summation order for the port's CPU sums."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def flash_bf16_emulation(q, k, v, *, causal=True, window=0, q_offset=0,
                         round_p=True, return_stats=False):
    """What ``flash_bf16_kernel`` computes, tile by tile: 64 queries by 64
    keys, the live key tiles of each query tile only, S = q k^T in float32
    (products of bf16 values are exact in float32), masked to -inf, the
    running max m in score units, p = exp2(s c - m c) with c = D^-0.5
    log2(e) in float32, l from the float32 p, acc from p rounded to bf16,
    out = acc / max(l, 1e-30) rounded to bf16; then, as the wrapper's
    second kernel, the rows with no live key set to the sum of V over the
    keys (float32) divided by ``key_slots(Sk, 512)`` (the wrapper's default
    ``block_k``).  ``round_p`` False keeps P in float32 (only to show what
    the rounding of P changes).  ``return_stats`` adds the kernel's row
    statistics, float32 [B, H, Sq]: the running max of the score times the
    scale, and l."""
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
    m_out, l_out = (torch.empty((b, h, sq)) for _ in range(2))
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
        m_out[:, :, q0:q1] = m * torch.tensor(d ** -0.5, dtype=torch.float32)
        l_out[:, :, q0:q1] = l
    first = fa_ops.first_dead_row(sq, sk, window, q_offset)
    out[:, :, first:] = (vf[:, :, :sk].sum(2, keepdim=True)
                         / fa_ops.key_slots(sk, 512))
    out = out.permute(0, 2, 1, 3).bfloat16()
    return (out, m_out, l_out) if return_stats else out


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


def flash_bwd_bf16_emulation(q, k, v, out, m, l, dout, *, causal=True,
                             window=0, q_offset=0, round_ps=True):
    """What the tensor-core backward (``bwd_tc::dq_kernel`` and
    ``dkv_kernel``) computes: S = q k^T and dP = dO v^T in float32 (products
    of bf16 values are exact in float32; the kernels' tiles change only the
    order of the sums), p = exp2(s c - m log2(e)) / max(l, 1e-30) with
    c = D^-0.5 log2(e) from the forward's m (in units of the scaled score)
    and l, 0 where the mask is dead, delta = rowsum(dO out) in float32,
    dS = p (dP - delta); p and dS rounded to bf16 before dV = p^T dO,
    dK = scale dS^T q and dQ = scale dS k, which accumulate in float32; the
    query heads of a KV head summed onto it; gradients in q's dtype.
    ``round_ps`` False keeps p and dS in float32."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    log2e = torch.tensor(1 / math.log(2), dtype=torch.float32)

    def heads(t, r):        # [B, S, Hx, D] -> [B, H, S, D] float32
        return t.float().repeat_interleave(r, dim=2).permute(0, 2, 1, 3)

    qf, dof, of = heads(q, 1), heads(dout, 1), heads(out, 1)
    kf, vf = heads(k, rep), heads(v, rep)
    rel = (torch.arange(sq)[:, None] + q_offset) - torch.arange(sk)[None, :]
    ok = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        ok = ok & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    s = qf @ kf.transpose(-1, -2)
    p = (torch.exp2(s * (scale * log2e) - (m * log2e)[..., None])
         / torch.clamp_min(l, 1e-30)[..., None])
    p = torch.where(ok, p, 0.0)
    delta = (dof * of).sum(-1)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    if round_ps:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq = (ds @ kf) * scale
    dk = ((ds.transpose(-1, -2) @ qf) * scale).reshape(b, hk, rep, sk, d)
    dv = (p.transpose(-1, -2) @ dof).reshape(b, hk, rep, sk, d)
    return tuple(t.permute(0, 2, 1, 3).to(q.dtype)
                 for t in (dq, dk.sum(2), dv.sum(2)))


#: (B, S, H, Hk, D, window, causal): GQA 4/2 at danube's width, MHA at
#: musicgen's, minicpm3's folded width with one KV head, a width staged
#: element by element with a window (causal and not), ragged S.
BWD_EMULATION_CASES = [(1, 200, 4, 2, 80, 0, True),
                       (1, 150, 4, 4, 64, 0, False),
                       (1, 130, 4, 1, 96, 0, True),
                       (1, 170, 4, 2, 18, 48, True),
                       (1, 190, 2, 1, 18, 64, False)]


def rel_to_max(got, want):
    """Max abs error over the max abs value (chip_smoke.flash_bwd_check)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def flash_bwd_reference():
    """Per case: bf16 q, k, v, dout and jax.grad of sum(out * dout) through
    the reference's blocked_attention, float32 on the same values;
    compiled once for the module."""
    out = {}
    for case in BWD_EMULATION_CASES:
        b, s, h, hk, d, window, causal = case
        q, k, v = bf16_qkv(b, s, s, h, hk, d, seed=s + d)
        rng = np.random.default_rng(d)
        dout = torch.as_tensor(rng.standard_normal((b, s, h, d))
                               .astype(np.float32)).bfloat16()
        jq, jk, jv, jdo = (jnp.asarray(t.float().numpy())
                           for t in (q, k, v, dout))

        def loss(q_, k_, v_, causal=causal, window=window):
            o = RA.blocked_attention(q_, k_, v_, causal=causal, window=window,
                                     block_q=64, block_k=64)
            return (o * jdo).sum()

        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
        out[case] = (q, k, v, dout), [np.asarray(g) for g in grads]
    return out


@pytest.mark.parametrize("case", BWD_EMULATION_CASES,
                         ids=lambda c: "B{}-S{}-H{}-Hk{}-D{}-w{}-c{}"
                         .format(*c))
def test_flash_bwd_bf16_arithmetic_matches_jax_grad(flash_bwd_reference,
                                                    case):
    """The bf16 chain (forward emulation with its statistics, then the
    backward's) within 2e-2 of each gradient's max of jax.grad."""
    (q, k, v, dout), want = flash_bwd_reference[case]
    kw = dict(causal=case[6], window=case[5])
    out, m, l = flash_bf16_emulation(q, k, v, return_stats=True, **kw)
    got = flash_bwd_bf16_emulation(q, k, v, out, m, l, dout, **kw)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        err = rel_to_max(g.float(), w)
        assert err <= BF16_TOL, f"{name}: {err:.3g} of its max"


def test_flash_bwd_bf16_arithmetic_rounds_only_p_and_ds():
    """With p and dS kept in float32, the emulation on float32 values is
    the port's float32 plain backward (the reference's _flash_bwd) up to
    the order of float32 sums; rounding them to bf16 moves the gradients,
    within the bf16 tolerance."""
    q, k, v = (t.float() for t in bf16_qkv(1, 200, 200, 4, 2, 80, seed=9))
    dout = torch.as_tensor(np.random.default_rng(10).standard_normal(
        q.shape).astype(np.float32)).bfloat16().float()
    kw = dict(causal=True, window=64)
    out, m, l = flash_attention_ref(q, k, v, return_stats=True, block_q=64,
                                    block_k=64, **kw)
    want = flash_attention_bwd_ref(q, k, v, out, m, l, dout, block_q=64,
                                   block_k=64, **kw)
    exact = flash_bwd_bf16_emulation(q, k, v, out, m, l, dout,
                                     round_ps=False, **kw)
    rounded = flash_bwd_bf16_emulation(q, k, v, out, m, l, dout, **kw)
    for e, r, w in zip(exact, rounded, want):
        assert rel_to_max(e, w) <= 1e-5
        assert not torch.equal(r, e)
        assert rel_to_max(r, w) <= BF16_TOL


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


# -- the SSD backward in split TF32 ------------------------------------------

def tf32_round(t):
    """float32 ``t`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero: what cvt.rna.tf32.f32 gives a finite value, and how
    chunk_bwd rounds (adding half of the dropped 13 bits, then masking)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def tf32_split(t):
    """(hi, lo) with hi = TF32(t) and lo = TF32(t - hi)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def split_mm(a, b, a_exact=False, b_exact=False, passes=3):
    """a @ b (batched) as chunk_bwd's mma take it: lo.hi + hi.lo + hi.hi,
    each product exact in float32 and summed in float32, the pass with an
    exact operand's lo left out; ``passes=1`` keeps hi.hi alone (single
    TF32)."""
    ah, al = tf32_split(a.float())
    bh, bl = tf32_split(b.float())
    out = ah @ bh
    if passes == 3 and not b_exact:
        out = out + ah @ bl
    if passes == 3 and not a_exact:
        out = out + al @ bh
    return out


def chunk_bwd_split_tf32_emulation(x, a, b, c, dy, cum, h_in, r, *, chunk,
                                   passes=3):
    """What chunk_bwd (``csrc/mamba2_ssd.cu``) computes: chunk_bwd_ref's
    arithmetic with its eight products in split TF32, in the kernel's
    arrangement -- the Gram C B^T once per chunk, per head dx = M1^T dy +
    w o (B R), (w o x) R^T and dy S^T for dB's and dC's state terms, D =
    dy x^T; then sum_h M2 B and (sum_h M2)^T C once.  B and C loaded from
    bf16 are exact in TF32 (fewer passes).  Returns (dx, da, db, dc), db
    and dc in float32 (the kernel's partials before sum_groups casts them
    to b's dtype)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    exact = b.dtype == torch.bfloat16

    def mm(u, v, ux=False, vx=False):
        return split_mm(u, v, ux, vx, passes)

    xs = x.float().reshape(bsz, nc, chunk, h, p)
    ys = dy.float().reshape(bsz, nc, chunk, h, p)
    bs = b.float().reshape(bsz, nc, chunk, n)
    cs = c.float().reshape(bsz, nc, chunk, n)
    cumt = cum.transpose(2, 3)                                    # [B,nc,L,H]
    ones = torch.ones((chunk, chunk), dtype=torch.bool)
    tri, below = torch.tril(ones), torch.tril(ones, -1)
    e = torch.exp(cumt)
    w = torch.exp(cumt[:, :, -1:] - cumt)
    cb = mm(cs, bs.transpose(-1, -2), exact, exact)               # [B,nc,L,L]
    msum = torch.zeros_like(cb)
    db = torch.zeros_like(bs)
    dc = torch.zeros_like(cs)
    dx = torch.zeros_like(xs)
    dcum = torch.zeros_like(cumt)
    for hh in range(h):
        rel = cumt[..., :, None, hh] - cumt[..., None, :, hh]
        g = torch.exp(torch.where(tri, rel, -torch.inf))
        xh, yh = xs[..., hh, :], ys[..., hh, :]                   # [B,nc,L,P]
        rt, st = r[:, :, hh], h_in[:, :, hh]                      # [B,nc,N,P]
        wh, eh = w[..., hh, None], e[..., hh, None]
        m1 = cb * g
        d = mm(yh, xh.transpose(-1, -2))
        t = torch.where(below, m1 * d, 0.0)
        msum = msum + d * g
        rb = mm(bs, rt, exact, False)                             # B R
        dx[..., hh, :] = mm(m1.transpose(-1, -2), yh) + wh * rb
        sdy = mm(yh, st.transpose(-1, -2))                        # dy S^T
        dc = dc + eh * sdy
        db = db + mm(wh * xh, rt.transpose(-1, -2))               # (w x) R^T
        u = wh[..., 0] * (xh * rb).sum(-1)
        dcum[..., hh] = (t.sum(-1) - t.sum(-2) + eh[..., 0] * (cs * sdy).sum(-1)
                         - u)
        dcum[:, :, -1, hh] += e[:, :, -1, hh] * (rt * st).sum((-1, -2)) \
            + u.sum(-1)
    dc = dc + mm(msum, bs, False, exact)
    db = db + mm(msum.transpose(-1, -2), cs, False, exact)
    dla = dcum.flip(2).cumsum(2).flip(2).reshape(bsz, s, h)
    af = a.float()
    floor = torch.tensor(1e-20, dtype=torch.float32)
    da = torch.where(af > floor, dla / af,
                     torch.where(af == floor, 0.5 * (dla / af), 0.0))
    return (dx.reshape(bsz, s, h, p), da, db.reshape(bsz, s, n),
            dc.reshape(bsz, s, n))


def ssd_bwd_split_tf32(x, a, b, c, dy, dhf, h0, *, chunk, passes=3):
    """The whole backward with chunk_bwd emulated: the plain forward's
    scratch, chunk_dstate_ref and state_pass_bwd_ref (float32 on the FMA
    pipes in the kernels), then the emulation.  (dx, da, db, dc, dh0)."""
    _, _, cum, h_in = mamba2_ssd_ref(x, a, b, c, chunk=chunk, h0=h0,
                                     keep=True)
    q = chunk_dstate_ref(dy, c, cum, chunk=chunk)
    rr, dh0 = state_pass_bwd_ref(q, cum, dhf=dhf)
    return chunk_bwd_split_tf32_emulation(x, a, b, c, dy, cum, h_in, rr,
                                          chunk=chunk, passes=passes) + (dh0,)


#: (B, S, H, P, N, chunk, b/c dtype, h0, decay): float32 and bf16 b/c, an
#: initial state, strong decay (a below, at and above the 1e-20 clamp), and
#: a chunk of 20 with P = 20, N = 12 (tiles of 16 x 8 cut at every edge).
SPLIT_CASES = [(2, 64, 3, 16, 16, 32, "float32", False, "normal"),
               (2, 64, 3, 16, 16, 16, "bfloat16", True, "normal"),
               (2, 64, 2, 16, 8, 32, "float32", True, "strong"),
               (1, 60, 3, 20, 12, 20, "float32", True, "strong")]


def split_inputs(case, seed):
    """numpy float32 (x, a, b, c, h0, dy, dhf); bf16 b/c hold bf16 values."""
    bsz, s, h, p, n, _, dtype, with_h0, decay = case
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bsz, s, h, p)) * 0.5).astype(np.float32)
    if decay == "strong":
        a = np.exp(-rng.uniform(2.0, 46.0, (bsz, s, h))).astype(np.float32)
        a[:, ::7] = 1e-30
        a[:, 5::9] = np.float32(1e-20)
    else:
        a = (1 / (1 + np.exp(-rng.standard_normal((bsz, s, h)))) * 0.5
             + 0.45).astype(np.float32)
    b, c = ((rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
            for _ in range(2))
    if dtype == "bfloat16":
        b, c = (torch.from_numpy(t).bfloat16().float().numpy() for t in (b, c))
    h0 = (rng.standard_normal((bsz, h, p, n)).astype(np.float32) if with_h0
          else np.zeros((bsz, h, p, n), np.float32))
    dy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dhf = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return x, a, b, c, h0, dy, dhf


@pytest.fixture(scope="module")
def split_reference():
    """Per case: the inputs and jax.vjp of the reference's ssd_chunked
    (float32; bf16 b/c as their float32 values), compiled once here."""
    out = {}
    for k, case in enumerate(SPLIT_CASES):
        x, a, b, c, h0, dy, dhf = split_inputs(case, seed=40 + k)
        _, vjp = jax.vjp(lambda *t: RS.ssd_chunked(*t[:4], None,
                                                   chunk=case[5], h0=t[4]),
                         x, a, b, c, h0)
        grads = vjp((jnp.asarray(dy), jnp.asarray(dhf)))
        out[case] = ((x, a, b, c, h0, dy, dhf),
                     [np.asarray(gr, np.float64) for gr in grads])
    return out


def split_errors(case, inputs, want, passes=3):
    """{gradient: max abs error over its max}, da as da * max(a, 1e-20)."""
    x, a, b, c, h0, dy, dhf = (torch.from_numpy(v) for v in inputs)
    if case[6] == "bfloat16":
        b, c = b.bfloat16(), c.bfloat16()
    got = ssd_bwd_split_tf32(x, a, b, c, dy, dhf, h0, chunk=case[5],
                             passes=passes)
    scale = np.maximum(inputs[1], np.float32(1e-20)).astype(np.float64)
    errs = {}
    for name, gt, wt in zip(("dx", "da", "db", "dc", "dh0"), got, want):
        gt = gt.float().numpy().astype(np.float64)
        if name == "da":
            gt, wt = gt * scale, wt * scale
        errs[name] = float(np.abs(gt - wt).max() / np.abs(wt).max())
    return errs


@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: (
    "B{}-S{}-H{}-P{}-N{}-L{}-{}-h0{}-{}".format(*c)))
def test_ssd_bwd_split_tf32_matches_jax_vjp(split_reference, case):
    """chunk_bwd's split-TF32 arithmetic, composed into the backward, within
    GRAD_TOL of jax.vjp's every gradient."""
    inputs, want = split_reference[case]
    errs = split_errors(case, inputs, want)
    assert all(v <= GRAD_TOL for v in errs.values()), errs


def test_ssd_bwd_single_tf32_loses_the_split_accuracy(split_reference):
    """hi.hi alone (single TF32) is at least ten times further from
    jax.vjp than the split, on a float32 case: the lo passes carry the
    accuracy the tolerance asks for."""
    case = SPLIT_CASES[0]
    inputs, want = split_reference[case]
    split = max(split_errors(case, inputs, want).values())
    single = max(split_errors(case, inputs, want, passes=1).values())
    assert single > 10 * split


def test_tf32_split_rounds_to_nearest_ties_away_and_bf16_is_exact():
    """TF32 rounding on the 13 dropped bits: ties go away from zero, below
    a tie down; hi + lo carries 22 bits.  Every finite bf16 value (all 2^16
    bit patterns but infinities and NaNs) is its own hi, with lo exactly 0:
    why a product with a bf16 B or C skips the pass with its lo."""
    one = 0x3F800000
    vals = torch.tensor([one + 0x1000, one + 0xFFF, one + 0x3000,
                         (one + 0x1000) | -0x80000000], dtype=torch.int32)
    hi = tf32_round(vals.view(torch.float32)).view(torch.int32)
    assert hi.tolist() == [one + 0x2000, one, one + 0x4000,
                           (one + 0x2000) | -0x80000000]
    v = torch.tensor([1 / 3, -2.718281828, 1e-30, 6.5e4], dtype=torch.float32)
    h, lo = tf32_split(v)
    assert torch.all(torch.abs((h + lo) - v) <= torch.abs(v) * 2.0 ** -21)
    bits = torch.arange(2 ** 16, dtype=torch.int32) << 16
    bf = bits.view(torch.float32)
    finite = torch.isfinite(bf)
    h, lo = tf32_split(bf[finite])
    assert torch.equal(h.view(torch.int32), bits[finite])
    assert torch.equal(lo, torch.zeros_like(lo))


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


# -- the WKV backward in split TF32 ------------------------------------------

#: (B, S, H, K, chunk, r/k/v dtype, s0, dsf, decay, tail) of
#: tests/test_torch_wkv_bwd.py's strong-decay and bf16 cases (lw down to
#: -40 a step), and chunk 20 with K = 12 (a 16-row block cut at 4 rows).
WKV_SPLIT_CASES = [
    (2, 64, 3, 16, 16, "float32", False, True, "strong", False),
    (2, 64, 4, 32, 32, "bfloat16", True, False, "normal", False),
    (2, 48, 2, 16, 16, "bfloat16", False, False, "normal", True),
    (2, 96, 2, 32, 32, "float32", True, True, "strong", False),
    (2, 60, 2, 12, 20, "float32", True, True, "strong", True),
]
WKV_SPLIT_IDS = ["L16-strong-dsf", "L32-bf16-s0", "L16-bf16-tail",
                 "L32-strong-s0-dsf", "L20-K12-strong-tail"]


def wkv_gate(x):
    """A gate or anchored factor as chunk_bwd takes it: exp(x), the
    exponent capped at 64 only so zero-padded rows stay finite."""
    return torch.exp(torch.clamp_max(x, 64.0))


def wkv_chunk_bwd_split_tf32_emulation(r, k, v, lw, u, dy, s_in, sf, ds, *,
                                       chunk, passes=3):
    """What chunk_bwd (``csrc/wkv6.cu``) computes, in its arrangement: the
    chunk cut into blocks of 16 rows, each anchored at the cwe of its first
    row c_a; A's, P's and Q's off-diagonal blocks as split-TF32 products of
    the scaled operands r exp(cwe - c_a) and k exp(c_a - cwi) with the row
    scales exp(cwe - c_a) (P) and exp(c_{a+1} - cwi) (Q); the diagonal 16 x
    16 blocks with the exact per-pair gates in float32; the state terms S
    dy, dS' v and (exp(cwl - cwe - lw) k) dS', D = dy v^T and A^T dy in split
    TF32, a product with a bf16 v taking two passes.  dr, dk and dlw from P
    and Q as chunk_bwd_ref takes them.  Returns (dr, dk, dv in r's dtype,
    dlw, du), as chunk_bwd_ref."""
    bsz, s, h, kd = r.shape
    nc = s // chunk
    exact = r.dtype == torch.bfloat16

    def mm(a, b, a_exact=False, b_exact=False):
        return split_mm(a, b, a_exact, b_exact, passes)

    def heads(t):  # [B, S, H, K] -> float32 [B, nc, H, L, K]
        return t.float().reshape(bsz, nc, chunk, h, kd).transpose(2, 3)

    rs, ks, vs, lws, ys = (heads(t) for t in (r, k, v, lw, dy))
    cwe, cwl = wkv_ref._prefix(lws.transpose(2, 3))
    cwe, cwl = cwe.transpose(2, 3), cwl[..., None, :]   # [B,nc,H,L,K], [..,1,K]
    cwi = cwe + lws
    s_out = torch.cat([s_in[:, 1:], sf[:, None]], 1)
    uf = u.float()[None, None, :, None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), -1)
    blocks = [(a0, min(a0 + 16, chunk)) for a0 in range(0, chunk, 16)]

    d = mm(ys, vs.transpose(-1, -2), False, exact)          # dy_i . v_j
    dd = torch.diagonal(d, dim1=-2, dim2=-1)                 # [B,nc,H,L]
    gates = wkv_gate(cwe[..., :, None, :] - cwi[..., None, :, :])
    att = torch.zeros_like(d)
    p = torch.exp(cwe) * mm(ys, s_in.transpose(-1, -2))
    carry = torch.exp((cwl - cwe) - lws)
    q = carry * mm(vs, ds.transpose(-1, -2), exact, False)
    for a0, a1 in blocks:
        blk = slice(a0, a1)
        diag = tri[blk, blk]
        g = torch.where(diag[..., None], gates[..., blk, blk, :], 0.0)
        att[..., blk, blk] = torch.einsum("...ik,...jk,...ijk->...ij",
                                          rs[..., blk, :], ks[..., blk, :], g)
        db = torch.where(diag, d[..., blk, blk], 0.0)
        p[..., blk, :] += torch.einsum("...ij,...jk,...ijk->...ik", db,
                                       ks[..., blk, :], g)
        q[..., blk, :] += torch.einsum("...ij,...ik,...ijk->...jk", db,
                                       rs[..., blk, :], g)
        if a0 > 0:  # block a against the rows above it, anchored at a0
            c = cwe[..., a0:a0 + 1, :]
            khat = ks[..., :a0, :] * wkv_gate(c - cwi[..., :a0, :])
            e = wkv_gate(cwe[..., blk, :] - c)
            att[..., blk, :a0] = mm(rs[..., blk, :] * e,
                                    khat.transpose(-1, -2))
            p[..., blk, :] += e * mm(d[..., blk, :a0], khat)
            # Q of the blocks above, anchored at a0: the rows below.
            rhat = rs[..., a0:, :] * wkv_gate(cwe[..., a0:, :] - c)
            f = wkv_gate(c - cwi[..., a0 - 16:a0, :])
            q[..., a0 - 16:a0, :] += f * mm(
                d[..., a0:, a0 - 16:a0].transpose(-1, -2), rhat)
    beta = (rs * uf * ks).sum(-1)
    dv = (mm(carry * ks, ds) + mm(att.transpose(-1, -2), ys)
          + beta[..., None] * ys)
    bonus = uf * dd[..., None]
    dr, dk = p + bonus * ks, q + bonus * rs
    e, f = rs * p, -ks * q
    later = (e + f).flip(-2).cumsum(-2).flip(-2)
    later = torch.cat([later[..., 1:, :], torch.zeros_like(later[..., :1, :])],
                      -2)
    gl = (ds * s_out).sum(-1)[..., None, :]
    dlw = gl + f + later
    du = wkv_ref.sum_du_ref((dd[..., None] * rs * ks).sum(-2))

    def back(t):
        return t.transpose(2, 3).reshape(bsz, s, h, kd)

    return (back(dr).to(r.dtype), back(dk).to(r.dtype), back(dv).to(r.dtype),
            back(dlw), du)


def wkv_chunk_dstate_split_tf32_emulation(r, dy, lw, *, chunk, passes=3):
    """chunk_dstate's q = (r exp(cwe))^T dy in split TF32, per (b, chunk,
    head)."""
    bsz, s, h, kd = r.shape
    nc = s // chunk

    def heads(t):
        return t.float().reshape(bsz, nc, chunk, h, kd).transpose(2, 3)

    rs, ys, lws = (heads(t) for t in (r, dy, lw))
    cwe, _ = wkv_ref._prefix(lws.transpose(2, 3))
    return split_mm((rs * torch.exp(cwe.transpose(2, 3))).transpose(-1, -2),
                    ys, passes=passes)


def wkv_bwd_split_tf32(r, k, v, lw, u, dy, dsf, s0, *, chunk, passes=3):
    """The whole WKV backward with chunk_dstate and chunk_bwd emulated: the
    plain forward's scratch, the emulated q, state_pass_bwd_ref (float32 on
    the FMA pipes in the kernel), then chunk_bwd.  (dr, dk, dv, dlw, du,
    ds0)."""
    _, sf, cwl, s_in = wkv_ref.wkv6_ref(r, k, v, lw, u, chunk=chunk, s0=s0,
                                        keep=True)
    q = wkv_chunk_dstate_split_tf32_emulation(r, dy, lw, chunk=chunk,
                                              passes=passes)
    ds, ds0 = wkv_ref.state_pass_bwd_ref(q, cwl, dsf=dsf)
    return wkv_chunk_bwd_split_tf32_emulation(
        r, k, v, lw, u, dy, s_in, sf, ds, chunk=chunk, passes=passes) + (ds0,)


@pytest.fixture(scope="module")
def wkv_split_reference():
    """{case: (torch inputs (r, k, v, lw, u, s0, dy, dsf), jax.vjp's
    gradients)}: the inputs drawn as tests/test_torch_wkv_bwd.py draws them,
    and jax.vjp of the reference's wkv6_chunked (s0 and dsf zeros where the
    case has none), each compiled once here."""
    out = {}
    for n, case in enumerate(WKV_SPLIT_CASES):
        inputs = wkv_bwd_inputs(case, seed=60 + n)
        r, k, v, lw, u, s0, dy, dsf = inputs
        zeros = np.zeros((r.shape[0], r.shape[2], r.shape[3], r.shape[3]),
                         np.float32)
        _, vjp = jax.vjp(lambda *t: RR.wkv6_chunked(*t[:5], chunk=case[4],
                                                    s0=t[5]),
                         r, k, v, lw, u, zeros if s0 is None else s0)
        grads = vjp((jnp.asarray(dy),
                     jnp.asarray(zeros if dsf is None else dsf)))
        out[case] = ([wkv_bwd_torch(x) for x in inputs],
                     [np.asarray(g, np.float64) for g in grads])
    return out


def wkv_split_errors(case, inputs, want, passes=3):
    """{gradient: max abs error over its max} of the emulated backward; a
    bf16 dr, dk or dv may land one bf16 step (2^-7 of it) apart, as the
    plain version's may (tests/test_torch_wkv_bwd.py)."""
    r, k, v, lw, u, s0, dy, dsf = inputs
    got = wkv_bwd_split_tf32(r, k, v, lw, u, dy, dsf, s0, chunk=case[4],
                             passes=passes)
    errs = {}
    for name, g, w in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want):
        step = 2.0 ** -7 if g.dtype == torch.bfloat16 else 0.0
        g = g.float().numpy().astype(np.float64)
        diff = np.maximum(np.abs(g - w) - step * np.abs(w), 0.0)
        errs[name] = float(diff.max() / np.abs(w).max())
    return errs


@pytest.mark.parametrize("case", WKV_SPLIT_CASES, ids=WKV_SPLIT_IDS)
def test_wkv_bwd_split_tf32_matches_jax_vjp(wkv_split_reference, case):
    """chunk_dstate's and chunk_bwd's arithmetic (anchored 16-row blocks in
    split TF32, exact diagonal blocks), composed into the backward, within
    GRAD_TOL of jax.vjp's every gradient, strong decay included."""
    inputs, want = wkv_split_reference[case]
    errs = wkv_split_errors(case, inputs, want)
    assert all(e <= GRAD_TOL for e in errs.values()), errs


def test_wkv_bwd_single_tf32_leaves_the_tolerance(wkv_split_reference):
    """hi.hi alone (single TF32) leaves GRAD_TOL of jax.vjp on a float32
    case, at least ten times further off than the split: the lo passes
    carry the accuracy the tolerance asks for."""
    case = WKV_SPLIT_CASES[3]
    inputs, want = wkv_split_reference[case]
    split = max(wkv_split_errors(case, inputs, want).values())
    single = max(wkv_split_errors(case, inputs, want, passes=1).values())
    assert single > GRAD_TOL and single > 10 * split, (single, split)


def test_wkv_anchored_factors_are_at_most_one_under_strong_decay(
        wkv_split_reference):
    """Under lw down to -40 a step every anchored factor exp(cwe_i - c_a)
    (rows at or below the anchor's) and exp(c_a - cwi_j) (rows above it) is
    finite and at most 1, up to the prefix's rounding (a few ulps of |cwe|,
    which the reference's own gate keeps), and their product is the
    reference's gate exp(cwe_i - cwi_j) wherever that gate is above float32's
    floor: the two subtractions are exact where the one is."""
    case = WKV_SPLIT_CASES[3]
    r, k, v, lw, u, s0, dy, dsf = wkv_split_reference[case][0]
    chunk = case[4]
    bsz, s, h, kd = lw.shape
    lws = lw.reshape(bsz, s // chunk, chunk, h, kd)
    cwe, _ = wkv_ref._prefix(lws)
    cwi = cwe + lws
    assert float(lws.min()) < -39.0
    ulp = 2.0 ** (math.floor(math.log2(float(cwe.abs().max()))) - 23)
    checked = 0
    for a0 in range(16, chunk, 16):
        c = cwe[:, :, a0:a0 + 1]
        below, above = cwe[:, :, a0:] - c, c - cwi[:, :, :a0]
        for x in (below, above):
            assert float(x.max()) <= 4 * ulp
            f = wkv_gate(x)
            assert bool(torch.isfinite(f).all())
            assert float(f.max()) <= math.exp(4 * ulp)
        prod = (wkv_gate(below)[:, :, :, None]
                * wkv_gate(above)[:, :, None, :])
        gate = torch.exp(cwe[:, :, a0:, None] - cwi[:, :, None, :a0])
        live = gate > 1e-30
        assert torch.allclose(prod[live], gate[live], rtol=4e-6, atol=0)
        checked += int(live.sum())
    assert checked > 0

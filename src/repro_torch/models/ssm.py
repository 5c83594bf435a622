"""Mamba-2 (SSD) block for the zamba2 hybrid architecture.

The port of ``repro.models.ssm``.  State-space recurrence per head (scalar
decay a_t, state N, head dim P):
    h_t = a_t * h_{t-1} + dt_t * B_t ⊗ x_t          h: [P, N]
    y_t = C_t · h_t + D * x_t
with a_t = exp(-softplus(dt_raw_t + dt_bias) * A_head).

The sequence path is the chunked SSD scan (:func:`ssd_chunked`): the
``mamba2_ssd`` kernel on the card, its plain version (the reference's
``ssd_chunked``) on the CPU; it returns the final state, which fills the
decode cache.  Under a gradient it is an autograd Function whose backward
is ``mamba2_ssd_bwd`` (the backward kernels on the card, their plain
version on the CPU).  Prefill and decode take the step dt and the decay a
from one kernel (``step_and_decay``) in the reference's float32 roundings:
the scan sums the log decay in the reference's order, where the prefix
reaches thousands under strong decay; its backward is
``step_and_decay_bwd``.  Decode is the one-step recurrence carrying (conv
window, state).  ``ssd_reference`` is the sequential oracle of the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.mamba2.ops import (mamba2_ssd, mamba2_ssd_bwd, step_and_decay,
                                  step_and_decay_bwd)
from .layers import Init, linear, linear_init, rmsnorm, rmsnorm_init


def mamba2_init(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_d_inner
    n = cfg.ssm_state
    heads = di // cfg.ssm_head_dim
    # in_proj -> [z (di), x (di), B (n), C (n), dt (heads)]
    d_in_proj = 2 * di + 2 * n + heads
    return {
        "in_proj": linear_init(d, d_in_proj),
        "conv_w": Init("normal", (cfg.ssm_conv, di + 2 * n),
                       cfg.ssm_conv ** -0.5),
        "conv_b": Init("zeros", (di + 2 * n,)),
        "a_log": Init("log_linspace", (heads,), value=16.0, dtype="float32"),
        "dt_bias": Init("zeros", (heads,), dtype="float32"),
        "d_skip": Init("ones", (heads,), dtype="float32"),
        "norm": rmsnorm_init(di),
        "out_proj": linear_init(di, d),
    }


def _split_proj(cfg, zxbcdt):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(w, b, xbc, conv_state=None):
    """Depthwise short conv over time. xbc: [B,S,D]; returns same + new state.

    A sum of shifted products in xbc's dtype, in the reference's order
    ``t0 + t1 + ... + t(k-1)``; not ``F.conv1d``, which runs float32 in TF32
    through cuDNN on the card and sums in another order."""
    k = w.shape[0]
    s = xbc.shape[1]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i][None, None, :]
    out = F.silu(out + b[None, None, :])
    new_state = xp[:, -(k - 1):].clone() if k > 1 else pad
    return out, new_state


class _StepDecay(torch.autograd.Function):
    """``step_and_decay`` under a gradient: the forward is the kernel or
    its plain version (the reference's roundings, which read float32 bits
    and so have no autograd of their own), the backward
    ``step_and_decay_bwd`` (a kernel on the card): the exact derivatives
    dt' = sigmoid(dt_raw + dt_bias), da/ddt = -e a and da/da_log = -dt e a
    with e = exp(a_log)."""

    @staticmethod
    def forward(ctx, dt_raw, dt_bias, a_log):
        dt, a = step_and_decay(dt_raw, dt_bias, a_log)
        ctx.save_for_backward(dt_raw, dt_bias, a_log, dt, a)
        return dt, a

    @staticmethod
    def backward(ctx, g_dt, g_a):
        dt_raw, dt_bias, a_log, dt, a = ctx.saved_tensors
        return step_and_decay_bwd(g_dt, g_a, dt_raw, dt_bias, a_log, dt, a)


def _step_and_decay(dt_raw, dt_bias, a_log):
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (dt_raw, dt_bias, a_log)):
        return _StepDecay.apply(dt_raw, dt_bias, a_log)
    return step_and_decay(dt_raw, dt_bias, a_log)


class _SSD(torch.autograd.Function):
    """``mamba2_ssd`` under a gradient.  The forward keeps the scratch its
    passes leave (the in-chunk prefix sums of the log decay and the state
    entering each chunk), so the backward ``mamba2_ssd_bwd`` does not run
    the forward's passes again: under remat "block" the forward already
    runs twice, and the scratch lives only while its block's backward
    does."""

    @staticmethod
    def forward(ctx, x, a, b, c, h0, chunk):
        y, hf, cum, h_in = mamba2_ssd(x, a, b, c, chunk=chunk, h0=h0,
                                      keep=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, a, b, c, h0, cum, h_in)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dhf):
        x, a, b, c, h0, cum, h_in = ctx.saved_tensors
        dx, da, db, dc, dh0 = mamba2_ssd_bwd(x, a, b, c, dy, dhf,
                                             chunk=ctx.chunk, cum=cum,
                                             h_in=h_in)
        return dx, da, db, dc, (dh0 if h0 is not None else None), None


def ssd_chunked(x, a, b, c, dt=None, *, chunk: int, h0=None):
    """Chunked SSD scan.

    x: [B,S,H,P] (dt-scaled inputs), a: [B,S,H] per-step decay in (0,1],
    b,c: [B,S,N] (shared across heads, Mamba-2 style), dt is already folded
    into x (unused, as in the reference: it gets no gradient). Returns (y
    [B,S,H,P], h_final [B,H,P,N]), float32: the ``mamba2_ssd`` kernel for
    CUDA tensors, its plain version for CPU tensors; under a gradient
    through ``_SSD``, whose backward is the backward kernels on the card."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, b, c, h0)):
        return _SSD.apply(x, a, b, c, h0, chunk)
    return mamba2_ssd(x, a, b, c, chunk=chunk, h0=h0)


def mamba2_forward(params, cfg, x, *, chunk: int = 128, return_state=False):
    """x: [B, S, d] -> [B, S, d]."""
    bsz, s, _ = x.shape
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    hd = cfg.ssm_head_dim
    heads = di // hd
    z, xbc, dt_raw = _split_proj(cfg, linear(params["in_proj"], x))
    xbc, conv_state = _causal_conv(params["conv_w"], params["conv_b"], xbc)
    xi = xbc[..., :di].reshape(bsz, s, heads, hd)
    b = xbc[..., di:di + n]
    c = xbc[..., di + n:]
    dt, a = _step_and_decay(dt_raw, params["dt_bias"],
                            params["a_log"])                      # [B,S,H]
    xin = xi.float() * dt[..., None]
    pad = (-s) % chunk
    if pad:
        # The tail decays by a = 1 and adds x = 0: the final state is exact.
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    y, hf = ssd_chunked(xin, a, b, c, dt, chunk=chunk)
    y = y[:, :s]
    y = y + xi.float() * params["d_skip"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = linear(params["out_proj"], y)
    if return_state:
        return out, {"h": hf, "conv": conv_state}
    return out


def mamba2_decode(params, cfg, x, state, pos=None):
    """One-token decode. x: [B,1,d]; state: {h: [B,H,P,N], conv: [B,k-1,D]}.
    Returns (y, new state); ``state`` is read, not written."""
    bsz = x.shape[0]
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    hd = cfg.ssm_head_dim
    heads = di // hd
    z, xbc, dt_raw = _split_proj(cfg, linear(params["in_proj"], x))
    xbc, conv_state = _causal_conv(params["conv_w"], params["conv_b"], xbc,
                                   conv_state=state["conv"])
    xi = xbc[:, 0, :di].reshape(bsz, heads, hd).float()
    b = xbc[:, 0, di:di + n].float()
    c = xbc[:, 0, di + n:].float()
    dt, a = step_and_decay(dt_raw[:, 0], params["dt_bias"],
                           params["a_log"])                       # [B,H]
    h = state["h"] * a[:, :, None, None] \
        + xi[..., None] * b[:, None, None, :] * dt[:, :, None, None]
    y = torch.einsum("bhpn,bn->bhp", h, c)
    y = y + xi * params["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return linear(params["out_proj"], y), {"h": h, "conv": conv_state}


def ssd_reference(x, a, b, c):
    """O(S) sequential oracle for tests. Shapes as in ssd_chunked."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    x, a, b, c = (t.float() for t in (x, a, b, c))
    ys = []
    for t in range(s):
        hprev = hprev * a[:, t, :, None, None] \
            + torch.einsum("bhp,bn->bhpn", x[:, t], b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", hprev, c[:, t]))
    return torch.stack(ys, dim=1), hprev

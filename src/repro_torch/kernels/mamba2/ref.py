"""Plain PyTorch version of the Mamba-2 SSD scan kernel, pass by pass.

The reference's ``repro.models.ssm.ssd_chunked`` in the three passes the
kernel runs (``csrc/mamba2_ssd.cu``): the log decay ``la = log(max(a,
1e-20))`` is summed within each chunk into ``cum`` (in float32, in the
order XLA's CPU code sums a prefix: :mod:`repro_torch.core.ordered`); ``chunk_state_ref``
forms each chunk's own state ``sum_j exp(cum_{L-1} - cum_j) x_j (x) B_j``,
kept transposed (``[N, P]`` per head, the layout the kernel's last pass
reads); ``state_pass_ref`` carries the state from chunk to chunk
(``h <- exp(cum_{L-1}) h + s_c``); ``chunk_scan_ref`` adds the intra-chunk
term ``sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) x_j`` (the exponent masked
to -inf above the diagonal before the exponential, never factored into
``exp(cum_i) * exp(-cum_j)``, which overflows under strong decay) to the
inter-chunk term ``exp(cum_i) C_i . h`` from the state entering the chunk.
``mamba2_ssd_ref`` composes them.  The CPU path of ``ops.mamba2_ssd`` runs
it; on the card it is only the comparison the kernel is held to.
``step_and_decay_ref`` is the plain version of the kernel that computes
the scan's step and decay from the projection (``ops.step_and_decay``),
``step_and_decay_bwd_ref`` that of its backward.

The backward (``mamba2_ssd_bwd_ref``, the gradient the reference takes
with ``jax.vjp`` of ``ssd_chunked``) runs in the kernel's passes:
``chunk_dstate_ref`` forms each chunk's ``sum_i exp(cum_i) dy_i (x) C_i``,
``state_pass_bwd_ref`` carries the state's gradient backwards over the
chunks (``R <- exp(cum_{L-1}) R + q_c`` from ``dh_final``; ``dh0`` is the
last), and ``chunk_bwd_ref`` gives dx, the decay's gradient and dB, dC
summed over heads (``csrc/mamba2_ssd.cu`` has the formulas).
"""
from __future__ import annotations

import torch

from ...core.ordered import ordered_cumsum
from ...core.prng import exp_f32, softplus_f32


def step_and_decay_ref(dt_raw, dt_bias, a_log):
    """(dt = softplus(dt_raw + dt_bias), the decay a = exp(-dt exp(a_log))),
    float32 of ``dt_raw``'s shape [..., H], each transcendental rounded as
    the reference's compiled code rounds it (:mod:`repro_torch.core.prng`).
    The scan sums the log decay in the reference's order, where the prefix
    reaches thousands under strong decay, so a decay rounded apart moves
    the states."""
    dt = softplus_f32(dt_raw.float() + dt_bias)
    return dt, exp_f32(-dt * exp_f32(a_log))


def step_and_decay_bwd_ref(g_dt, g_a, dt_raw, dt_bias, a_log, dt, a):
    """(g_dt_raw in ``dt_raw``'s dtype, g_dt_bias [H], g_a_log [H]) from the
    gradients ``g_dt``, ``g_a`` of the outputs (dt, a) of
    ``step_and_decay_ref``: the exact derivatives dt' = sigmoid(dt_raw +
    dt_bias), da/ddt = -e a and da/da_log = -dt e a with e = exp(a_log),
    summed over the leading axes for the [H] parameters."""
    e = torch.exp(a_log)
    g_step = g_a * a * -e                   # d loss / d dt through a
    g_z = (g_dt + g_step) * torch.sigmoid(dt_raw.float() + dt_bias)
    lead = tuple(range(g_z.dim() - 1))
    return (g_z.to(dt_raw.dtype), g_z.sum(dim=lead),
            (g_step * dt).sum(dim=lead))


def chunk_state_ref(x, a, b, *, chunk: int):
    """x [B,S,H,P] (dt-scaled), a [B,S,H] decay in (0, 1], b [B,S,N]; S a
    multiple of ``chunk``.  Returns (cum [B,nc,H,L], the in-chunk inclusive
    prefix sums of the log decay; states [B,nc,H,N,P], each chunk's own
    state, transposed), float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    la = torch.log(torch.clamp_min(a.float(), 1e-20)).reshape(bsz, nc, chunk, h)
    cum = ordered_cumsum(la.movedim(2, -1)).movedim(-1, 2)        # [B,nc,L,H]
    w = torch.exp(cum[:, :, -1:] - cum)                           # [B,nc,L,H]
    xs = x.float().reshape(bsz, nc, chunk, h, p)
    bs = b.float().reshape(bsz, nc, chunk, n)
    states = torch.einsum("bcjhp,bcjn->bchnp", xs * w[..., None], bs)
    return cum.transpose(2, 3).contiguous(), states.contiguous()


def state_pass_ref(states, cum, *, h0=None):
    """states [B,nc,H,N,P] (each chunk's own, transposed), cum [B,nc,H,L],
    h0 [B,H,P,N] or None (zeros).  Overwrites ``states`` with the state
    entering each chunk, as the kernel does; returns (states, h_final
    [B,H,P,N])."""
    bsz, nc, h, n, p = states.shape
    tot = torch.exp(cum[..., -1])                                 # [B,nc,H]
    hcur = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                        device=states.device) if h0 is None
            else h0.float().transpose(-1, -2))
    for ci in range(nc):
        own = states[:, ci].clone()
        states[:, ci] = hcur
        hcur = hcur * tot[:, ci, :, None, None] + own
    return states, hcur.transpose(-1, -2).contiguous()


def chunk_scan_ref(x, b, c, cum, h_in, *, chunk: int):
    """x [B,S,H,P], b/c [B,S,N], cum [B,nc,H,L], h_in [B,nc,H,N,P] (the state
    entering each chunk, transposed).  Returns y [B,S,H,P], float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xs = x.float().reshape(bsz, nc, chunk, h, p)
    bs = b.float().reshape(bsz, nc, chunk, n)
    cs = c.float().reshape(bsz, nc, chunk, n)
    cumt = cum.transpose(2, 3)                                    # [B,nc,L,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[:, :, None]
    rel = cumt[:, :, :, None, :] - cumt[:, :, None, :, :]         # [B,nc,L,L,H]
    g = torch.exp(torch.where(tri, rel, -torch.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cs, bs)                  # [B,nc,L,L]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * g, xs)
    y_inter = (torch.einsum("bcin,bchnp->bcihp", cs, h_in)
               * torch.exp(cumt)[..., None])
    return (y_intra + y_inter).reshape(bsz, s, h, p)


def mamba2_ssd_ref(x, a, b, c, *, chunk: int, h0=None, keep=False):
    """x [B,S,H,P] (dt-scaled), a [B,S,H] decay in (0, 1], b/c [B,S,N]
    (shared across heads), h0 [B,H,P,N] or None; S a multiple of ``chunk``.
    Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32, and with
    ``keep`` also (cum, the state entering each chunk), as the backward
    takes them."""
    cum, states = chunk_state_ref(x, a, b, chunk=chunk)
    h_in, hf = state_pass_ref(states, cum, h0=h0)
    y = chunk_scan_ref(x, b, c, cum, h_in, chunk=chunk)
    return (y, hf, cum, h_in) if keep else (y, hf)


def chunk_dstate_ref(dy, c, cum, *, chunk: int):
    """dy [B,S,H,P], c [B,S,N], cum [B,nc,H,L].  Returns q [B,nc,H,N,P]:
    each chunk's sum_i exp(cum_i) dy_i (x) C_i, transposed, float32."""
    bsz, s, h, p = dy.shape
    n = c.shape[-1]
    nc = s // chunk
    ys = dy.float().reshape(bsz, nc, chunk, h, p)
    cs = c.float().reshape(bsz, nc, chunk, n)
    e = torch.exp(cum.transpose(2, 3))                            # [B,nc,L,H]
    return torch.einsum("bcihp,bcin->bchnp", ys * e[..., None],
                        cs).contiguous()


def state_pass_bwd_ref(q, cum, *, dhf=None):
    """q [B,nc,H,N,P] (``chunk_dstate_ref``), cum [B,nc,H,L], dhf
    [B,H,P,N] or None (zeros).  Overwrites ``q`` with the gradient of the
    state leaving each chunk, as the kernel does; returns (q, dh0
    [B,H,P,N])."""
    bsz, nc, h, n, p = q.shape
    tot = torch.exp(cum[..., -1])                                 # [B,nc,H]
    r = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=q.device)
         if dhf is None else dhf.float().transpose(-1, -2))
    for ci in reversed(range(nc)):
        own = q[:, ci].clone()
        q[:, ci] = r
        r = r * tot[:, ci, :, None, None] + own
    return q, r.transpose(-1, -2).contiguous()


def chunk_bwd_ref(x, a, b, c, dy, cum, h_in, r, *, chunk: int):
    """The gradients within each chunk from x [B,S,H,P], a [B,S,H], b/c
    [B,S,N], dy [B,S,H,P], cum [B,nc,H,L], h_in (the state entering each
    chunk) and r (the gradient of the state leaving it), both [B,nc,H,N,P]
    transposed.  Returns (dx [B,S,H,P], da [B,S,H] float32, db, dc [B,S,N]
    in b's dtype)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xs = x.float().reshape(bsz, nc, chunk, h, p)
    ys = dy.float().reshape(bsz, nc, chunk, h, p)
    bs = b.float().reshape(bsz, nc, chunk, n)
    cs = c.float().reshape(bsz, nc, chunk, n)
    cumt = cum.transpose(2, 3)                                    # [B,nc,L,H]
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    tri = torch.tril(ones)[:, :, None]
    below = torch.tril(ones, -1)[:, :, None]
    rel = cumt[:, :, :, None, :] - cumt[:, :, None, :, :]         # [B,nc,L,L,H]
    g = torch.exp(torch.where(tri, rel, -torch.inf))
    e = torch.exp(cumt)                                           # exp(cum_i)
    w = torch.exp(cumt[:, :, -1:] - cumt)                         # [B,nc,L,H]
    cb = torch.einsum("bcin,bcjn->bcij", cs, bs)                  # [B,nc,L,L]
    d = torch.einsum("bcihp,bcjhp->bcijh", ys, xs)                # dy_i . x_j
    m1 = cb[..., None] * g
    m2 = d * g
    t = torch.where(below, m1 * d, 0.0)
    rb = torch.einsum("bchnp,bcjn->bcjhp", r, bs)                 # R B_j
    dx = torch.einsum("bcijh,bcihp->bcjhp", m1, ys) + w[..., None] * rb
    sdy = torch.einsum("bchnp,bcihp->bcihn", h_in, ys)            # S^T dy_i
    dc = (torch.einsum("bcijh,bcjn->bcin", m2, bs)
          + torch.einsum("bcih,bcihn->bcin", e, sdy))
    rx = torch.einsum("bchnp,bcjhp->bcjhn", r, xs)                # R^T x_j
    db = (torch.einsum("bcijh,bcin->bcjn", m2, cs)
          + torch.einsum("bcjh,bcjhn->bcjn", w, rx))
    u = w * torch.einsum("bcjhp,bcjhp->bcjh", xs, rb)
    dcum = (t.sum(3) - t.sum(2) + e * torch.einsum("bcihn,bcin->bcih", sdy, cs)
            - u)
    tail = e[:, :, -1] * torch.einsum("bchnp,bchnp->bch", r, h_in) + u.sum(2)
    dcum[:, :, -1] += tail
    dla = dcum.flip(2).cumsum(2).flip(2).reshape(bsz, s, h)
    af = a.float()
    floor = torch.tensor(1e-20, dtype=torch.float32)
    da = torch.where(af > floor, dla / af,
                     torch.where(af == floor, 0.5 * (dla / af), 0.0))
    return (dx.reshape(bsz, s, h, p), da, db.reshape(bsz, s, n).to(b.dtype),
            dc.reshape(bsz, s, n).to(c.dtype))


def mamba2_ssd_bwd_ref(x, a, b, c, dy, dhf=None, *, chunk: int, cum, h_in):
    """The gradient of ``mamba2_ssd_ref``'s (y, h_final) with respect to
    (x, a, b, c, h0), given dy [B,S,H,P], dhf [B,H,P,N] (None: zeros) and
    the forward's ``cum`` and ``h_in`` (``keep=True``; h0 entered them).
    ``h_in`` may be the kernel's, with N and P zero-padded to multiples of
    4 (``ops.kernel_layout``).  Returns (dx, da float32, db, dc in b's
    dtype, dh0 float32)."""
    h_in = h_in[..., :c.shape[-1], :x.shape[-1]]
    q = chunk_dstate_ref(dy, c, cum, chunk=chunk)
    r, dh0 = state_pass_bwd_ref(q, cum, dhf=dhf)
    dx, da, db, dc = chunk_bwd_ref(x, a, b, c, dy, cum, h_in, r, chunk=chunk)
    return dx, da, db, dc, dh0

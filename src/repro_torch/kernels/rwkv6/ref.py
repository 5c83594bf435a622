"""Plain PyTorch version of the RWKV-6 WKV kernel, pass by pass.

The reference's ``repro.models.rwkv.wkv6_chunked`` in the three passes the
kernel runs (``csrc/wkv6.cu``): per chunk, the exclusive prefix ``cwe =
cumsum(lw) - lw`` of the log decay and its total ``cwl = cwe_{L-1} +
lw_{L-1}``; ``chunk_state_ref`` forms each chunk's own state ``sum_j
exp(cwl - cwe_j - lw_j) k_j (x) v_j`` (k-major); ``state_pass_ref``
carries the state from chunk to chunk (``S <- exp(cwl) S + d_c``);
``chunk_scan_ref`` adds the strictly lower intra-chunk term with
per-channel decay ``exp(cwe_i - (cwe_j + lw_j))`` (masked to -inf on and
above the diagonal before the exponential), the ``u`` bonus on the
diagonal and the inter-chunk term ``(r * exp(cwe)) . S`` from the state
entering the chunk.  ``wkv6_ref`` composes them.  The CPU path of
``ops.wkv6`` runs it; on the card it is only the comparison the kernel is
held to.

The backward, in the four passes the kernel runs, with dS' the gradient of
the state leaving a chunk and S' that state: ``chunk_dstate_ref`` forms
each chunk's ``q = sum_i (r_i * exp(cwe_i)) (x) dy_i``;
``state_pass_bwd_ref`` carries dS' back from chunk to chunk (``dS <-
exp(cwl) dS' + q``, from the final state's gradient), the last one being
the initial state's gradient; ``chunk_bwd_ref`` takes dr, dk, dv, dlw and
du within each chunk; ``sum_du_ref`` sums du over the batch and the chunks
in the kernel's order.  Within a chunk, with G_ijk = exp(cwe_ik - cwi_jk)
for j < i (cwi = cwe + lw), D_ij = dy_i . v_j and A, beta the forward's
attention and bonus:
    dv_j = sum_{i>j} A_ij dy_i + beta_j dy_j
           + sum_k exp(cwl_k - cwi_jk) k_jk dS'_k
    P_ik = sum_{j<i} D_ij k_jk G_ijk + exp(cwe_ik) (S_k . dy_i)
    Q_jk = sum_{i>j} D_ij r_ik G_ijk + exp(cwl_k - cwi_jk) (dS'_k . v_j)
    dr = P + u k D_ii,  dk = Q + u r D_jj,  du = sum r k D_ii
    dlw_m = <dS'_k, S'_k> - k_m Q_m + sum_{i>m} (r_i P_i - k_i Q_i)
(the gradients through cwe, cwi and cwl are r P, -k Q and <dS', S'>; the
last sums exp(cwl) <S, dS'> and the state terms of Q).  Every exponent is
a difference of prefix sums that is <= 0 where it is used.
"""
from __future__ import annotations

import torch

from ...core.ordered import ordered_cumsum


def _chunks(t, chunk):
    """[B, S, H, K] -> float32 [B, nc, L, H, K]."""
    bsz, s, h, kd = t.shape
    return t.float().reshape(bsz, s // chunk, chunk, h, kd)


def _prefix(lws):
    """(cwe, cwl) of [B, nc, L, H, K] log decays, the prefix sums in float32
    in XLA CPU's order (:mod:`repro_torch.core.ordered`)."""
    cwe = ordered_cumsum(lws.movedim(2, -1)).movedim(-1, 2) - lws
    return cwe, cwe[:, :, -1] + lws[:, :, -1]


def chunk_state_ref(k, v, lw, *, chunk: int):
    """k, v [B,S,H,K], lw [B,S,H,K] log decay (<= 0); S a multiple of
    ``chunk``.  Returns (cwl [B,nc,H,K], each chunk's total log decay;
    states [B,nc,H,K,K], each chunk's own state, k-major), float32."""
    ks, vs, lws = (_chunks(t, chunk) for t in (k, v, lw))
    cwe, cwl = _prefix(lws)
    carry = torch.exp(cwl[:, :, None] - cwe - lws)             # [B,nc,L,H,K]
    states = torch.einsum("bcjhk,bcjhv->bchkv", carry * ks, vs)
    return cwl.contiguous(), states.contiguous()


def state_pass_ref(states, cwl, *, s0=None):
    """states [B,nc,H,K,K] (each chunk's own), cwl [B,nc,H,K], s0 [B,H,K,K]
    or None (zeros).  Overwrites ``states`` with the state entering each
    chunk, as the kernel does; returns (states, final state [B,H,K,K])."""
    bsz, nc, h, kd, _ = states.shape
    wdec = torch.exp(cwl)                                      # [B,nc,H,K]
    sprev = (torch.zeros((bsz, h, kd, kd), dtype=torch.float32,
                         device=states.device) if s0 is None else s0.float())
    for ci in range(nc):
        own = states[:, ci].clone()
        states[:, ci] = sprev
        sprev = sprev * wdec[:, ci, ..., None] + own
    return states, sprev


def chunk_scan_ref(r, k, v, lw, u, s_in, *, chunk: int):
    """r, k, v, lw [B,S,H,K], u [H,K], s_in [B,nc,H,K,K] (the state entering
    each chunk).  Returns y [B,S,H,K], float32.  The chunks are independent;
    they run one at a time, which bounds the [B,L,L,H,K] gate."""
    bsz, s, h, kd = r.shape
    rs, ks, vs, lws = (_chunks(t, chunk) for t in (r, k, v, lw))
    uf = u.float()
    cwe_all, _ = _prefix(lws)
    tri_lo = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    tri_lo = tri_lo[None, :, :, None, None]
    ys = []
    for ci in range(s // chunk):
        rc, kc, vc, lwc = rs[:, ci], ks[:, ci], vs[:, ci], lws[:, ci]
        cwe = cwe_all[:, ci]                                # [B,L,H,K]
        rel = cwe[:, :, None] - (cwe + lwc)[:, None, :]     # [B,L,L,H,K]
        gate = torch.exp(torch.where(tri_lo, rel, -torch.inf))
        att = torch.einsum("bijhk,bijhk->bijh",
                           (rc[:, :, None] * kc[:, None, :]), gate)
        y = torch.einsum("bijh,bjhv->bihv", att, vc)
        bonus = torch.einsum("bihk,bihk->bih", rc * uf, kc)
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cwe),
                             s_in[:, ci])
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(bsz, s, h, kd)


def wkv6_ref(r, k, v, lw, u, *, chunk: int, s0=None, keep: bool = False):
    """r, k, v [B,S,H,K], lw [B,S,H,K] log decay (<= 0), u [H,K], s0
    [B,H,K,K] or None; S a multiple of ``chunk``.  Returns (y [B,S,H,K],
    final state [B,H,K,K] k-major), both float32, and with ``keep`` also
    (cwl, the state entering each chunk), as the backward takes them."""
    cwl, states = chunk_state_ref(k, v, lw, chunk=chunk)
    s_in, sf = state_pass_ref(states, cwl, s0=s0)
    y = chunk_scan_ref(r, k, v, lw, u, s_in, chunk=chunk)
    return (y, sf, cwl, s_in) if keep else (y, sf)


def chunk_dstate_ref(r, dy, lw, *, chunk: int):
    """r [B,S,H,K], dy [B,S,H,K] float32, lw [B,S,H,K].  Returns q
    [B,nc,H,K,K]: each chunk's sum_i (r_i * exp(cwe_i)) (x) dy_i, k-major,
    float32."""
    rs, ys, lws = (_chunks(t, chunk) for t in (r, dy, lw))
    cwe, _ = _prefix(lws)
    return torch.einsum("bcihk,bcihv->bchkv", rs * torch.exp(cwe),
                        ys).contiguous()


def state_pass_bwd_ref(q, cwl, *, dsf=None):
    """q [B,nc,H,K,K] (``chunk_dstate_ref``), cwl [B,nc,H,K], dsf [B,H,K,K]
    or None (zeros).  Overwrites ``q`` with the gradient of the state
    leaving each chunk, as the kernel does; returns (q, the initial state's
    gradient [B,H,K,K])."""
    bsz, nc, h, kd, _ = q.shape
    wdec = torch.exp(cwl)                                      # [B,nc,H,K]
    g = (torch.zeros((bsz, h, kd, kd), dtype=torch.float32, device=q.device)
         if dsf is None else dsf.float())
    for ci in reversed(range(nc)):
        own = q[:, ci].clone()
        q[:, ci] = g
        g = g * wdec[:, ci, ..., None] + own
    return q, g


def sum_du_ref(part):
    """du [H,K] from the per-chunk partials [B,nc,H,K]: summed one partial
    at a time over (b, chunk) in ascending order, in float32, as the
    kernel sums them."""
    du = torch.zeros(part.shape[2:], dtype=torch.float32, device=part.device)
    for p in part.reshape(-1, *part.shape[2:]):
        du = du + p
    return du


def chunk_bwd_ref(r, k, v, lw, u, dy, s_in, sf, ds, *, chunk: int):
    """The gradients within each chunk from the forward's inputs, dy
    [B,S,H,K] float32, the state entering each chunk ``s_in`` and the
    gradient of the state leaving it ``ds`` (both [B,nc,H,K,K], k-major)
    and the final state ``sf`` [B,H,K,K] (the state leaving the last
    chunk).  Returns (dr, dk, dv in r's dtype, dlw float32 [B,S,H,K], du
    [H,K] float32).  The chunks run one at a time, which bounds the
    [B,L,L,H,K] gate."""
    bsz, s, h, kd = r.shape
    nc = s // chunk
    rs, ks, vs, lws, ys = (_chunks(t, chunk) for t in (r, k, v, lw, dy))
    uf = u.float()
    cwe_all, _ = _prefix(lws)
    tri_lo = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    tri5 = tri_lo[None, :, :, None, None]
    outs, parts = [], []
    for ci in range(nc):
        rc, kc, vc, lwc, yc = (t[:, ci] for t in (rs, ks, vs, lws, ys))
        cwe = cwe_all[:, ci]                                # [B,L,H,K]
        cwi = cwe + lwc
        cwl = cwi[:, -1]                                    # [B,H,K]
        s_c, ds_c = s_in[:, ci], ds[:, ci]
        s_out = s_in[:, ci + 1] if ci + 1 < nc else sf
        rel = cwe[:, :, None] - cwi[:, None, :]             # [B,L,L,H,K]
        gate = torch.exp(torch.where(tri5, rel, -torch.inf))
        d = torch.einsum("bihv,bjhv->bijh", yc, vc)         # dy_i . v_j
        dd = torch.diagonal(d, dim1=1, dim2=2).movedim(-1, 1)  # [B,L,H]
        d = torch.where(tri_lo[None, :, :, None], d, 0.0)
        att = torch.einsum("bihk,bjhk,bijhk->bijh", rc, kc, gate)
        beta = torch.einsum("bihk,hk,bihk->bih", rc, uf, kc)
        # exp(cwl - cwe - lw) in chunk_state_ref's (and the reference's)
        # order: under strong decay |cwe| reaches ~1300, and an ulp of a
        # prefix of that size moves the gate by ~1e-4.
        carry = torch.exp(cwl[:, None] - cwe - lwc)         # [B,L,H,K]
        dv = (torch.einsum("bijh,bihv->bjhv", att, yc) + beta[..., None] * yc
              + torch.einsum("bjhk,bhkv->bjhv", carry * kc, ds_c))
        p = (torch.einsum("bijh,bjhk,bijhk->bihk", d, kc, gate)
             + torch.exp(cwe) * torch.einsum("bhkv,bihv->bihk", s_c, yc))
        q = (torch.einsum("bijh,bihk,bijhk->bjhk", d, rc, gate)
             + carry * torch.einsum("bhkv,bjhv->bjhk", ds_c, vc))
        bonus = uf * dd[..., None]
        dr = p + bonus * kc
        dk = q + bonus * rc
        e, f = rc * p, -kc * q
        later = (e + f).flip(1).cumsum(1).flip(1)           # sum_{i>=m}
        later = torch.cat([later[:, 1:], torch.zeros_like(later[:, :1])], 1)
        gl = torch.einsum("bhkv,bhkv->bhk", ds_c, s_out)
        dlw = gl[:, None] + f + later
        parts.append(torch.einsum("bih,bihk->bhk", dd, rc * kc))
        outs.append((dr, dk, dv, dlw))
    dr, dk, dv, dlw = (torch.stack(t, dim=1).reshape(bsz, s, h, kd)
                       for t in zip(*outs))
    du = sum_du_ref(torch.stack(parts, dim=1))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dlw, du)


def wkv6_bwd_ref(r, k, v, lw, u, dy, dsf=None, *, chunk: int, cwl, s_in,
                 sf):
    """The gradient of ``wkv6_ref``'s (y, final state) with respect to (r,
    k, v, lw, u, s0), given dy [B,S,H,K] and dsf [B,H,K,K] (float32; None:
    zeros) and the forward's scratch ``cwl`` and ``s_in`` (``keep=True``;
    s0 entered them) and its final state ``sf``.  ``cwl``, ``s_in`` and
    ``sf`` may be the kernel's, with K zero-padded (``ops.kernel_layout``).
    Returns (dr, dk, dv in r's dtype, dlw float32, du [H,K] float32, ds0
    [B,H,K,K] float32)."""
    kd = r.shape[-1]
    cwl, s_in = cwl[..., :kd].contiguous(), s_in[..., :kd, :kd]
    sf = sf[..., :kd, :kd]
    q = chunk_dstate_ref(r, dy, lw, chunk=chunk)
    ds, ds0 = state_pass_bwd_ref(q, cwl, dsf=dsf)
    dr, dk, dv, dlw, du = chunk_bwd_ref(r, k, v, lw, u, dy, s_in, sf, ds,
                                        chunk=chunk)
    return dr, dk, dv, dlw, du, ds0

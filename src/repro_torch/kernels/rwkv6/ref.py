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


def wkv6_ref(r, k, v, lw, u, *, chunk: int, s0=None):
    """r, k, v [B,S,H,K], lw [B,S,H,K] log decay (<= 0), u [H,K], s0
    [B,H,K,K] or None; S a multiple of ``chunk``.  Returns (y [B,S,H,K],
    final state [B,H,K,K] k-major), both float32."""
    cwl, states = chunk_state_ref(k, v, lw, chunk=chunk)
    s_in, sf = state_pass_ref(states, cwl, s0=s0)
    return chunk_scan_ref(r, k, v, lw, u, s_in, chunk=chunk), sf

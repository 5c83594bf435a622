"""Plain PyTorch version of the RWKV-6 WKV kernel.

The reference's ``repro.models.rwkv.wkv6_chunked``, operation for
operation: per chunk, the exclusive prefix ``cwe = cumsum(lw) - lw`` of the
log decay, the strictly lower intra-chunk term with per-channel decay
``exp(cwe_i - (cwe_j + lw_j))`` (masked to -inf on and above the diagonal
before the exponential), the ``u`` bonus on the diagonal, the inter-chunk
term ``(r * exp(cwe)) . S`` from the carried ``[B, H, K, K]`` state, and the
state update.  The CPU path of ``ops.wkv6`` runs it; on the card it is only
the comparison the kernel is held to.
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, lw, u, *, chunk: int, s0=None):
    """r, k, v [B,S,H,K], lw [B,S,H,K] log decay (<= 0), u [H,K], s0
    [B,H,K,K] or None; S a multiple of ``chunk``.  Returns (y [B,S,H,K],
    final state [B,H,K,K] k-major), both float32."""
    bsz, s, h, kd = r.shape
    nc = s // chunk
    rs, ks, vs, lws = (t.float().reshape(bsz, nc, chunk, h, kd)
                       for t in (r, k, v, lw))
    uf = u.float()
    sprev = (torch.zeros((bsz, h, kd, kd), dtype=torch.float32,
                         device=r.device) if s0 is None else s0.float())
    tri_lo = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    tri_lo = tri_lo[None, :, :, None, None]
    ys = []
    for ci in range(nc):
        rc, kc, vc, lwc = rs[:, ci], ks[:, ci], vs[:, ci], lws[:, ci]
        cwe = torch.cumsum(lwc, dim=1) - lwc                # [B,L,H,K]
        cwl = cwe[:, -1] + lwc[:, -1]                       # [B,H,K]
        rel = cwe[:, :, None] - (cwe + lwc)[:, None, :]     # [B,L,L,H,K]
        gate = torch.exp(torch.where(tri_lo, rel, -torch.inf))
        att = torch.einsum("bijhk,bijhk->bijh",
                           (rc[:, :, None] * kc[:, None, :]), gate)
        y = torch.einsum("bijh,bjhv->bihv", att, vc)
        bonus = torch.einsum("bihk,bihk->bih", rc * uf, kc)
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cwe), sprev)
        wdec = torch.exp(cwl)                               # [B,H,K]
        carry = torch.exp(cwl[:, None] - cwe - lwc)         # [B,L,H,K]
        sprev = sprev * wdec[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", carry * kc, vc)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(bsz, s, h, kd), sprev

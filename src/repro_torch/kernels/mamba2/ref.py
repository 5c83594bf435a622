"""Plain PyTorch version of the Mamba-2 SSD scan kernel.

The reference's ``repro.models.ssm.ssd_chunked``, operation for operation:
the log decay ``la = log(max(a, 1e-20))`` is summed within each chunk, and
each chunk adds the intra-chunk term ``sum_{j<=i} exp(cum_i - cum_j) (C_i .
B_j) x_j`` (the exponent masked to -inf above the diagonal before the
exponential, never factored into ``exp(cum_i) * exp(-cum_j)``, which
overflows under strong decay), the inter-chunk term from the carried
``[B, H, P, N]`` state, and the state update.  The CPU path of
``ops.mamba2_ssd`` runs it; on the card it is only the comparison the
kernel is held to.
"""
from __future__ import annotations

import torch


def mamba2_ssd_ref(x, a, b, c, *, chunk: int, h0=None):
    """x [B,S,H,P] (dt-scaled), a [B,S,H] decay in (0, 1], b/c [B,S,N]
    (shared across heads), h0 [B,H,P,N] or None; S a multiple of ``chunk``.
    Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    xs = x.float().reshape(bsz, nc, chunk, h, p)
    bs = b.float().reshape(bsz, nc, chunk, n)
    cs = c.float().reshape(bsz, nc, chunk, n)
    la = torch.log(torch.clamp_min(a.float(), 1e-20)).reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(la, dim=2)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for ci in range(nc):
        xc, bc, cc, cumc = xs[:, ci], bs[:, ci], cs[:, ci], cum[:, ci]
        rel = cumc[:, :, None, :] - cumc[:, None, :, :]          # [B,L,L,H]
        g = torch.exp(torch.where(tri, rel, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", cc, bc)                 # [B,L,L]
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * g, xc)
        y_inter = (torch.einsum("bin,bhpn->bihp", cc, hprev)
                   * torch.exp(cumc)[..., None])
        ys.append(y_intra + y_inter)
        tot = torch.exp(cumc[:, -1])                              # [B,H]
        w = torch.exp(cumc[:, -1][:, None, :] - cumc)             # [B,L,H]
        dh = torch.einsum("bjhp,bjn->bhpn", xc * w[..., None], bc)
        hprev = hprev * tot[:, :, None, None] + dh
    return torch.stack(ys, dim=1).reshape(bsz, s, h, p), hprev

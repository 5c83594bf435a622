"""Plain PyTorch version of the Mamba-2 SSD scan kernel, pass by pass.

The reference's ``repro.models.ssm.ssd_chunked`` in the three passes the
kernel runs (``csrc/mamba2_ssd.cu``): the log decay ``la = log(max(a,
1e-20))`` is summed within each chunk into ``cum``; ``chunk_state_ref``
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
"""
from __future__ import annotations

import torch


def chunk_state_ref(x, a, b, *, chunk: int):
    """x [B,S,H,P] (dt-scaled), a [B,S,H] decay in (0, 1], b [B,S,N]; S a
    multiple of ``chunk``.  Returns (cum [B,nc,H,L], the in-chunk inclusive
    prefix sums of the log decay; states [B,nc,H,N,P], each chunk's own
    state, transposed), float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    la = torch.log(torch.clamp_min(a.float(), 1e-20)).reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(la, dim=2)                                 # [B,nc,L,H]
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


def mamba2_ssd_ref(x, a, b, c, *, chunk: int, h0=None):
    """x [B,S,H,P] (dt-scaled), a [B,S,H] decay in (0, 1], b/c [B,S,N]
    (shared across heads), h0 [B,H,P,N] or None; S a multiple of ``chunk``.
    Returns (y [B,S,H,P], h_final [B,H,P,N]), both float32."""
    cum, states = chunk_state_ref(x, a, b, chunk=chunk)
    h_in, hf = state_pass_ref(states, cum, h0=h0)
    return chunk_scan_ref(x, b, c, cum, h_in, chunk=chunk), hf

"""Plain PyTorch version of the token_select kernel.

The op sequence of the reference's ``repro.kernels.token_select.ref``
(opportunity renormalisation -> uniform fallback -> segment search ->
demand guard), vectorised over a trailing worker axis.  bf16 shares are widened to
float32 first and the draw runs in float32, as the kernel runs it.  The CPU
path of ``ops.token_select`` runs it; on the card it is only the comparison
the kernel is held to.
"""
from __future__ import annotations

import torch


def token_select_ref(shares: torch.Tensor, qcount: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """shares f32 or bf16 [S, J], qcount i32[S, J], u f32[S, W] -> i32[S, W]
    (-1 = idle)."""
    shares = shares.float()
    demand = qcount > 0
    dm = demand.to(shares.dtype)
    masked = shares * dm
    total_m = masked.sum(dim=-1, keepdim=True)
    probs = torch.where(total_m > 0,
                        masked / torch.clamp_min(total_m, 1e-30), 0.0)
    # Work conservation: demand with no policy mass draws uniformly.
    no_mass = probs.sum(dim=-1, keepdim=True) <= 0
    ones_m = torch.ones_like(shares) * dm
    total_u = ones_m.sum(dim=-1, keepdim=True)
    uniform = torch.where(total_u > 0,
                          ones_m / torch.clamp_min(total_u, 1e-30), 0.0)
    probs = torch.where(no_mass, uniform, probs)
    seg = torch.cumsum(probs, dim=-1)                      # [S, J]
    total = seg[:, -1]                                     # [S]
    # Branchless segment search per worker: count boundaries <= u.
    idx = (seg[:, None, :] <= u[:, :, None]).sum(dim=-1)   # [S, W]
    idx = torch.clamp(idx, 0, shares.shape[-1] - 1)
    idx = torch.where(total[:, None] > 0, idx, -1)
    # Roundoff guard: picked slot must have demand; else first demanded slot.
    has = torch.gather(demand, 1, torch.clamp_min(idx, 0))
    first = torch.argmax(demand.to(torch.int32), dim=-1)
    idx = torch.where((idx >= 0) & ~has, first[:, None], idx)
    return idx.to(torch.int32)

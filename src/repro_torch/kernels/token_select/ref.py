"""Plain PyTorch version of the token_select kernel.

The op sequence of the reference's ``repro.kernels.token_select.ref``
(opportunity renormalisation -> uniform fallback -> segment search ->
demand guard), vectorised over a trailing worker axis.  float32 shares draw
in float32.  bf16 shares draw as the reference draws them: renormalised and
prefix-summed in bf16, each sum taken in float32 in XLA CPU's order and
rounded to bf16 where the reference's compiled code rounds it
(:mod:`repro_torch.core.ordered`), so the picks are the reference's.  The
CPU path of ``ops.token_select`` runs it; on the card it is the comparison
the kernel is held to.
"""
from __future__ import annotations

import torch

from ...core.ordered import ordered_cumsum, ordered_sum


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bf16 (to nearest even), kept as float32."""
    return x.to(torch.bfloat16).float()


def _probs_bf16(shares: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 renormalised probabilities (as float32 values):
    totals summed in float32 and rounded, each quotient rounded."""
    dm = demand.to(torch.float32)
    masked = shares.float() * dm
    tiny = _bf16(torch.tensor(1e-30))
    total_m = _bf16(ordered_sum(masked))[..., None]
    probs = torch.where(total_m > 0,
                        _bf16(masked / _bf16(torch.maximum(total_m, tiny))),
                        0.0)
    no_mass = ~(probs > 0).any(dim=-1, keepdim=True)
    total_u = _bf16(ordered_sum(dm))[..., None]
    uniform = torch.where(total_u > 0,
                          _bf16(dm / _bf16(torch.maximum(total_u, tiny))), 0.0)
    return torch.where(no_mass, uniform, probs)


def _probs_f32(shares: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
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
    return torch.where(no_mass, uniform, probs)


def token_select_ref(shares: torch.Tensor, qcount: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """shares f32 or bf16 [S, J], qcount i32[S, J], u f32[S, W] -> i32[S, W]
    (-1 = idle)."""
    demand = qcount > 0
    if shares.dtype == torch.bfloat16:
        seg = ordered_cumsum(_probs_bf16(shares, demand), torch.bfloat16)
    else:
        seg = torch.cumsum(_probs_f32(shares.float(), demand), dim=-1)
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

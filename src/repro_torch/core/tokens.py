"""Statistical tokens: opportunity renormalisation and the worker draw.

:func:`select_job` draws through the port's ``token_select`` kernel wrapper:
the CUDA kernel for a tensor on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from ..kernels.token_select.ops import token_select


def opportunity_renorm(shares: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """Recycle tokens of idle jobs: renormalise shares over demanded jobs."""
    masked = shares * demand.to(shares.dtype)
    total = masked.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, masked / torch.clamp_min(total, 1e-30), 0.0)


def shares_have_mass(shares: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """bool[...]: does any *demanded* job carry positive share mass?"""
    return opportunity_renorm(shares, demand).sum(dim=-1) > 0


def select_job(shares: torch.Tensor, demand: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """One worker token draw per row: shares f32[..., J], demand bool[..., J],
    u f32[...] in [0, 1) -> int32[...] job index, -1 when no job has demand."""
    j = shares.shape[-1]
    batch = shares.shape[:-1]
    idx = token_select(shares.reshape(-1, j).contiguous(),
                       demand.reshape(-1, j).to(torch.int32),
                       u.reshape(-1, 1).to(torch.float32).contiguous())[:, 0]
    return idx.reshape(batch)

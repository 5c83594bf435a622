"""λ-delayed global fairness (paper §3.1, Fig. 5).

Every λ the servers exchange their job status tables and each re-derives its
token segments from the global view: per-server segments ``A[s, j] >= 0``
with row sums 1, column sums proportional to the global policy shares and
support restricted to servers where the job has I/O, solved by iterative
proportional fitting (Sinkhorn), as in the reference ``repro.core.global_sync``.
"""
from __future__ import annotations

import torch

from .policy import PolicyChain


def sinkhorn_balance(support: torch.Tensor, col_targets: torch.Tensor,
                     n_iters: int = 32) -> torch.Tensor:
    """Balance per-server segments (``support`` f32 ``[S, J]``) to match the
    global shares ``col_targets`` f32 ``[J]``; rows of the result sum to 1
    over live columns."""
    s = support.shape[0]
    row_t = torch.full((s,), 1.0 / s, dtype=torch.float32,
                       device=support.device)
    col_t = col_targets.to(torch.float32)
    col_live = (support.sum(dim=0) > 0) & (col_t > 0)
    col_t = torch.where(col_live, col_t, 0.0)
    tot = torch.clamp_min(col_t.sum(), 1e-30)
    col_t = col_t / tot

    a = support * col_t[None, :]
    for _ in range(n_iters):
        csum = a.sum(dim=0)
        a = a * torch.where(csum > 0, col_t / torch.clamp_min(csum, 1e-30),
                            0.0)[None, :]
        rsum = a.sum(dim=1, keepdim=True)
        a = a * torch.where(rsum > 0,
                            row_t[:, None] / torch.clamp_min(rsum, 1e-30), 0.0)
    rsum = a.sum(dim=1, keepdim=True)
    return torch.where(rsum > 0, a / torch.clamp_min(rsum, 1e-30), 0.0)


def sync_segments(chain: PolicyChain, server_demand: torch.Tensor,
                  n_iters: int = 32) -> torch.Tensor:
    """One λ-sync: merged table -> global shares -> balanced per-server
    segments.  ``server_demand`` is bool ``[S, J]``."""
    any_demand = server_demand.any(dim=0)
    g = chain.shares(chain.active & any_demand)
    return sinkhorn_balance(server_demand.to(torch.float32), g,
                            n_iters=n_iters)


def local_segments(chain: PolicyChain, server_demand: torch.Tensor) -> torch.Tensor:
    """Per-server segments from each server's purely local view: the chain
    over ``active & server_demand[s]``, one batched op over the server axis."""
    return chain.shares(chain.active[None, :] & server_demand)

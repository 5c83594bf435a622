"""Scheduler-private state and the FIFO baseline's select rule.

``AuxState`` keeps the reference's fields (``repro.core.baselines``) so an
engine state converts leaf for leaf; the ported schedulers (themis, fifo)
carry it through unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AuxState(NamedTuple):
    budget: torch.Tensor      # f32[S, J] GIFT per-interval byte budget
    coupons: torch.Tensor     # f32[S, J] GIFT carried reward
    served: torch.Tensor      # f32[S, J] bytes served this interval
    bucket: torch.Tensor      # f32[S, J] TBF/AdapTBF tokens
    spare: torch.Tensor       # f32[S]    TBF spare-bandwidth quota
    borrowed: torch.Tensor    # f32[S, J] AdapTBF outstanding borrowed tokens
    ema: torch.Tensor         # f32[S, J] plan: qcount-history EMA
    plan: torch.Tensor        # f32[S, J] plan: per-μ serving allowance


def init_aux(n_servers: int, max_jobs: int, device="cpu") -> AuxState:
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return AuxState(budget=z(n_servers, max_jobs),
                    coupons=z(n_servers, max_jobs),
                    served=z(n_servers, max_jobs),
                    bucket=z(n_servers, max_jobs), spare=z(n_servers),
                    borrowed=z(n_servers, max_jobs),
                    ema=z(n_servers, max_jobs), plan=z(n_servers, max_jobs))


def fifo_select(head_time: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """Earliest queued arrival across jobs, ties to the lowest job index;
    -1 when all queues are empty."""
    j = torch.argmin(head_time, dim=-1).to(torch.int32)
    return torch.where(demand.any(dim=-1), j, -1)

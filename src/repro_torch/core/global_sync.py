"""λ-delayed global fairness (paper §3.1, Fig. 5).

Every λ the servers exchange their job status tables and each re-derives its
token segments from the global view: per-server segments ``A[s, j] >= 0``
with row sums 1, column sums proportional to the global policy shares and
support restricted to servers where the job has I/O, solved by iterative
proportional fitting (Sinkhorn), as in the reference ``repro.core.global_sync``.
"""
from __future__ import annotations

import torch

from .ordered import SUM_WINDOW, fma, ftz, ordered_sum
from .policy import PolicyChain


def _col_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the server axis (``-2``) in XLA CPU's order (terms >= 0 and
    normal, so no partial sum is subnormal)."""
    return ordered_sum(a.transpose(-1, -2))


def _row_sum(a: torch.Tensor, scale: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Sum over the job axis (``-1``) of ``a * scale`` in XLA CPU's order,
    kept.  Up to 32 jobs XLA fuses the product into the sum and contracts
    each step into one fused multiply-add (each result flushed); above, it
    sums the rounded, flushed products by windows of 32."""
    if scale is not None and a.shape[-1] <= SUM_WINDOW:
        acc = 0.0
        for x, c in zip(a.unbind(-1), scale[..., None, :].unbind(-1)):
            acc = ftz(fma(x, c, acc))
        return acc[..., None]
    if scale is not None:
        a = ftz(a * scale[..., None, :])
    return ordered_sum(a)[..., None]


def sinkhorn_balance(support: torch.Tensor, col_targets: torch.Tensor,
                     n_iters: int = 32) -> torch.Tensor:
    """Balance per-server segments (``support`` f32 ``[..., S, J]``) to
    match the global shares ``col_targets`` f32 ``[..., J]``; rows of the
    result sum to 1 over live columns.  Every value is rounded as the
    reference's compiled code rounds it: the sums in its order
    (:func:`_col_sum`, :func:`_row_sum`), subnormal results flushed
    (``ordered.ftz``: Sinkhorn drives the segments of a job a server
    cannot serve toward 0 and through that range), so the segments are
    the reference's bit for bit.  The test for a live column sums 0/1
    values, exact in any order."""
    s = support.shape[-2]
    row_t = torch.full((s, 1), 1.0 / s, dtype=torch.float32,
                       device=support.device)
    col_t = ftz(col_targets.to(torch.float32))
    col_live = (support.sum(dim=-2) > 0) & (col_t > 0)
    col_t = torch.where(col_live, col_t, 0.0)
    tot = torch.clamp_min(ordered_sum(col_t)[..., None], 1e-30)
    col_t = ftz(col_t / tot)

    a = ftz(support * col_t[..., None, :])
    for _ in range(n_iters):
        csum = _col_sum(a)
        cs = ftz(torch.where(csum > 0,
                             col_t / torch.clamp_min(csum, 1e-30), 0.0))
        rsum = _row_sum(a, cs)
        rs = ftz(torch.where(rsum > 0,
                             row_t / torch.clamp_min(rsum, 1e-30), 0.0))
        a = ftz(ftz(a * cs[..., None, :]) * rs)
    rsum = _row_sum(a)
    return ftz(torch.where(rsum > 0, a / torch.clamp_min(rsum, 1e-30), 0.0))


def sync_segments(chain: PolicyChain, server_demand: torch.Tensor,
                  n_iters: int = 32) -> torch.Tensor:
    """One λ-sync: merged table -> global shares -> balanced per-server
    segments.  ``server_demand`` is bool ``[..., S, J]``."""
    any_demand = server_demand.any(dim=-2)
    g = chain.shares(chain.active & any_demand)
    return sinkhorn_balance(server_demand.to(torch.float32), g,
                            n_iters=n_iters)


def local_segments(chain: PolicyChain, server_demand: torch.Tensor) -> torch.Tensor:
    """Per-server segments from each server's purely local view: the chain
    over ``active & server_demand[s]``, one batched op over the server axis."""
    return chain.shares(chain.active[None, :] & server_demand)

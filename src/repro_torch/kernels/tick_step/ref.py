"""Plain PyTorch version of the tick_step kernel.

The op sequence of the reference's ``repro.kernels.tick_step.ref``: the W
workers' sequential select -> pop -> ring-head advance for every server.

    shares  f32[S, J]    per-tick share table (themis mode; bf16 is widened)
    qcount  i32[S, J]    queued requests per (server, job) at tick start
    window  f32[S, J, W] next W ring arrival stamps per (server, job)
    free    bool[S, W]   worker is free this tick
    u       f32[S, W]    per-worker uniform draws

Returns ``(sel i32[S, W], valid bool[S, W], demand_any bool[S, W],
qcount_out i32[S, J], pops i32[S, J])``.
"""
from __future__ import annotations

import torch

from ..token_select.ref import token_select_ref
from ...core.baselines import fifo_select

#: In-kernel select modes: the statistical-token weighted draw (themis) and
#: the earliest-queued-arrival draw (fifo).
MODES = ("themis", "fifo")


def tick_step_ref(shares, qcount, window, free, u, mode: str = "themis"):
    if mode not in MODES:
        raise ValueError(f"unknown tick-step mode {mode!r}; one of {MODES}")
    n_workers = u.shape[1]
    rows = torch.arange(qcount.shape[0], device=qcount.device)
    pops = torch.zeros_like(qcount)
    q = qcount
    sel_cols, valid_cols, dany_cols = [], [], []
    for w in range(n_workers):
        demand = q > 0
        if mode == "themis":
            j_sel = token_select_ref(shares, q, u[:, w:w + 1])[:, 0]
        else:
            ht = torch.gather(window, 2, pops.to(torch.int64)[..., None])[..., 0]
            ht = torch.where(demand, ht, torch.inf)
            j_sel = fifo_select(ht, demand)
        valid = free[:, w] & (j_sel >= 0)
        j_safe = torch.clamp_min(j_sel, 0).to(torch.int64)
        step = valid.to(q.dtype)
        q = q.index_put((rows, j_safe), -step, accumulate=True)
        pops = pops.index_put((rows, j_safe), step, accumulate=True)
        sel_cols.append(j_sel)
        valid_cols.append(valid)
        dany_cols.append(demand.any(dim=-1))
    return (torch.stack(sel_cols, dim=1), torch.stack(valid_cols, dim=1),
            torch.stack(dany_cols, dim=1), q, pops)

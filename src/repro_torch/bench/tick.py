"""kern section on the port: the per-worker scan against the fused tick,
and the roofline budget.

The scan worker phase is W steps, each one draw, pop and ring advance (on
the card one ``token_select`` launch per worker); the fused tick answers
all W draws in one ``tick_step`` launch.  Both are timed at the engine
geometry of the reference's ``benchmarks/bench_tick.py`` (S = 8, W = 8,
J = 16, 256, 1024), on the same inputs (made by the port's
``core/prng.py``, bit for bit ``jax.random``'s), and reported as:

    kern_tick_ref_j{J}        scan worker phase, us/tick
    kern_tick_fused_j{J}      fused tick-step, us/tick
    kern_tick_speedup_j{J}    ref/fused ratio
    kern_tick_budget_us_j{J}  roofline budget of one fused tick at the
                              H100's constants
                              (:func:`repro_torch.roofline.analysis.tick_step_roofline`)

``BENCH_KERN_ITERS`` sets the timing loop (30).
"""
from __future__ import annotations

import os

import torch

from .._device import resolve_device
from ..core import prng
from ..core.ordered import ordered_cumsum
from ..kernels.tick_step.ops import tick_step
from ..kernels.token_select.ops import token_select
from ..roofline.analysis import tick_step_roofline
from .common import Row
from .kernels import _time

#: Engine geometry of the ladder (servers x workers; J varies).
N_SERVERS = 8
N_WORKERS = 8
LADDER = (16, 256, 1024)


def scan_phase(shares, qcount, window, free, u, mode: str = "themis"):
    """The per-worker worker phase, the reference's ``_scan_phase``: for
    each worker in order one draw on the live counts (themis: a
    ``token_select`` launch; fifo: the earliest head stamp), then its pop.
    Returns (sel int32 ``[W, S]``, qcount', pops)."""
    j_ = qcount.shape[1]
    q, pops = qcount, torch.zeros_like(qcount)
    sels = []
    for w in range(u.shape[1]):
        demand = q > 0
        if mode == "themis":
            j_sel = token_select(shares, q, u[:, w:w + 1].contiguous())[:, 0]
        else:
            ht = torch.gather(window, 2, pops.long()[..., None])[..., 0]
            ht = torch.where(demand, ht, torch.inf)
            j_sel = torch.where(demand.any(dim=-1),
                                torch.argmin(ht, dim=-1).to(torch.int32), -1)
        valid = free[:, w] & (j_sel >= 0)
        onehot = (torch.nn.functional.one_hot(
            torch.clamp_min(j_sel, 0).long(), j_).to(torch.int32)
            * valid[:, None].to(torch.int32))
        q, pops = q - onehot, pops + onehot
        sels.append(j_sel)
    return torch.stack(sels), q, pops


def fused_phase(shares, qcount, window, free, u, mode: str = "themis"):
    """One ``tick_step`` launch -> (sel int32 ``[S, W]``, qcount', pops)."""
    sel, _, _, q, pops = tick_step(shares, qcount, window, free, u,
                                   mode=mode)
    return sel, q, pops


def inputs(j: int, device: str = "cuda"):
    """The reference's ``_inputs(j)``: shares ``|normal|``, qcount in
    [0, 4), the ring window (prefix sums of uniforms), free (p = 0.9) and
    u, from ``split(PRNGKey(42), 5)``."""
    device = resolve_device(device)
    ks = prng.split(prng.PRNGKey(42), 5)
    s, w = N_SERVERS, N_WORKERS
    shares = prng.normal(ks[0], (s, j)).abs()
    qcount = prng.randint(ks[1], 0, 4, (s, j))
    window = ordered_cumsum(prng.uniform(ks[2], (s, j, w)))
    free = prng.uniform(ks[3], (s, w)) < 0.9
    u = prng.uniform(ks[4], (s, w))
    return [t.to(device).contiguous()
            for t in (shares, qcount, window, free, u)]


def run_kern(*, device: str = "cuda", iters=None) -> list[Row]:
    iters = int(os.environ.get("BENCH_KERN_ITERS", "30")) if iters is None \
        else iters
    rows = []
    for j in LADDER:
        args = inputs(j, device)
        ref_us = _time(scan_phase, *args, iters=iters, warmup=2)
        fused_us = _time(fused_phase, *args, iters=iters, warmup=2)
        roof = tick_step_roofline(N_SERVERS, j, N_WORKERS)
        speedup = ref_us / fused_us if fused_us else 0.0
        rows.append(Row(f"kern_tick_ref_j{j}", f"{ref_us:.1f}",
                        f"{ref_us:.1f} us/tick ({N_WORKERS}-step scan, "
                        f"{N_SERVERS}srv)"))
        rows.append(Row(f"kern_tick_fused_j{j}", f"{fused_us:.1f}",
                        f"{fused_us:.1f} us/tick (fused tick-step)"))
        rows.append(Row(f"kern_tick_speedup_j{j}", "",
                        f"{speedup:.2f}x ref/fused"))
        rows.append(Row(f"kern_tick_budget_us_j{j}", "",
                        f"{roof['budget_us']:.3f} us roofline "
                        f"({roof['bound']}-bound, "
                        f"{roof['intensity_flops_per_byte']:.1f} flop/B)"))
    return rows

"""Microbenchmarks on the port: the statistical-token draw and the policy
chain, with the inputs, shapes and rows of the reference's
``benchmarks/bench_kernels.py`` (the draw's inputs from the port's
``core/prng.py``, bit for bit ``jax.random``'s).  On the card the draw is
one ``token_select`` launch; the derived column reports per-draw time (the
paper quotes ~1 us per token draw, §5.3.1)."""
from __future__ import annotations

import time

import torch

from .._device import resolve_device
from ..core import prng
from ..core.job_table import make_table
from ..core.policy import Policy, compute_job_shares_from_table
from ..kernels.token_select.ops import token_select
from .common import Row


def _time(fn, *args, iters: int = 50, warmup: int = 1) -> float:
    """Mean us per call, the device synchronised on every call: on the card
    each call is timed by CUDA events around it, elsewhere by the host's
    clock (so calls never overlap, as the reference's
    ``block_until_ready``)."""
    cuda = any(torch.is_tensor(a) and a.is_cuda for a in args)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(max(1, warmup)):
        fn(*args)
        sync()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e6
    total = 0.0
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters * 1e3


def draw_inputs(device: str = "cuda"):
    """The reference's draw inputs: shares ``|normal|`` f32 ``[8, 32]``,
    qcount int32 in [0, 4), u f32 ``[8, 8]``."""
    device = resolve_device(device)
    shares = prng.normal(prng.PRNGKey(0), (8, 32)).abs()
    qcount = prng.randint(prng.PRNGKey(1), 0, 4, (8, 32))
    u = prng.uniform(prng.PRNGKey(2), (8, 8))
    return [t.to(device).contiguous() for t in (shares, qcount, u)]


def chain_table(device: str = "cuda"):
    """The 16-job table (4 users, 2 groups) of the chain row, 32 slots."""
    return make_table([{"user": i % 4, "group": i % 2, "size": 1 + i}
                       for i in range(16)], max_jobs=32,
                      device=resolve_device(device))


def run_micro(*, device: str = "cuda", iters: int = 50) -> list[Row]:
    rows = []
    shares, qcount, u = draw_inputs(device)
    us = _time(token_select, shares, qcount, u, iters=iters)
    rows.append(Row("micro_token_select_8srv_x8workers", f"{us:.1f}",
                    f"{us/64:.2f} us/draw (paper ~1us)"))
    table = chain_table(device)
    pol = Policy.parse("group-user-size-fair")
    # The table's mask rides along so that _time sees the device.
    us = _time(lambda _: compute_job_shares_from_table(pol, table),
               table.active, iters=iters)
    rows.append(Row("micro_policy_chain_3level_32slots", f"{us:.1f}",
                    "Eq.1 product"))
    return rows

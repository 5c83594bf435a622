"""Paper Fig. 8 on the port: size-/job-/user-fair sharing on one server,
and every registered scheduler on two equal jobs (8d).  The rows, jobs,
windows and seeds of the reference's ``benchmarks/bench_policies.py``; the
windows scale with the simulated duration ``seconds``."""
from __future__ import annotations

import time
from typing import Optional

from ..core import metrics
from ..core.scheduler import available_schedulers
from .common import (Row, bench_seconds, bench_seeds, fmt_stat, seed_stat,
                     simulate_batch, sweep)


def _ratio(w0, w1):
    return lambda r: (metrics.median_gbps(r, 0, w0, w1)
                      / max(metrics.median_gbps(r, 1, w0, w1), 1e-9))


def run_fig8(seconds: Optional[float] = None, seeds=None, *,
             device: str = "cuda", table: bool = True) -> list[Row]:
    """Fig. 8 a-c (themis) and, with ``table``, 8d (every scheduler)."""
    sec = bench_seconds() if seconds is None else seconds
    seeds = bench_seeds() if seeds is None else tuple(seeds)
    n_seeds = len(seeds)
    i0, i1 = 0.25 * sec, 0.75 * sec        # interferer arrival window
    w0, w1 = sec / 3, 2 * sec / 3          # both-jobs-active window
    a0, a1 = sec / 30, 7 * sec / 30        # job-1-alone window
    rows = []
    # (a) size-fair: 4-node (224p) vs 1-node (56p); paper 3.96
    jobs = [dict(user=0, size=4, procs=224, req_mb=10, start_s=0, end_s=sec),
            dict(user=1, size=1, procs=56, req_mb=10, start_s=i0, end_s=i1)]
    t0 = time.time()
    batch, _ = simulate_batch("themis", jobs, sec, seeds=seeds,
                              policy="size-fair", device=device)
    us = f"{(time.time() - t0) * 1e6 / n_seeds:.0f}"
    alone = seed_stat(batch, lambda r: metrics.total_gbps(r, a0, a1))
    ratio = seed_stat(batch, _ratio(w0, w1))
    rows.append(Row("fig8a_size_fair_alone_gbps", us, fmt_stat(*alone),
                    (alone[0],), (alone[1],)))
    rows.append(Row("fig8a_size_fair_shared_ratio", us,
                    fmt_stat(*ratio) + " (paper 3.96)", (ratio[0],),
                    (ratio[1],)))
    # (b) job-fair: same pair -> ~equal
    t0 = time.time()
    batch, _ = simulate_batch("themis", jobs, sec, seeds=seeds,
                              policy="job-fair", device=device)
    us = f"{(time.time() - t0) * 1e6 / n_seeds:.0f}"
    ratio = seed_stat(batch, _ratio(w0, w1))
    rows.append(Row("fig8b_job_fair_ratio", us,
                    fmt_stat(*ratio) + " (paper ~1.0)", (ratio[0],),
                    (ratio[1],)))
    # (c) user-fair: user A two 2-node jobs vs user B one 1-node job
    jobs = [dict(user=0, size=2, procs=112, req_mb=10, end_s=sec),
            dict(user=0, size=2, procs=112, req_mb=10, end_s=sec),
            dict(user=1, size=1, procs=56, req_mb=10, start_s=i0, end_s=i1)]
    t0 = time.time()
    batch, _ = simulate_batch("themis", jobs, sec, seeds=seeds,
                              policy="user-fair", device=device)
    us = f"{(time.time() - t0) * 1e6 / n_seeds:.0f}"
    ua = seed_stat(batch, lambda r: metrics.median_gbps(r, 0, w0, w1)
                   + metrics.median_gbps(r, 1, w0, w1))
    ub = seed_stat(batch, lambda r: metrics.median_gbps(r, 2, w0, w1))
    rows.append(Row("fig8c_user_fair_userA_vs_userB", us,
                    f"{ua[0]:.2f}/{ub[0]:.2f} GB/s cov {ua[1]*100:.1f}/"
                    f"{ub[1]*100:.1f}% (paper 10.85/10.80)",
                    (ua[0], ub[0]), (ua[1], ub[1])))
    if table:
        rows.extend(run_scheduler_table(sec, seeds, device=device))
    return rows


def run_scheduler_table(seconds: Optional[float] = None, seeds=None, *,
                        device: str = "cuda") -> list[Row]:
    """Every registered scheduler on the same two-equal-jobs contention:
    job1/job2 throughput ratio and sustained total, mean ± CoV."""
    seconds = bench_seconds() if seconds is None else seconds
    seeds = bench_seeds() if seeds is None else tuple(seeds)
    w0, w1 = seconds / 3, 2 * seconds / 3
    jobs = [dict(user=0, size=1, procs=56, req_mb=10, end_s=seconds),
            dict(user=1, size=1, procs=56, req_mb=10, end_s=seconds)]
    variants = {s: dict(scheduler=s, jobs=jobs, policy="job-fair")
                for s in available_schedulers()}
    rows = []
    for sched, (batch, _, secs) in sweep(variants, seconds, seeds=seeds,
                                         device=device).items():
        us = f"{secs * 1e6 / len(seeds):.0f}"
        ratio = seed_stat(batch, _ratio(w0, w1))
        tot = seed_stat(batch, lambda r: metrics.total_gbps(r, w0, w1))
        rows.append(Row(f"fig8d_{sched}_equal_jobs_ratio", us,
                        fmt_stat(*ratio) + " (fair = 1.0)", (ratio[0],),
                        (ratio[1],)))
        rows.append(Row(f"fig8d_{sched}_sustained_gbps", us, fmt_stat(*tot),
                        (tot[0],), (tot[1],)))
    return rows

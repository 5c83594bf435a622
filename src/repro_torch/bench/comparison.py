"""Paper Fig. 12 on the port: ThemisIO against every registered scheduler
on one substrate.  The rows, jobs, windows and seeds of the reference's
``benchmarks/bench_comparison.py``; the windows and the throughput bin
scale with the simulated duration ``seconds``."""
from __future__ import annotations

from typing import Optional

from ..core import metrics
from ..core.scheduler import available_schedulers
from .common import Row, bench_seconds, bench_seeds, fmt_stat, seed_stat, sweep


def make_jobs(seconds: float) -> list[dict]:
    """Two contending jobs: one full-length, one arriving mid-run."""
    return [dict(user=0, size=1, procs=56, req_mb=10,
                 start_s=0, end_s=seconds),
            dict(user=1, size=1, procs=56, req_mb=10,
                 start_s=0.25 * seconds, end_s=0.75 * seconds)]


def run_fig12(seconds: Optional[float] = None, seeds=None, *,
              device: str = "cuda") -> list[Row]:
    """The Fig. 12 rows of every registered scheduler."""
    seconds = bench_seconds() if seconds is None else seconds
    seeds = bench_seeds() if seeds is None else tuple(seeds)
    schedulers = available_schedulers()
    w0, w1 = seconds / 3, 2 * seconds / 3
    s0, s1 = 0.30 * seconds, 0.73 * seconds
    bin_ticks = max(1, int(round(min(1.0, seconds / 10) / 1e-3)))
    jobs = make_jobs(seconds)
    variants = {s: dict(scheduler=s, jobs=jobs, policy="job-fair",
                        bin_ticks=bin_ticks) for s in schedulers}
    rows, results = [], {}
    for sched, (batch, _, secs) in sweep(variants, seconds, seeds=seeds,
                                         device=device).items():
        us = f"{secs * 1e6 / len(seeds):.0f}"
        peak = seed_stat(batch, lambda r: metrics.total_gbps(r, w0, w1))
        j2 = seed_stat(batch, lambda r: metrics.median_gbps(r, 1, w0, w1))
        sd = seed_stat(batch, lambda r: metrics.std_gbps(r, 1, s0, s1))
        results[sched] = (peak[0], sd[0])
        rows.append(Row(f"fig12_{sched}_sustained_gbps", us, fmt_stat(*peak),
                        (peak[0],), (peak[1],)))
        rows.append(Row(f"fig12_{sched}_job2_gbps", us, fmt_stat(*j2),
                        (j2[0],), (j2[1],)))
        rows.append(Row(f"fig12_{sched}_job2_std_mbps", us,
                        f"{sd[0]*1e3:.0f}", (sd[0] * 1e3,), (sd[1],)))
        jain = seed_stat(batch, lambda r: r.jain_fairness(w0, w1))
        rows.append(Row(f"fig12_{sched}_jain_index", us, fmt_stat(*jain),
                        (jain[0],), (jain[1],)))
    th_peak, th_sd = results["themis"]
    for other in schedulers:
        if other == "themis":
            continue
        o_peak, o_sd = results[other]
        pct = (th_peak / max(o_peak, 1e-12) - 1) * 100
        var = (1 - th_sd / max(o_sd, 1e-12)) * 100
        rows.append(Row(f"fig12_themis_vs_{other}_pct", "0",
                        f"{pct:+.1f}% (paper +13.5–13.7% vs gift/tbf)",
                        (pct,), ()))
        rows.append(Row(f"fig12_themis_vs_{other}_variation_pct", "0",
                        f"{var:.1f}% lower (paper 19.5–40.4% vs gift/tbf)",
                        (var,), ()))
    return rows

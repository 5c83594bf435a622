"""Paper Fig. 7 / §5.2 on the port: aggregate throughput at 1 to 128
servers, FIFO against job-fair ThemisIO.  The rows, job list and geometry
of the reference's ``benchmarks/bench_scaling.py`` (fabric exponent 0.08,
dt 2e-4, wheel 2048, ring 64, 0.1 s bins); ``scale`` multiplies the run,
the job's end and the throughput window."""
from __future__ import annotations

import time

from ..core import metrics
from .common import Row, simulate

#: Server counts of the reference's ladder.
LADDER = (1, 2, 8, 32, 128)
#: The engine knobs of every run.
ENGINE_KW = dict(server_bw=11.7e9, dt=2e-4, wheel=2048, ring_cap=64,
                 fabric_exponent=0.08, bin_ticks=500)


def run_fig7(*, device: str = "cuda", scale: float = 1.0,
             servers=LADDER) -> list[Row]:
    """``fig7_{sched}_{n}srv_gbps`` for each server count, then the paper's
    numbers (``fig7_paper_reference``)."""
    rows = []
    for n in servers:
        jobs = [dict(user=0, size=n, procs=8 * n, req_mb=1, end_s=6 * scale)]
        for sched, pol in (("fifo", "job-fair"), ("themis", "job-fair")):
            t0 = time.time()
            res, _ = simulate(sched, jobs, 6 * scale, policy=pol, n_servers=n,
                              device=device, **ENGINE_KW)
            us = (time.time() - t0) * 1e6
            agg = metrics.total_gbps(res, 2 * scale, 5.5 * scale)
            rows.append(Row(f"fig7_{sched}_{n}srv_gbps", f"{us:.0f}",
                            f"{agg:.1f}"))
    rows.append(Row("fig7_paper_reference", "0",
                    "paper: 11.7 @1, 77.1 @8 (82%), 1017 @128 (68%)"))
    return rows

"""Paper Fig. 14 / §5.6 on the port: λ-delayed global fairness against the
interval length.  The jobs (``JOBS``: one striped over both servers, one on
each), the λ ladder and the rows of the reference's
``benchmarks/bench_lambda.py``; ``scale`` multiplies the runs, the jobs'
ends and the bin where the share trace's spread is read (40 of 50-tick
bins at scale 1), never λ or the bins."""
from __future__ import annotations

import time

import numpy as np

from ..core import metrics
from .common import Row, simulate

JOBS = [dict(user=0, size=16, procs=112, req_mb=10, servers=[0, 1], end_s=20),
        dict(user=1, size=8, procs=56, req_mb=10, servers=[0], end_s=20),
        dict(user=2, size=8, procs=56, req_mb=10, servers=[1], end_s=20)]
#: λ in ms (= ticks at dt 1 ms).
LADDER = (10, 50, 200, 500)
#: The bin from which the share trace's spread is read, at scale 1.
TRACE_BIN = 40


def run_fig14(*, device: str = "cuda", scale: float = 1.0,
              lambdas=LADDER) -> list[Row]:
    """Time to fairness and the share trace's spread per λ, then the share
    job 1 keeps with no sync (the unfair local fixed point, 2/3)."""
    jobs = [dict(j, end_s=j["end_s"] * scale) for j in JOBS]
    seconds = 20 * scale
    b0 = int(round(TRACE_BIN * scale))
    rows = []
    for lam_ms in lambdas:
        t0 = time.time()
        res, _ = simulate("themis", jobs, seconds, policy="size-fair",
                          n_servers=2, sync_ticks=lam_ms, bin_ticks=50,
                          device=device)
        us = f"{(time.time() - t0) * 1e6:.0f}"
        tf = metrics.time_to_fairness(res, [0, 1, 2], [0.5, 0.25, 0.25],
                                      tol=0.06)
        tr = metrics.share_trace(res, [0, 1, 2])
        var = float(np.std(tr[0, b0:]))
        intervals = tf / (lam_ms / 1000.0)
        rows.append(Row(f"fig14_lam{lam_ms}ms_t_fair_s", us,
                        f"{tf:.2f} ({intervals:.1f} intervals; paper <=2 "
                        "for >=50ms)"))
        rows.append(Row(f"fig14_lam{lam_ms}ms_share_std", us, f"{var:.3f}"))
    res, _ = simulate("themis", jobs, seconds, policy="size-fair",
                      n_servers=2, sync_ticks=0, bin_ticks=50, device=device)
    tr = metrics.share_trace(res, [0, 1, 2])
    rows.append(Row("fig14_nosync_job1_share", "0",
                    f"{float(tr[0, b0:].mean()):.3f} (local-unfair 0.667)"))
    return rows

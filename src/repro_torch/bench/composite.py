"""Paper Figs. 9-11 on the port: composite policies (user-then-size,
group-user-size).  The rows and job lists of the reference's
``benchmarks/bench_composite.py``; ``scale`` multiplies the runs, the
jobs' ends and the throughput window."""
from __future__ import annotations

import time

from ..core import metrics
from .common import Row, simulate


def fig9_jobs(scale: float = 1.0) -> list[dict]:
    """Four jobs, two users; user-fair at level 1, size-fair within."""
    end = 40 * scale
    return [dict(user=0, size=1, procs=56, req_mb=10, end_s=end),
            dict(user=0, size=2, procs=112, req_mb=10, end_s=end),
            dict(user=1, size=4, procs=112, req_mb=10, end_s=end),
            dict(user=1, size=6, procs=112, req_mb=10, end_s=end)]


def fig10_jobs(scale: float = 1.0) -> list[dict]:
    """Two groups, four users, eight jobs."""
    end = 40 * scale
    spec = ((0, 0, 2, 56), (0, 0, 2, 56), (1, 1, 2, 56), (1, 1, 3, 84),
            (1, 1, 2, 56), (1, 2, 2, 56), (1, 3, 1, 56), (1, 3, 1, 56))
    return [dict(group=g, user=u, size=sz, procs=p, req_mb=10, end_s=end)
            for g, u, sz, p in spec]


def run_fig9_11(*, device: str = "cuda", scale: float = 1.0) -> list[Row]:
    rows = []
    w0, w1 = 10 * scale, 35 * scale
    t0 = time.time()
    res, _ = simulate("themis", fig9_jobs(scale), 40 * scale,
                      policy="user-then-size-fair", device=device)
    us = f"{(time.time() - t0) * 1e6:.0f}"
    g = [metrics.median_gbps(res, j, w0, w1) for j in range(4)]
    rows.append(Row("fig9_user_split_gbps", us,
                    f"u1={g[0]+g[1]:.1f} u2={g[2]+g[3]:.1f} (paper 10.1/9.9)"))
    rows.append(Row("fig9_within_user_ratios", us,
                    f"{g[1]/max(g[0],1e-9):.2f}~2.0 "
                    f"{g[3]/max(g[2],1e-9):.2f}~1.5"))
    res, _ = simulate("themis", fig10_jobs(scale), 40 * scale,
                      policy="group-user-size-fair", device=device)
    g = [metrics.median_gbps(res, j, w0, w1) for j in range(8)]
    grp0, grp1 = g[0] + g[1], sum(g[2:])
    # The reference times only the first run and prints that time on every
    # row; so does the port.
    rows.append(Row("fig10_group_split_gbps", us,
                    f"{grp0:.1f}/{grp1:.1f} (paper 9.5/11.2)"))
    rows.append(Row("fig10_user1_jobs_ratio", us,
                    f"{g[2]:.2f}:{g[3]:.2f}:{g[4]:.2f} ~ 2:3:2"))
    rows.append(Row("fig10_total_gbps", us,
                    f"{sum(g):.1f} (paper 20.7)"))
    return rows

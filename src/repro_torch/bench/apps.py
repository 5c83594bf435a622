"""Paper Fig. 13 / §5.5 on the port: application slowdown under
interference, FIFO against size-fair ThemisIO.  The applications (``APPS``:
closed-loop compute / I/O phase traces), the background job (``BG``), the
rows and the ``>140`` / ``>99`` branches of the reference's
``benchmarks/bench_apps.py``; ``scale`` multiplies the runs and the jobs'
ends (an application's think time is part of its shape and stays)."""
from __future__ import annotations

import math
import time

from ..core import metrics
from .common import Row, simulate

#: app: nodes, processes, request MB and think time (compute phases).
APPS = {
    "namd": dict(size=64, procs=96, req_mb=8, think_s=0.8),
    "wrf": dict(size=4, procs=64, req_mb=8, think_s=0.25),
    "specfem3d": dict(size=16, procs=64, req_mb=4, think_s=1.0),
    "bert": dict(size=4, procs=16, req_mb=16, think_s=0.9),
    "resnet50_sync": dict(size=16, procs=64, req_mb=2, think_s=0.12),
}
#: The paper's 1-node benchmark job as the interferer.
BG = dict(user=9, size=1, procs=224, req_mb=10, end_s=55)


def run_fig13(*, device: str = "cuda", scale: float = 1.0,
              apps=tuple(APPS)) -> list[Row]:
    """Per application: the exclusive run's work by 25 s (of 30) sets the
    request count; the interfered runs (60 s, the background job to 55 s)
    time how long that many requests take under FIFO and size-fair."""
    rows = []
    bg = dict(BG, end_s=BG["end_s"] * scale)
    for name in apps:
        app = APPS[name]
        t0 = time.time()
        excl, _ = simulate("themis", [dict(user=0, end_s=25 * scale, **app)],
                           30 * scale, policy="size-fair", device=device)
        n_req = int(excl["completed"][0])
        spec = dict(user=0, start_s=0, end_s=60 * scale, **app)
        fifo, _ = simulate("fifo", [spec, bg], 60 * scale, device=device)
        fair, _ = simulate("themis", [spec, bg], 60 * scale,
                           policy="size-fair", device=device)
        us = f"{(time.time() - t0) * 1e6:.0f}"
        t_excl = metrics.completion_time(excl, 0, n_req)
        sd_fifo = (metrics.completion_time(fifo, 0, n_req) / t_excl - 1) * 100
        sd_fair = (metrics.completion_time(fair, 0, n_req) / t_excl - 1) * 100
        if math.isfinite(sd_fifo):
            reduction = (1 - max(sd_fair, 0) / max(sd_fifo, 1e-9)) * 100
            red_s = f"{reduction:.1f}"
        else:
            red_s = ">99" if sd_fair < 1.4 else f"bounded by {sd_fair:.1f}%"
        rows.append(Row(f"fig13_{name}_fifo_slowdown_pct", us,
                        f"{sd_fifo:.1f}" if math.isfinite(sd_fifo)
                        else ">140"))
        rows.append(Row(f"fig13_{name}_sizefair_slowdown_pct", us,
                        f"{sd_fair:.1f}"))
        rows.append(Row(f"fig13_{name}_interference_reduction_pct", us,
                        f"{red_s} (paper range 59.1-99.8)"))
    return rows

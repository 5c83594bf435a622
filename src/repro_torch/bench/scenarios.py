"""The scenario rows on the port: the paper's dynamic claims as phased
workloads, with the row names, jobs, windows and text of the reference's
``benchmarks/bench_scenarios.py`` (``run_scen``).

* **opportunity fairness** (§3, §5.3.1): a steady 1-node app against a heavy
  burster idle in the middle third; the app's throughput while the burster
  is active (themis job-fair against fifo) and while it is idle;
* **checkpoint interference** (§5.5): a 4-node app checkpointing 40 % of
  each period against a steady background job (themis size-fair against
  fifo);
* one aggregate row per preset of :func:`repro_torch.scenario.presets`
  (themis job-fair), which keep their 24 s shape and run for ``seconds``.

Every run is one seed (the reference's ``simulate``: 1 server, W = 8,
``dt`` 1 ms), so a row's ``means`` is its one value and ``covs`` is empty.
The jobs are built through the port's combinators.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from ..api import Experiment, RunResult
from ..scenario import leaf, mask, overlay, presets, repeat, to_jobs
from .common import Row, bench_seconds, log_run


def onoff_jobs(t: float) -> list[dict]:
    """Steady app + heavy burster idle in the middle third of the run."""
    app = leaf(dict(user=0, size=1, procs=56, req_mb=10, end_s=t))
    burster = leaf(dict(user=1, size=1, procs=224, req_mb=10, end_s=t))
    return to_jobs(overlay(app, mask(burster, end_s=t / 3)
                           | mask(burster, start_s=2 * t / 3, end_s=t)))


def ckpt_jobs(t: float) -> list[dict]:
    """WRF-like 4-node app checkpointing 40% of each period + background."""
    period = t / 6
    on = leaf(dict(user=0, size=4, procs=64, req_mb=8,
                   phases=[dict(start_s=0.0, duration_s=0.4 * period)]))
    bg = leaf(dict(user=9, size=1, procs=224, req_mb=10, end_s=t))
    return to_jobs(overlay(repeat(on, 6, period_s=period), bg))


def simulate(scheduler: str, jobs, seconds: float, *, policy="job-fair",
             device="cuda", wrap: Optional[Callable] = None,
             label: str = "") -> RunResult:
    """One run of the reference's ``simulate`` geometry; ``wrap(label,
    run)``, when given, calls ``run()`` and returns its result (a caller's
    hook around each run, e.g. to count launches)."""
    exp = Experiment(policy=policy, scheduler=scheduler, n_servers=1,
                     device=device).add_jobs(jobs)
    run = lambda: exp.run(seconds)   # noqa: E731
    res = run() if wrap is None else wrap(label or scheduler, run)
    log_run(res, seconds)
    return res


def run_scen(seconds: Optional[float] = None, *, device: str = "cuda",
             wrap: Optional[Callable] = None) -> list[Row]:
    """The reference's ``run_scen`` rows at ``seconds`` (default
    ``bench_seconds(24.0)``)."""
    t = bench_seconds(24.0) if seconds is None else seconds
    sim = lambda label, s, jobs, **kw: simulate(  # noqa: E731
        s, jobs, t, device=device, wrap=wrap, label=label, **kw)
    rows = []

    def row(name, us, value, text=""):
        rows.append(Row(name, us, f"{value:.2f}{text}", (value,), ()))

    busy = (0.05 * t, t / 3)              # burster active, past warmup
    idle = (t / 3 + 0.17 * t, 2 * t / 3)  # burster idle, backlog drained
    t0 = time.time()
    th = sim("oppfair_themis", "themis", onoff_jobs(t), policy="job-fair")
    ff = sim("oppfair_fifo", "fifo", onoff_jobs(t))
    us = f"{(time.time() - t0) * 1e6:.0f}"
    a_busy_th = th.mean_gbps(0, *busy)
    a_idle_th = th.mean_gbps(0, *idle)
    a_busy_ff = ff.mean_gbps(0, *busy)
    row("scen_oppfair_themis_busy_gbps", us, a_busy_th)
    row("scen_oppfair_themis_idle_gbps", us, a_idle_th,
        " (idle share reallocated)")
    row("scen_oppfair_fifo_busy_gbps", us, a_busy_ff)
    row("scen_oppfair_themis_vs_fifo", us, a_busy_th / max(a_busy_ff, 1e-9),
        "x while contended")

    period = t / 6
    on_windows = [(i * period, i * period + 0.4 * period) for i in range(6)]
    t0 = time.time()
    ck_ff = sim("ckpt_fifo", "fifo", ckpt_jobs(t))
    ck_th = sim("ckpt_themis", "themis", ckpt_jobs(t), policy="size-fair")
    us = f"{(time.time() - t0) * 1e6:.0f}"

    def on_mean(res):
        vals = [res.mean_gbps(0, a, b) for a, b in on_windows]
        return sum(vals) / len(vals)

    app_ff, app_th = on_mean(ck_ff), on_mean(ck_th)
    row("scen_ckpt_themis_gbps", us, app_th, " (app ckpt-window, size-fair)")
    row("scen_ckpt_fifo_gbps", us, app_ff)
    row("scen_ckpt_themis_vs_fifo", us, app_th / max(app_ff, 1e-9), "x")

    for name, scn in presets().items():
        t0 = time.time()
        res = sim(f"preset_{name}", "themis", scn.jobs, policy="job-fair")
        us = f"{(time.time() - t0) * 1e6:.0f}"
        row(f"scen_preset_{name.replace('-', '_')}_gbps", us,
            res.mean_gbps(None, 0.05 * t, t), f" ({scn.n_jobs} jobs)")
    return rows

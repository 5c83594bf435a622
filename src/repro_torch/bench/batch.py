"""The batch plane's rows on the port, with the row names, presets,
policies, seeds and text of the reference's ``benchmarks/bench_batch.py``
(``run_batch``).

One row pair per (queue preset x batch policy): the mean and p95 wait over
the seeds (every seed regenerates the preset and reseeds the annealer),
the plan-vs-fcfs and plan-vs-easy ratios of the mean waits, then
``batch_bridge_themis_gbps``: the bb-heavy plan timeline of the first seed
lowered through the scenario bridge and run on the engine (themis,
job-fair, the cluster's 2 servers, W = 8, ``dt`` 1 ms) for
``min(horizon, seconds)``.  ``batch_reference.json`` holds the reference's
rows at these settings (``tools/record_figure_reference.py --batch``).
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Optional

from ..api import Experiment
from ..batch import BatchExperiment, PlanOptParams
from .common import Row

PRESETS = ("bb-heavy", "longtail", "mixed")
POLICIES = ("fcfs", "easy", "plan")

#: The reference's defaults (``BENCH_BATCH_JOBS``, ``BENCH_BATCH_STEPS``,
#: ``bench_seeds(range(4))``): the rows' full width.
BENCH_JOBS = 24
BENCH_STEPS = 300
BENCH_SEEDS = tuple(range(4))
#: The bridge run's horizon cap (the reference's ``BENCH_SECONDS``; its
#: default is the timeline's 8 s).
BENCH_SECONDS = 2.0

REFERENCE_FILE = pathlib.Path(__file__).with_name("batch_reference.json")


def load_reference() -> dict:
    """``batch_reference.json``: ``{"rows": {name: {"derived", "value"}}}``."""
    return json.loads(REFERENCE_FILE.read_text())


def run_batch(seconds: float = BENCH_SECONDS, seeds=BENCH_SEEDS, *,
              n_jobs: int = BENCH_JOBS, sa_steps: int = BENCH_STEPS,
              device: str = "cuda", results: Optional[dict] = None
              ) -> list[Row]:
    """The reference's ``run_batch`` rows.  ``results``, when given, is
    filled with ``{(preset, seed, policy): (BatchResult, wall seconds)}``."""
    params = PlanOptParams(sa_steps=sa_steps)
    seeds = tuple(seeds)
    rows, bridge_exp = [], None
    for preset in PRESETS:
        t0 = time.time()
        waits = {pol: [] for pol in POLICIES}
        p95s = {pol: [] for pol in POLICIES}
        for seed in seeds:
            bx = BatchExperiment(preset, n_jobs=n_jobs, seed=seed,
                                 params=params, device=device)
            for pol in POLICIES:
                t1 = time.perf_counter()
                res = bx.run(pol, seed=seed)
                if results is not None:
                    results[(preset, seed, pol)] = (
                        res, time.perf_counter() - t1)
                waits[pol].append(res.mean_wait_s)
                p95s[pol].append(res.p95_wait_s)
                if (preset, pol, seed) == ("bb-heavy", "plan", seeds[0]):
                    bridge_exp = bx.to_experiment(res, scheduler="themis")
        us = f"{(time.time() - t0) * 1e6 / max(1, len(seeds) * len(POLICIES)):.0f}"
        mean = {pol: sum(w) / len(w) for pol, w in waits.items()}
        p95 = {pol: sum(w) / len(w) for pol, w in p95s.items()}
        tag = preset.replace("-", "")
        for pol in POLICIES:
            rows.append(Row(f"batch_{tag}_{pol}_meanwait_s", us,
                            f"{mean[pol]:.1f} ({len(seeds)} seeds)",
                            (mean[pol],), ()))
            rows.append(Row(f"batch_{tag}_{pol}_p95wait_s", us,
                            f"{p95[pol]:.1f}", (p95[pol],), ()))
        for base in ("fcfs", "easy"):
            ratio = mean["plan"] / max(mean[base], 1e-9)
            rows.append(Row(f"batch_{tag}_plan_vs_{base}", us,
                            f"{ratio:.3f}x mean wait (<1 = plan waits less)",
                            (ratio,), ()))

    # The admitted plan timeline, end to end through the serving plane.
    exp, horizon = bridge_exp
    horizon = min(horizon, seconds)
    run_exp = Experiment(policy="job-fair", scheduler="themis",
                         n_servers=exp.n_servers, max_jobs=exp.max_jobs,
                         device=device).add_jobs(exp.jobs)
    t0 = time.time()
    res = run_exp.run(horizon)
    us = f"{(time.time() - t0) * 1e6:.0f}"
    gbps = res.mean_gbps(None, 0.05 * horizon, horizon)
    rows.append(Row("batch_bridge_themis_gbps", us,
                    f"{gbps:.2f} (bb-heavy plan timeline, {res.n_jobs} jobs)",
                    (gbps,), ()))
    return rows

"""Shared helpers of the port's figure rows (the counterpart of the
reference's ``benchmarks/common.py``).

Every simulation goes through :class:`repro_torch.api.Experiment`; a
variant's seeds run as lanes of one tick loop (``Experiment.run_batch``).
A row is the reference's ``(name, us_per_call, derived)`` plus the numbers
behind ``derived``: the seed means and coefficients of variation.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import NamedTuple

from ..api import BatchRunResult, Experiment
from ..core import metrics

DEFAULT_SEEDS = tuple(range(8))

#: The reference's rows at the duration and seeds ``chip_smoke.py`` uses.
REFERENCE_FILE = pathlib.Path(__file__).with_name("fig_reference.json")


class Row(NamedTuple):
    name: str
    us_per_call: str
    derived: str
    means: tuple      # seed means of the numbers ``derived`` shows
    covs: tuple       # their coefficients of variation (empty: a ratio of rows)


def bench_seconds(default: float = 60.0) -> float:
    """Simulated duration; ``BENCH_SECONDS`` overrides."""
    return float(os.environ.get("BENCH_SECONDS", default))


def bench_seeds(default=DEFAULT_SEEDS) -> tuple:
    """Seed set; ``BENCH_SEEDS=n`` overrides with ``range(n)``."""
    n = int(os.environ.get("BENCH_SEEDS", "0"))
    return tuple(range(n)) if n > 0 else tuple(default)


def simulate_batch(scheduler, jobs, seconds, *, seeds=DEFAULT_SEEDS,
                   policy="job-fair", n_servers=1, device="cuda", **cfg_kw):
    """``len(seeds)`` simulations as lanes of one loop -> (batch, config).
    ``cfg_kw`` mixes Experiment knobs and raw EngineConfig fields, as in
    the reference."""
    exp = Experiment(policy=policy, scheduler=scheduler, n_servers=n_servers,
                     device=device, **cfg_kw).add_jobs(jobs)
    return exp.run_batch(seconds, seeds=seeds), exp.engine_config()


def sweep(variants: dict, seconds, *, seeds=DEFAULT_SEEDS, device="cuda"):
    """``{label: simulate_batch kwargs}`` -> ``{label: (batch, cfg,
    seconds_spent)}``, one batched run per variant."""
    out = {}
    for name, kw in variants.items():
        t0 = time.time()
        batch, cfg = simulate_batch(seconds=seconds, seeds=seeds,
                                    device=device, **kw)
        out[name] = (batch, cfg, time.time() - t0)
    return out


def seed_stat(batch: BatchRunResult, fn) -> tuple[float, float]:
    """Mean and coefficient of variation of ``fn(RunResult)`` over seeds."""
    return metrics.mean_cov(batch.seed_metric(fn))


def fmt_stat(mean: float, cov: float) -> str:
    return f"{mean:.2f} cov {cov * 100:.1f}%"


def load_reference() -> dict:
    """``fig_reference.json``: ``{"rows": {name: {"means", "covs"}}, ...}``."""
    return json.loads(REFERENCE_FILE.read_text())

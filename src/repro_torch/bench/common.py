"""Shared helpers of the port's benchmark rows (the counterpart of the
reference's ``benchmarks/common.py``).

Every simulation goes through :class:`repro_torch.api.Experiment`: one run
(:func:`simulate`), or a variant's seeds as lanes of one tick loop
(:func:`simulate_batch`).  Each is logged into :data:`RUN_LOG` (scheduler,
params hash, dropped / idle-worker counters, seconds, seeds), which
``repro_torch.bench.run --json`` embeds as a section's ``runs`` block.  A
row is the reference's ``(name, us_per_call, derived)`` plus the numbers
behind ``derived``: the seed means and coefficients of variation (empty for
a single run's row).
"""
from __future__ import annotations

import json
import os
import pathlib
import platform
import time
from typing import NamedTuple

import numpy as np
import torch

from ..api import BatchRunResult, Experiment, RunResult
from ..core import metrics

DEFAULT_SEEDS = tuple(range(8))

#: The reference's rows at the duration and seeds ``chip_smoke.py`` uses.
REFERENCE_FILE = pathlib.Path(__file__).with_name("fig_reference.json")
#: The reference's fig7/9/13/14 and calibration rows and runs at the card's
#: and the tests' depths, and the kern and micro row names
#: (``tools/record_figure_reference.py --paper``).
PAPER_REFERENCE_FILE = REFERENCE_FILE.with_name("paper_reference.json")


class Row(NamedTuple):
    name: str
    us_per_call: str
    derived: str
    means: tuple = ()  # seed means of the numbers ``derived`` shows
    covs: tuple = ()   # their coefficients of variation (empty: one run, or
                       # a ratio of rows)


#: One entry per :func:`simulate` / :func:`simulate_batch` call since the
#: last :func:`drain_run_log`: ``RunResult.counters()`` plus ``seconds``,
#: the per-job ``issued`` and ``completed`` counts (summed over seeds) and,
#: for a batch, ``seeds``.
RUN_LOG: list[dict] = []


def drain_run_log() -> list[dict]:
    out = list(RUN_LOG)
    RUN_LOG.clear()
    return out


def log_run(res: RunResult, seconds: float, seeds=None) -> None:
    entry = dict(res.counters(), seconds=float(seconds))
    lead = tuple(range(np.ndim(res.issued) - 1))
    entry["issued"] = np.asarray(res.issued).sum(axis=lead).tolist()
    entry["completed"] = np.asarray(res.completed).sum(axis=lead).tolist()
    if seeds is not None:
        entry["seeds"] = [int(s) for s in seeds]
    RUN_LOG.append(entry)


def bench_env(device: str = "cuda") -> dict:
    """The environment block of every ``--json`` document: the ``BENCH_*``
    shrink knobs, and where the reference keeps ``XLA_FLAGS``, the versions
    of torch and CUDA and the device the rows were measured on."""
    env = {k: os.environ[k] for k in sorted(os.environ)
           if k.startswith("BENCH_")}
    env["torch"] = torch.__version__
    env["cuda"] = torch.version.cuda or "none"
    dev = torch.device(device)
    env["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else f"cpu {platform.processor()}".strip())
    return env


def experiment(scheduler, jobs, *, policy="job-fair", n_servers=1,
               device="cuda", **cfg_kw) -> Experiment:
    """The facade spec a benchmark variant runs on; ``cfg_kw`` mixes
    Experiment knobs and raw EngineConfig fields, as in the reference."""
    return Experiment(policy=policy, scheduler=scheduler, n_servers=n_servers,
                      device=device, **cfg_kw).add_jobs(jobs)


def simulate(scheduler, jobs, seconds, *, policy="job-fair", n_servers=1,
             device="cuda", **cfg_kw):
    """One run -> (RunResult, engine config), logged into :data:`RUN_LOG`."""
    exp = experiment(scheduler, jobs, policy=policy, n_servers=n_servers,
                     device=device, **cfg_kw)
    res = exp.run(seconds)
    log_run(res, seconds)
    return res, exp.engine_config()


def emit(rows) -> None:
    """Print ``name,us_per_call,derived`` CSV rows."""
    for r in rows:
        print(f"{r[0]},{r[1]},{r[2]}")


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
    exp = experiment(scheduler, jobs, policy=policy, n_servers=n_servers,
                     device=device, **cfg_kw)
    batch = exp.run_batch(seconds, seeds=seeds)
    log_run(batch, seconds, seeds=seeds)
    return batch, exp.engine_config()


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


def load_paper_reference() -> dict:
    """``paper_reference.json``: ``{"scales", "card": {section: {"scale",
    "rows": {name: derived}, "runs": [...]}, "calibrate": ...}, "test":
    ..., "names": {section: [row names]}}``."""
    return json.loads(PAPER_REFERENCE_FILE.read_text())

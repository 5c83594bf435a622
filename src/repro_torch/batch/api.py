"""`BatchExperiment` — the batch plane's facade, sibling of `Experiment`
(the port's copy of the reference's ``repro.batch.api``).

One spec (a queue preset name, a :class:`~repro_torch.batch.queue.BatchQueue`,
or raw job dicts), three policies::

    from repro_torch.api import BatchExperiment   # or Experiment.batch(...)

    bx = BatchExperiment("bb-heavy", n_jobs=24, seed=0)   # device="cuda"
    res = bx.run("plan")                    # or "fcfs" / "easy"
    res.mean_wait_s, res.p95_wait_s, res.mean_bsld

    table = bx.compare()                    # all three, one queue
    exp, horizon = bx.to_experiment(res, scheduler="themis")
    exp.run(horizon)                        # serving plane, end-to-end

``device`` (default ``"cuda"``) is where FCFS's list schedule, the annealer
and the bridged Experiment run; EASY is a host loop.  Every run is
validated against the capacity oracle before it is returned.
``sweep_seeds`` records per-seed campaign rows through
:mod:`repro_torch.workspace` keyed on the queue-spec hash
(:mod:`repro_torch.batch.campaign`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from ..core.params import PlanOptParams
from . import bridge
from .plan import plan_schedule
from .queue import (BatchQueue, ClusterSpec, make_queue, queue_preset,
                    queue_presets)
from .sim import simulate_easy, simulate_fcfs, validate_schedule, wait_metrics

#: The batch plane's policy registry.
BATCH_POLICIES = ("fcfs", "easy", "plan")


@dataclasses.dataclass(frozen=True)
class BatchResult:
    """One scheduled queue: the timeline plus its objectives."""

    policy: str
    queue: BatchQueue
    start: np.ndarray               # [N] f64 per-job start (original order)
    order: Optional[np.ndarray]     # plan permutation (None for baselines)
    seed: int
    metrics: Dict[str, float]

    def __getattr__(self, name):
        # res.mean_wait_s etc. — the metrics dict, attribute-spelled
        m = object.__getattribute__(self, "metrics")
        if name in m:
            return m[name]
        raise AttributeError(name)

    @property
    def wait_s(self) -> np.ndarray:
        return np.maximum(self.start - self.queue.arrays()["submit"], 0.0)


class BatchExperiment:
    """Build once, run any batch policy on the identical queue."""

    def __init__(self, queue: str | BatchQueue | Iterable = "bb-heavy", *,
                 cluster: Optional[ClusterSpec] = None, n_jobs: int = 32,
                 params: Optional[PlanOptParams] = None, seed: int = 0,
                 device: str = "cuda"):
        if isinstance(queue, BatchQueue):
            if cluster is not None:
                raise ValueError("pass cluster inside the BatchQueue, "
                                 "not both")
            self.queue = queue
        elif isinstance(queue, str):
            self.queue = queue_preset(queue, n_jobs=n_jobs, seed=seed,
                                      cluster=cluster)
        else:
            self.queue = make_queue(queue, cluster)
        self.params = params if params is not None else PlanOptParams()
        if type(self.params) is not PlanOptParams:
            raise TypeError(f"params must be PlanOptParams, got "
                            f"{type(self.params).__name__}")
        self.seed = int(seed)
        self.device = device

    # -- runs -----------------------------------------------------------------

    def run(self, policy: str = "plan", *,
            seed: Optional[int] = None) -> BatchResult:
        """Schedule the queue under ``policy``; validated before returning.
        ``seed`` only affects ``plan`` (the SA stream); defaults to the
        experiment seed."""
        if policy not in BATCH_POLICIES:
            raise ValueError(
                f"unknown batch policy {policy!r}; have {BATCH_POLICIES}")
        s = self.seed if seed is None else int(seed)
        order = None
        if policy == "fcfs":
            start = simulate_fcfs(self.queue, device=self.device)
        elif policy == "easy":
            start = simulate_easy(self.queue)
        else:
            start, order, _ = plan_schedule(self.queue, self.params, seed=s,
                                            device=self.device)
        validate_schedule(self.queue, start)
        return BatchResult(policy=policy, queue=self.queue,
                           start=np.asarray(start, np.float64), order=order,
                           seed=s, metrics=wait_metrics(self.queue, start))

    def compare(self, policies: Sequence[str] = BATCH_POLICIES, *,
                seed: Optional[int] = None) -> Dict[str, BatchResult]:
        """All ``policies`` over the one queue — the paper-table view."""
        return {p: self.run(p, seed=seed) for p in policies}

    def sweep_seeds(self, policy: str, seeds: Sequence[int], *,
                    store=None, campaign: str = "batch"):
        """Per-seed results; with ``store`` they are workspace-cached keyed
        on the queue-spec hash (resumable — see
        :func:`repro_torch.batch.campaign.run_batch_campaign`)."""
        if store is None:
            return [self.run(policy, seed=s) for s in seeds]
        from .campaign import run_batch_campaign
        results, _report = run_batch_campaign(
            self, (policy,), seeds, store=store, campaign=campaign)
        return [results[(policy, int(s))] for s in seeds]

    # -- bridge to the serving planes -----------------------------------------

    def to_scenario(self, result: BatchResult, *,
                    name: str = "batch-admitted",
                    horizon_s: float = bridge.DEFAULT_HORIZON_S):
        return bridge.to_scenario(self.queue, result.start, name=name,
                                  horizon_s=horizon_s)

    def to_experiment(self, result: BatchResult, *,
                      scheduler: str = "themis", policy: str = "job-fair",
                      horizon_s: float = bridge.DEFAULT_HORIZON_S,
                      **experiment_kw) -> Tuple["object", float]:
        """The admitted timeline as an Experiment on this batch
        experiment's device (unless ``experiment_kw`` names another)."""
        experiment_kw.setdefault("device", self.device)
        return bridge.to_experiment(self.queue, result.start,
                                    scheduler=scheduler, policy=policy,
                                    horizon_s=horizon_s, **experiment_kw)

    # -- identity -------------------------------------------------------------

    def queue_hash(self) -> str:
        return self.queue.queue_hash()

    @staticmethod
    def presets() -> Tuple[str, ...]:
        return queue_presets()

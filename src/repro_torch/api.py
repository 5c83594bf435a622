"""Experiment facade of the port: one spec, the engine on the card.

    from repro_torch.api import Experiment

    res = (Experiment(policy="user-fair", scheduler="themis", n_servers=2)
           .add_job(user=0, size=2, req_mb=8)
           .add_job(user=1, size=1, req_mb=10, start_s=0.5)
           .run(2.0))
    res.mean_gbps(0), res.jain_fairness()

:class:`Experiment` and :class:`RunResult` follow the reference ``repro.api``.
``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the plain
versions of the kernels.  Every other public member of the reference's
``RunResult`` and ``Experiment`` is not ported yet and raises
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports it: the
metrics ``job_gbps``/``cov_gbps``/``counters``, the scenario builders, the
batch/sweep runs, ``solo`` and the functional and batch planes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from .core import metrics
from .core.engine import EngineConfig, make_workload, run
from .core.params import SchedulerParams
from .core.policy import Policy
from .core.scheduler import get_scheduler
from .scenario.lowering import normalize_phases


def _not_ported(name: str, item: int):
    raise NotImplementedError(f"{name} is not ported to repro_torch yet "
                              f"(ROADMAP.md section 1, item {item})")


_LEGACY_KEYS = ("gbps", "bin_s", "issued", "completed", "dropped",
                "idle_worker_ticks", "ticks", "state")


@dataclasses.dataclass(frozen=True)
class RunResult:
    """Structured outcome of one engine run (``J`` job slots, ``NB`` bins;
    the first :attr:`n_jobs` slots are the declared jobs)."""

    scheduler: str
    params: SchedulerParams
    policy: Optional[str]
    n_jobs: int
    seconds: float
    gbps: np.ndarray              # f32[J, NB] per-bin throughput (GB/s)
    bin_s: float
    issued: np.ndarray            # i32[J]
    completed: np.ndarray         # i32[J]
    dropped: int
    idle_worker_ticks: int
    ticks: int
    state: object = dataclasses.field(default=None, repr=False)

    def __getitem__(self, key):
        if key in _LEGACY_KEYS:
            return getattr(self, key)
        raise KeyError(key)

    def _window(self, t0: float, t1: Optional[float]) -> slice:
        b1 = self.gbps.shape[-1] if t1 is None else int(t1 / self.bin_s)
        return slice(int(t0 / self.bin_s), b1)

    def mean_gbps(self, job: Optional[int] = None, t0: float = 0.0,
                  t1: Optional[float] = None) -> float:
        """Mean throughput over a window — one job, or the aggregate."""
        g = self.gbps.sum(axis=0) if job is None else self.gbps[job]
        w = g[self._window(t0, t1)]
        return float(w.mean()) if w.size else 0.0

    def jain_fairness(self, t0: float = 0.0, t1: Optional[float] = None,
                      jobs: Optional[Sequence[int]] = None) -> float:
        """Jain index over per-job mean throughput in the window (default:
        every declared job that issued a request)."""
        if jobs is None:
            jobs = [j for j in range(self.n_jobs) if self.issued[j] > 0]
        return metrics.jain_index([self.mean_gbps(j, t0, t1) for j in jobs])

    def slowdown(self, solo: "RunResult", job: int = 0, t0: float = 0.0,
                 t1: Optional[float] = None) -> float:
        """``solo_mean / shared_mean`` of ``job``; ``inf`` when starved."""
        shared = self.mean_gbps(job, t0, t1)
        alone = solo.mean_gbps(0 if solo.n_jobs == 1 else job, t0, t1)
        return alone / shared if shared > 0 else float("inf")

    def params_hash(self) -> str:
        return self.params.params_hash()

    def job_gbps(self, job: int):
        _not_ported("RunResult.job_gbps", 1)

    def cov_gbps(self, job=None, t0=0.0, t1=None):
        _not_ported("RunResult.cov_gbps", 1)

    def counters(self):
        _not_ported("RunResult.counters", 1)


class Experiment:
    """A policy × scheduler × workload spec run on the port's engine.
    ``add_job``/``add_jobs`` return ``self`` for chaining."""

    def __init__(self, policy: Optional[str | Policy] = None,
                 scheduler: str = "themis", *,
                 params: Optional[SchedulerParams] = None,
                 n_servers: int = 1, n_workers: int = 8,
                 server_bw: float = 22e9, max_jobs: Optional[int] = None,
                 seed: int = 0, device: str = "cuda", **engine_kw):
        self.scheduler = scheduler
        self.sched = get_scheduler(scheduler)
        if params is not None and type(params) is not self.sched.params_cls:
            raise TypeError(
                f"scheduler {scheduler!r} expects exactly "
                f"{self.sched.params_cls.__name__}, got {type(params).__name__}")
        self.params = params
        self.policy = (Policy.parse(policy) if isinstance(policy, str)
                       else policy)
        if self.policy is None and self.sched.uses_segments:
            self.policy = Policy.parse("job-fair")
        self.n_servers = n_servers
        self.n_workers = n_workers
        self.server_bw = server_bw
        self.max_jobs = max_jobs
        self.seed = seed
        self.device = device
        self.engine_kw = engine_kw
        self.jobs: list[dict] = []

    def add_job(self, *, user: int = 0, group: int = 0, size: int = 1,
                priority: float = 1.0, procs: Optional[int] = None,
                req_mb: float = 10.0, start_s: float = 0.0,
                end_s: Optional[float] = None, think_s: float = 0.0,
                servers: Optional[Sequence[int]] = None,
                overhead_us: float = 0.0,
                arrival: Optional[str] = None,
                interval_s: Optional[float] = None,
                rate_hz: Optional[float] = None,
                phases: Optional[Sequence[dict]] = None) -> "Experiment":
        """Declare one job; ``procs`` defaults to ``size * 56`` client
        processes and ``end_s`` to the whole run."""
        spec = dict(user=user, group=group, size=size, priority=priority,
                    req_mb=req_mb, start_s=start_s, think_s=think_s,
                    overhead_us=overhead_us)
        optional = dict(procs=procs, end_s=end_s, arrival=arrival,
                        interval_s=interval_s, rate_hz=rate_hz)
        spec.update({k: v for k, v in optional.items() if v is not None})
        if servers is not None:
            spec["servers"] = list(servers)
        if phases is not None:
            spec["phases"] = [dict(ph) for ph in phases]
        normalize_phases(spec, f"job {len(self.jobs)}")
        self.jobs.append(spec)
        return self

    def add_jobs(self, specs: Iterable[dict]) -> "Experiment":
        """Bulk :meth:`add_job` over raw job spec dicts (validated here)."""
        for spec in specs:
            normalize_phases(spec, f"job {len(self.jobs)}")
            self.jobs.append(copy.deepcopy(dict(spec)))
        return self

    def phase(self, job=None, **kw):
        _not_ported("Experiment.phase", 6)

    def bursts(self, job=None, **kw):
        _not_ported("Experiment.bursts", 6)

    def ramp(self, job=None, **kw):
        _not_ported("Experiment.ramp", 6)

    def arrivals(self, **kw):
        _not_ported("Experiment.arrivals", 1)

    def scenario(self, name: str = ""):
        _not_ported("Experiment.scenario", 6)

    def to_json(self, name: str = ""):
        _not_ported("Experiment.to_json", 6)

    @classmethod
    def from_scenario(cls, scenario, **kw):
        _not_ported("Experiment.from_scenario", 6)

    @staticmethod
    def batch(queue="bb-heavy", **kw):
        _not_ported("Experiment.batch", 8)

    def _slots(self) -> int:
        return self.max_jobs if self.max_jobs else max(8, len(self.jobs))

    def engine_config(self) -> EngineConfig:
        return EngineConfig(
            n_servers=self.n_servers, max_jobs=self._slots(),
            n_workers=self.n_workers, server_bw=self.server_bw,
            scheduler=self.scheduler, scheduler_params=self.params,
            policy=self.policy if self.sched.uses_segments else None,
            seed=self.seed, device=self.device, **self.engine_kw)

    def build(self):
        """(cfg, workload, job_table) — escape hatch to the raw engine API."""
        cfg = self.engine_config()
        wl, table = make_workload(cfg, self.jobs)
        return cfg, wl, table

    def resolved_params(self):
        _not_ported("Experiment.resolved_params", 1)

    def run(self, seconds: float) -> RunResult:
        """One engine run -> :class:`RunResult`."""
        if not self.jobs:
            raise ValueError("run() needs at least one add_job()")
        cfg, wl, table = self.build()
        raw = run(cfg, wl, table, seconds)
        return RunResult(
            scheduler=self.scheduler, params=self.sched.params(cfg),
            policy=self.policy.name or None if self.policy else None,
            n_jobs=len(self.jobs), seconds=seconds, gbps=raw["gbps"],
            bin_s=raw["bin_s"], issued=raw["issued"],
            completed=raw["completed"], dropped=raw["dropped"],
            idle_worker_ticks=raw["idle_worker_ticks"], ticks=raw["ticks"],
            state=raw["state"])

    def run_batch(self, seconds: float, seeds=tuple(range(8))):
        _not_ported("Experiment.run_batch (loop over run() with seed=)", 4)

    def sweep(self, grid, seconds: float, seeds=tuple(range(4)), **kw):
        _not_ported("Experiment.sweep", 4)

    def solo(self, job: int, seconds: float, **kw):
        _not_ported("Experiment.solo", 1)

    def serve(self, **kw):
        _not_ported("Experiment.serve (the functional plane)", 8)

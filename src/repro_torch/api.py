"""Experiment facade of the port: one spec, the engine on the card.

    from repro_torch.api import Experiment

    res = (Experiment(policy="user-fair", scheduler="themis", n_servers=2)
           .add_job(user=0, size=2, req_mb=8)
           .add_job(user=1, size=1, req_mb=10, start_s=0.5)
           .run(2.0))
    res.mean_gbps(0), res.jain_fairness()

:class:`Experiment` and :class:`RunResult` follow the reference ``repro.api``.
``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the plain
versions of the kernels.  ``run_batch`` and ``sweep`` run their seeds and
grid points as lanes of one tick loop (:func:`repro_torch.core.engine.run_batch`)
and return :class:`BatchRunResult` / :class:`SweepResult`.  The public
members of the reference's ``Experiment`` that are not ported yet raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them: the
scenario builders (item 6), the functional and batch planes and the
workspace (item 8).
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from .core import metrics
from .core.engine import EngineConfig, make_workload, run, run_batch
from .core.params import SchedulerParams
from .core.policy import Policy
from .core.scheduler import get_scheduler
from .scenario.lowering import normalize_phases


def _not_ported(name: str, item: int):
    raise NotImplementedError(f"{name} is not ported to repro_torch yet "
                              f"(ROADMAP.md section 1, item {item})")


_LEGACY_KEYS = ("gbps", "bin_s", "issued", "completed", "dropped",
                "idle_worker_ticks", "ticks", "state", "seeds")


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
            try:
                return getattr(self, key)
            except AttributeError:       # e.g. 'seeds' on a non-batch result
                raise KeyError(key) from None
        raise KeyError(key)

    def _window(self, t0: float, t1: Optional[float]) -> slice:
        b1 = self.gbps.shape[-1] if t1 is None else int(t1 / self.bin_s)
        return slice(int(t0 / self.bin_s), b1)

    def job_gbps(self, job: int) -> np.ndarray:
        """Per-bin throughput trace (GB/s) of one job."""
        return self.gbps[job]

    def mean_gbps(self, job: Optional[int] = None, t0: float = 0.0,
                  t1: Optional[float] = None) -> float:
        """Mean throughput over a window — one job, or the aggregate."""
        g = self.gbps.sum(axis=0) if job is None else self.gbps[job]
        w = g[self._window(t0, t1)]
        return float(w.mean()) if w.size else 0.0

    def cov_gbps(self, job: Optional[int] = None, t0: float = 0.0,
                 t1: Optional[float] = None) -> float:
        """Per-bin coefficient of variation (std/mean) over a window — the
        shape the paper's variance claims are stated in."""
        g = self.gbps.sum(axis=0) if job is None else self.gbps[job]
        w = g[self._window(t0, t1)]
        m = float(w.mean()) if w.size else 0.0
        return float(w.std()) / m if m else 0.0

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

    def counters(self) -> dict:
        """The attribution block a benchmark artifact embeds per run."""
        return {
            "scheduler": self.scheduler,
            "policy": self.policy,
            "params_hash": self.params_hash(),
            "dropped": int(np.asarray(self.dropped).sum()),
            "idle_worker_ticks": int(np.asarray(self.idle_worker_ticks).sum()),
        }


@dataclasses.dataclass(frozen=True)
class BatchRunResult(RunResult):
    """A :func:`repro_torch.core.engine.run_batch` outcome: every array
    gains a leading ``K = len(seeds)`` axis; each lane equals a sequential
    run with that seed."""

    seeds: np.ndarray = dataclasses.field(default=None)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    # The inherited per-run metrics would index the seed axis as the job
    # axis (gbps here is [K, J, NB]); refuse instead of mis-answering.
    def _per_run_only(self, name: str):
        raise TypeError(
            f"{name}() is a per-run metric; on a batch use "
            f"seed_result(k).{name}(...) or mean_cov(lambda r: r.{name}(...))")

    def job_gbps(self, job):
        self._per_run_only("job_gbps")

    def mean_gbps(self, job=None, t0=0.0, t1=None):
        self._per_run_only("mean_gbps")

    def cov_gbps(self, job=None, t0=0.0, t1=None):
        self._per_run_only("cov_gbps")

    def jain_fairness(self, t0=0.0, t1=None, jobs=None):
        self._per_run_only("jain_fairness")

    def slowdown(self, solo, job=0, t0=0.0, t1=None):
        self._per_run_only("slowdown")

    def seed_result(self, k: int) -> RunResult:
        """Slice one seed lane into a plain :class:`RunResult`."""
        return RunResult(
            scheduler=self.scheduler, params=self.params, policy=self.policy,
            n_jobs=self.n_jobs, seconds=self.seconds,
            gbps=self.gbps[k], bin_s=self.bin_s,
            issued=self.issued[k], completed=self.completed[k],
            dropped=int(self.dropped[k]),
            idle_worker_ticks=int(self.idle_worker_ticks[k]),
            ticks=self.ticks)

    def per_seed(self) -> list[RunResult]:
        return [self.seed_result(k) for k in range(self.n_seeds)]

    def seed_metric(self, fn) -> list[float]:
        """Evaluate ``fn(RunResult)`` on every lane."""
        return [fn(r) for r in self.per_seed()]

    def mean_cov(self, fn) -> tuple[float, float]:
        """Mean and coefficient of variation of a per-seed metric."""
        return metrics.mean_cov(self.seed_metric(fn))


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Outcome of :meth:`Experiment.sweep`: P param points × K seeds, run as
    lanes of one tick loop.  Every array leads with ``[P, K]``;
    ``points[i]`` is the params instance of grid point ``i``."""

    scheduler: str
    policy: Optional[str]
    points: tuple                 # SchedulerParams per grid point
    seeds: np.ndarray
    n_jobs: int
    seconds: float
    gbps: np.ndarray              # f32[P, K, J, NB]
    bin_s: float
    issued: np.ndarray            # i32[P, K, J]
    completed: np.ndarray         # i32[P, K, J]
    dropped: np.ndarray           # i32[P, K]
    idle_worker_ticks: np.ndarray  # i32[P, K]
    ticks: int

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_seeds(self) -> int:
        return len(self.seeds)

    def point(self, i: int) -> SchedulerParams:
        return self.points[i]

    def point_result(self, i: int) -> BatchRunResult:
        """Slice one grid point into a :class:`BatchRunResult`."""
        return BatchRunResult(
            scheduler=self.scheduler, params=self.points[i],
            policy=self.policy, n_jobs=self.n_jobs, seconds=self.seconds,
            gbps=self.gbps[i], bin_s=self.bin_s, issued=self.issued[i],
            completed=self.completed[i], dropped=self.dropped[i],
            idle_worker_ticks=self.idle_worker_ticks[i], ticks=self.ticks,
            seeds=self.seeds)

    def per_point(self) -> list[BatchRunResult]:
        return [self.point_result(i) for i in range(self.n_points)]

    def point_mean_cov(self, fn) -> tuple[np.ndarray, np.ndarray]:
        """Per-point (mean[P], cov[P]) of ``fn(RunResult)`` over the seeds."""
        pairs = [b.mean_cov(fn) for b in self.per_point()]
        means, covs = zip(*pairs)
        return np.asarray(means), np.asarray(covs)

    def jain_fairness(self, t0: float = 0.0, t1: Optional[float] = None):
        """Per-point (mean, cov) of the Jain index over the window."""
        return self.point_mean_cov(lambda r: r.jain_fairness(t0, t1))

    def mean_gbps(self, job: Optional[int] = None, t0: float = 0.0,
                  t1: Optional[float] = None):
        """Per-point (mean, cov) of mean throughput (one job or aggregate)."""
        return self.point_mean_cov(lambda r: r.mean_gbps(job, t0, t1))

    def cov_gbps(self, job: Optional[int] = None, t0: float = 0.0,
                 t1: Optional[float] = None):
        """Per-point (mean, cov) of the per-bin throughput CoV."""
        return self.point_mean_cov(lambda r: r.cov_gbps(job, t0, t1))

    def slowdown(self, solo: RunResult, job: int = 0, t0: float = 0.0,
                 t1: Optional[float] = None):
        """Per-point (mean, cov) slowdown of ``job`` vs a solo baseline."""
        return self.point_mean_cov(lambda r: r.slowdown(solo, job, t0, t1))

    def summary(self, t0: float = 0.0, t1: Optional[float] = None,
                solo: Optional[RunResult] = None, job: int = 0) -> list[dict]:
        """One JSON-ready dict per grid point: numeric fields, params hash,
        Jain / aggregate throughput / CoV (and slowdown with ``solo``) as
        seed-mean ± cov."""
        jain_m, jain_c = self.jain_fairness(t0, t1)
        thr_m, thr_c = self.mean_gbps(None, t0, t1)
        cov_m, _ = self.cov_gbps(job, t0, t1)
        sd_m = sd_c = None
        if solo is not None:
            sd_m, sd_c = self.slowdown(solo, job, t0, t1)
        rows = []
        for i, p in enumerate(self.points):
            row = {"point": i, "params_hash": p.params_hash(),
                   "scheduler": self.scheduler}
            row.update({f: float(getattr(p, f)) for f in p.numeric_fields()})
            row.update(jain_mean=float(jain_m[i]), jain_cov=float(jain_c[i]),
                       gbps_mean=float(thr_m[i]), gbps_cov=float(thr_c[i]),
                       cov_gbps=float(cov_m[i]),
                       dropped=int(self.dropped[i].sum()),
                       idle_worker_ticks=int(self.idle_worker_ticks[i].sum()))
            if sd_m is not None:
                row.update(slowdown_mean=float(sd_m[i]),
                           slowdown_cov=float(sd_c[i]))
            rows.append(row)
        return rows

    def argbest(self, fn, mode: str = "max") -> int:
        """Grid point index optimizing the seed-mean of ``fn(RunResult)``."""
        means, _ = self.point_mean_cov(fn)
        return int(np.argmax(means) if mode == "max" else np.argmin(means))


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

    def _job_index(self, job: Optional[int], method: str) -> int:
        """The job index ``method`` targets: ``job=i`` (range-checked at
        call time) or the most recently declared job."""
        if not self.jobs:
            raise ValueError(f"{method}() needs at least one add_job() first")
        if job is None:
            return len(self.jobs) - 1
        if not 0 <= job < len(self.jobs):
            raise IndexError(
                f"{method}(job={job}): experiment declares "
                f"{len(self.jobs)} job(s) (valid: 0..{len(self.jobs) - 1})")
        return job

    def arrivals(self, *, job: Optional[int] = None,
                 start_s: Optional[float] = None,
                 end_s: Optional[float] = None,
                 think_s: Optional[float] = None,
                 arrival: Optional[str] = None,
                 interval_s: Optional[float] = None,
                 rate_hz: Optional[float] = None) -> "Experiment":
        """Adjust arrival timing/mode of one declared job (``job=i``) or of
        every declared job, without re-stating the rest of its spec;
        ``arrival``/``interval_s``/``rate_hz`` switch the flat window
        open-loop.  ``start_s``/``end_s`` are refused on a job with explicit
        phases.  A failure leaves every job as it was."""
        if not self.jobs:
            raise ValueError("arrivals() needs at least one add_job() first")
        if job is None:
            targets = list(range(len(self.jobs)))
        else:
            targets = [self._job_index(job, "arrivals")]
        updates = dict(start_s=start_s, end_s=end_s, think_s=think_s,
                       arrival=arrival, interval_s=interval_s,
                       rate_hz=rate_hz)
        if start_s is not None or end_s is not None:
            for j in targets:
                if self.jobs[j].get("phases"):
                    raise ValueError(
                        f"arrivals(job={j}): job has explicit phases, which "
                        f"define its start/end windows; adjust the phases "
                        f"(start_s/end_s here would be silently ignored)")
        before = {j: copy.deepcopy(self.jobs[j]) for j in targets}
        try:
            for j in targets:
                spec = self.jobs[j]
                spec.update({k: v for k, v in updates.items()
                             if v is not None})
                normalize_phases(spec, f"job {j}")
        except Exception:
            for j, saved in before.items():
                self.jobs[j].clear()
                self.jobs[j].update(saved)
            raise
        return self

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

    def resolved_params(self) -> SchedulerParams:
        return self.sched.params(self.engine_config())

    def _policy_name(self) -> Optional[str]:
        return self.policy.name or None if self.policy else None

    def run(self, seconds: float) -> RunResult:
        """One engine run -> :class:`RunResult`."""
        if not self.jobs:
            raise ValueError("run() needs at least one add_job()")
        cfg, wl, table = self.build()
        raw = run(cfg, wl, table, seconds)
        return RunResult(
            scheduler=self.scheduler, params=self.sched.params(cfg),
            policy=self._policy_name(), n_jobs=len(self.jobs),
            seconds=seconds, gbps=raw["gbps"], bin_s=raw["bin_s"],
            issued=raw["issued"], completed=raw["completed"],
            dropped=raw["dropped"],
            idle_worker_ticks=raw["idle_worker_ticks"], ticks=raw["ticks"],
            state=raw["state"])

    def run_batch(self, seconds: float,
                  seeds: Sequence[int] = tuple(range(8))) -> BatchRunResult:
        """The PRNG ``seeds`` as lanes of one tick loop ->
        :class:`BatchRunResult` (each lane equals ``run()`` with that seed)."""
        if not self.jobs:
            raise ValueError("run_batch() needs at least one add_job()")
        cfg, wl, table = self.build()
        raw = run_batch(cfg, wl, table, seconds, seeds=seeds)
        return BatchRunResult(
            scheduler=self.scheduler, params=self.sched.params(cfg),
            policy=self._policy_name(), n_jobs=len(self.jobs),
            seconds=seconds, gbps=raw["gbps"], bin_s=raw["bin_s"],
            issued=raw["issued"], completed=raw["completed"],
            dropped=raw["dropped"],
            idle_worker_ticks=raw["idle_worker_ticks"], ticks=raw["ticks"],
            state=raw["state"], seeds=raw["seeds"])

    def _expand_grid(self, grid) -> list[SchedulerParams]:
        """A grid is a sequence of params instances, or a mapping
        ``{field: values}`` expanded as a cross product over this spec's
        base params (``params=`` at construction, else the defaults)."""
        cls = self.sched.params_cls
        if isinstance(grid, Mapping):
            base = self.params if self.params is not None else cls()
            names = list(grid)
            unknown = [n for n in names if n not in cls.numeric_fields()]
            if unknown:
                raise ValueError(
                    f"sweep grid names {unknown} are not numeric fields of "
                    f"{cls.__name__} (sweepable: {cls.numeric_fields()})")
            return [dataclasses.replace(base, **dict(zip(names, combo)))
                    for combo in itertools.product(*(grid[n] for n in names))]
        points = list(grid)
        if not points:
            raise ValueError("sweep() needs at least one grid point")
        for p in points:
            if type(p) is not cls:
                raise TypeError(
                    f"scheduler {self.scheduler!r} expects exactly "
                    f"{cls.__name__} grid points, got {type(p).__name__}")
        return points

    def sweep(self, grid, seconds: float,
              seeds: Sequence[int] = tuple(range(4)), *,
              workspace=None, campaign: str = "sweep",
              chunk: Optional[int] = None) -> SweepResult:
        """P grid points × K seeds as lanes of one tick loop.  ``grid`` is a
        sequence of params instances or a ``{field: values}`` mapping;
        structural fields (``mu_ticks``) must be the same across the grid.
        Each ``(point, seed)`` lane equals ``Experiment(params=point).run``
        with that seed.  ``workspace`` (resumable sweeps) is not ported."""
        if workspace is not None:
            _not_ported("Experiment.sweep(workspace=...)", 8)
        if not self.jobs:
            raise ValueError("sweep() needs at least one add_job()")
        points = self._expand_grid(grid)
        cfg, wl, table = self.build()
        raw = run_batch(cfg, wl, table, seconds, seeds=seeds,
                        params_points=points)
        return SweepResult(
            scheduler=self.scheduler, policy=self._policy_name(),
            points=tuple(points), seeds=raw["seeds"], n_jobs=len(self.jobs),
            seconds=seconds, gbps=raw["gbps"], bin_s=raw["bin_s"],
            issued=raw["issued"], completed=raw["completed"],
            dropped=raw["dropped"],
            idle_worker_ticks=raw["idle_worker_ticks"], ticks=raw["ticks"])

    def solo(self, job: int, seconds: float, *,
             workspace=None, name: str = "solo") -> RunResult:
        """Run one declared job alone (same engine config) — the baseline
        :meth:`RunResult.slowdown` compares against.  ``workspace``
        (cached solo runs) is not ported."""
        if workspace is not None:
            _not_ported("Experiment.solo(workspace=...)", 8)
        clone = Experiment(
            policy=self.policy, scheduler=self.scheduler, params=self.params,
            n_servers=self.n_servers, n_workers=self.n_workers,
            server_bw=self.server_bw, max_jobs=self._slots(),
            seed=self.seed, device=self.device, **self.engine_kw)
        clone.jobs = [copy.deepcopy(self.jobs[job])]
        return clone.run(seconds)

    def serve(self, **kw):
        _not_ported("Experiment.serve (the functional plane)", 8)

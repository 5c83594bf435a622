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
and return :class:`BatchRunResult` / :class:`SweepResult`.  Jobs are
phased scenarios (``phase``/``bursts``/``ramp``, :mod:`repro_torch.scenario`)
that round-trip as JSON (``scenario``/``to_json``/``from_scenario``), and
``serve()`` stands up the burst-buffer service (:mod:`repro_torch.bb`) on
the same spec, with :meth:`ExperimentService.replay` driving the scenario
through it.  ``sweep(workspace=...)`` and ``solo(workspace=...)`` resume
and cache runs in a :mod:`repro_torch.workspace` store, and
:meth:`Experiment.batch` opens the batch plane
(:class:`~repro_torch.batch.api.BatchExperiment`).

Fleet scale: any extra keyword (``**engine_kw``) flows to
:class:`~repro_torch.core.engine.EngineConfig`, the sharding knobs
included: ``Experiment(..., shard_servers=4)`` (or ``mesh_shape=(m, k)``)
splits the engine's server slabs (and the sweep grid) over the ranks of a
``torch.distributed`` world (:mod:`repro_torch.core.shard`, started by
:func:`repro_torch.launch.mesh.spawn` or ``torchrun``).  Every rank calls
``run``/``run_batch``/``sweep``/``solo`` and gets the unsharded run's
result.
"""
from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np

from .batch.api import BatchExperiment, BatchResult
from .bb.service import BBClient, BBCluster, JobMeta, phase_at
from .core import metrics
from .core.engine import EngineConfig, make_workload, run, run_batch
from .core.params import SchedulerParams
from .core.policy import Policy
from .core.scheduler import get_scheduler
from .scenario import ir as scn_ir
from .scenario.base import Scenario
from .scenario.lowering import lower_for_config, normalize_phases
from .workspace import WorkspaceStore, run_cached, run_sweep


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


@dataclasses.dataclass
class ExperimentService:
    """The functional-plane side of an :class:`Experiment`: a live
    :class:`BBCluster` plus one metadata-stamped :class:`BBClient` per
    declared job (same user/group/size/priority the engine's job table
    carries), holding the declared job specs so :meth:`replay` can drive
    the same scenario the engine compiles."""

    cluster: BBCluster
    clients: list[BBClient]
    jobs: list = dataclasses.field(default_factory=list)

    def client(self, job: int) -> BBClient:
        return self.clients[job]

    def drain(self):
        return self.cluster.drain()

    def replay(self, seconds: float, *, round_s: float = 0.25,
               reqs_per_round: int = 4,
               byte_scale: float = 1e-4) -> "ReplayResult":
        """Drive the declared scenario through the functional plane.

        Walks scenario time in ``round_s`` rounds; every job with a phase
        covering the round start submits ``reqs_per_round`` writes sized
        by that phase's ``req_mb`` (scaled by ``byte_scale`` so replays
        stay cheap — share proportions, the cross-plane observable, don't
        depend on the absolute byte count), then the round drains through
        the shared scheduler core.  Within a round, the *completion order*
        across jobs with queued demand is the same scheduler decision the
        engine's tick makes — what the cross-plane scenario tests pin."""
        n_rounds = max(1, int(round(seconds / round_s)))
        counts = np.zeros((len(self.jobs), n_rounds), np.int32)
        order: list[list[int]] = []
        # both planes walk the SAME canonical lowering: these resolved
        # phases are the ones the engine's [J, P] arrays were built from
        low = lower_for_config(self.jobs, self.cluster.cfg)
        slot_of = {c.job.job_id: j for j, c in enumerate(self.clients)}
        for j, c in enumerate(self.clients):
            c.open(f"/replay_{j}", "w")
        self.cluster.drain()
        for r in range(n_rounds):
            t0 = r * round_s
            for j, c in enumerate(self.clients):
                ph = phase_at(low.phases[j], t0)
                if ph is None:
                    continue
                nbytes = max(1, int(ph["req_mb"] * 1e6 * byte_scale))
                c.write_burst(f"/replay_{j}", reqs_per_round, nbytes)
            round_order = []
            for req in self.cluster.drain():
                if req.op == "write" and req.job.job_id in slot_of:
                    j = slot_of[req.job.job_id]
                    counts[j, r] += 1
                    round_order.append(j)
            order.append(round_order)
        return ReplayResult(counts=counts, order=order, round_s=round_s)


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """Outcome of :meth:`ExperimentService.replay`: per-round completion
    counts and, per round, the job index of every completed write in
    completion order (the drain serves everything queued, so shares live
    in the *order*, not the counts)."""

    counts: np.ndarray        # i32[n_jobs, n_rounds]
    order: list               # per round: [job, job, ...] in completion order
    round_s: float

    @property
    def n_rounds(self) -> int:
        return self.counts.shape[1]

    def rounds_between(self, t0: float, t1: float) -> range:
        return range(int(round(t0 / self.round_s)),
                     min(int(round(t1 / self.round_s)), self.n_rounds))

    def window_share(self, job: int, t0: float, t1: float,
                     k: Optional[int] = None) -> float:
        """Job's mean share of the first ``k`` completions per round over
        scenario-time window ``[t0, t1)`` (default ``k``: half the round's
        completions — the span where every submitting job still has queued
        demand, the engine-comparable regime).  Rounds with no completions
        are skipped; NaN if the window has none."""
        shares = []
        for r in self.rounds_between(t0, t1):
            seq = self.order[r]
            if not seq:
                continue
            kk = k if k is not None else max(1, len(seq) // 2)
            head = seq[:kk]
            shares.append(sum(1 for j in head if j == job) / len(head))
        return float(np.mean(shares)) if shares else float("nan")


def _phase_windows(tree) -> list[float]:
    """Start times of a single-job combinator tree's phases, in order —
    how the ``.bursts``/``.ramp`` sugar turns its tree into ``.phase``
    declarations (the windows come from the same expansion ``lower()``
    would run, so sugar and hand-built trees can't drift apart)."""
    return [ph["start_s"] for spec in scn_ir.to_jobs(tree)
            for ph in spec["phases"]]


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

    def _add_phase(self, spec: dict, where: str, *, start_s: float,
                   end_s: Optional[float], duration_s: Optional[float],
                   **fields) -> None:
        ph: dict = dict(start_s=start_s)
        if duration_s is not None:
            ph["duration_s"] = duration_s
        if end_s is not None:
            ph["end_s"] = end_s
        ph.update({k: v for k, v in fields.items() if v is not None})
        spec.setdefault("phases", []).append(ph)
        try:
            normalize_phases(spec, where)   # windows sorted, modes coherent
        except Exception:
            spec["phases"].pop()
            if not spec["phases"]:
                del spec["phases"]
            raise

    def phase(self, job: Optional[int] = None, *, start_s: float,
              duration_s: Optional[float] = None,
              end_s: Optional[float] = None,
              req_mb: Optional[float] = None,
              think_s: Optional[float] = None,
              arrival: Optional[str] = None,
              interval_s: Optional[float] = None,
              rate_hz: Optional[float] = None) -> "Experiment":
        """Append one phase to a job (default: the last declared one).

        The first :meth:`phase` call replaces the job's flat
        ``start_s..end_s`` window with the explicit phase list; omitted
        fields inherit the job-level ``req_mb``/``think_s``/arrival
        defaults.  Phases must be declared in start order and must not
        overlap."""
        j = self._job_index(job, "phase")
        self._add_phase(self.jobs[j], f"job {j}",
                        start_s=start_s, end_s=end_s, duration_s=duration_s,
                        req_mb=req_mb, think_s=think_s, arrival=arrival,
                        interval_s=interval_s, rate_hz=rate_hz)
        return self

    def bursts(self, job: Optional[int] = None, *, period_s: float,
               duty: float, start_s: float = 0.0, n: Optional[int] = None,
               end_s: Optional[float] = None,
               req_mb: Optional[float] = None,
               think_s: Optional[float] = None,
               arrival: Optional[str] = None,
               interval_s: Optional[float] = None,
               rate_hz: Optional[float] = None) -> "Experiment":
        """ON/OFF sugar (checkpoint/restart loops): every ``period_s``, an
        ON window of ``duty * period_s`` seconds, repeated ``n`` times (or
        until ``end_s``).  Each ON window is one :meth:`phase`; the gaps
        are idle — the shape behind the paper's opportunity-fairness and
        §5.5 bursty-application claims."""
        if not 0.0 < duty <= 1.0:
            raise ValueError(f"bursts(): duty must be in (0, 1], got {duty}")
        if (n is None) == (end_s is None):
            raise ValueError("bursts(): give exactly one of n= or end_s=")
        if n is None:
            # every burst whose ON window fits before end_s, including one
            # that ends exactly there (floor((end-start)/period) would drop
            # it and could even yield zero phases — leaving the job a flat
            # full-run loop, the opposite of what was asked)
            span = end_s - start_s - duty * period_s
            n = int(span / period_s + 1e-9) + 1 if span >= -1e-9 else 0
        if n < 1:
            raise ValueError(
                f"bursts(): window [{start_s}, {end_s}) is shorter than one "
                f"{duty * period_s:g} s burst — no phases would be added")
        j = self._job_index(job, "bursts")
        # the ON/OFF loop IS shift(repeat(one-burst, n, period)): expand
        # that combinator tree and declare each resulting window
        on = scn_ir.leaf(dict(phases=[dict(start_s=0.0,
                                           duration_s=duty * period_s)]))
        tree = scn_ir.shift(scn_ir.repeat(on, n, period_s=period_s), start_s)
        for w in _phase_windows(tree):
            self._add_phase(self.jobs[j], f"job {j}",
                            start_s=w, end_s=None,
                            duration_s=duty * period_s, req_mb=req_mb,
                            think_s=think_s, arrival=arrival,
                            interval_s=interval_s, rate_hz=rate_hz)
        return self

    def ramp(self, job: Optional[int] = None, *, start_s: float,
             duration_s: float, steps: int = 4,
             req_mb: Optional[Sequence[float]] = None,
             think_s: Optional[Sequence[float]] = None,
             arrival: Optional[str] = None,
             interval_s: Optional[float] = None,
             rate_hz: Optional[float] = None) -> "Experiment":
        """Staircase sugar: ``steps`` back-to-back phases over
        ``start_s..start_s+duration_s`` with ``req_mb`` and/or ``think_s``
        interpolated linearly between ``(from, to)`` pairs — a load ramp
        without hand-writing each step."""
        if steps < 1:
            raise ValueError(f"ramp(): steps must be >= 1, got {steps}")
        if req_mb is None and think_s is None:
            raise ValueError("ramp(): give req_mb=(from, to) and/or "
                             "think_s=(from, to)")

        def lerp(pair, i):
            if pair is None:
                return None
            lo, hi = pair
            frac = i / max(steps - 1, 1)
            return float(lo) + (float(hi) - float(lo)) * frac

        j = self._job_index(job, "ramp")
        step_s = duration_s / steps
        # the staircase IS shift(overlay(shift(step, i*step_s)...), start):
        # same-identity steps merge into one phased job; the lerped
        # req/think fields ride on each declared window
        step = scn_ir.leaf(dict(phases=[dict(start_s=0.0,
                                             duration_s=step_s)]))
        tree = scn_ir.shift(
            scn_ir.overlay(*[scn_ir.shift(step, i * step_s)
                             for i in range(steps)]), start_s)
        for i, w in enumerate(_phase_windows(tree)):
            self._add_phase(self.jobs[j], f"job {j}",
                            start_s=w, end_s=None,
                            duration_s=step_s, req_mb=lerp(req_mb, i),
                            think_s=lerp(think_s, i), arrival=arrival,
                            interval_s=interval_s, rate_hz=rate_hz)
        return self

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

    def scenario(self, name: str = "") -> Scenario:
        """Snapshot the declared jobs as a :class:`repro_torch.scenario.Scenario`
        (deep copy — later builder calls don't mutate it)."""
        return Scenario(jobs=copy.deepcopy(self.jobs), name=name)

    def to_json(self, name: str = "") -> str:
        """The declared workload as a scenario JSON trace."""
        return self.scenario(name).to_json()

    @classmethod
    def from_scenario(cls, scenario: Scenario | str, **kw) -> "Experiment":
        """Build an Experiment running ``scenario`` (a :class:`Scenario` or
        its JSON text); ``kw`` are the usual constructor arguments
        (policy, scheduler, params, geometry)."""
        if isinstance(scenario, str):
            scenario = Scenario.from_json(scenario)
        return cls(**kw).add_jobs(copy.deepcopy(scenario.jobs))

    @staticmethod
    def batch(queue="bb-heavy", **kw) -> BatchExperiment:
        """The batch plane's facade (:class:`repro_torch.batch.api.
        BatchExperiment`): a queue of jobs with node + burst-buffer
        reservations scheduled by FCFS / EASY backfilling / plan-based
        annealing, whose admitted timeline bridges back into an
        :class:`Experiment` via ``to_experiment``; ``kw`` includes
        ``device`` (default ``"cuda"``)::

            bx = Experiment.batch("bb-heavy", n_jobs=24)
            res = bx.run("plan")
            exp, horizon = bx.to_experiment(res, scheduler="themis")
        """
        return BatchExperiment(queue, **kw)

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
        with that seed.

        ``workspace`` (a :class:`repro_torch.workspace.WorkspaceStore` or a
        directory path) makes the sweep resumable: points already recorded
        under ``campaign`` are reused bit for bit and only the missing ones
        are computed, ``chunk`` points per run
        (:func:`repro_torch.workspace.campaign.run_sweep`)."""
        if workspace is not None:
            result, _ = run_sweep(self, grid, seconds, seeds=seeds,
                                  store=_store(workspace), campaign=campaign,
                                  chunk=chunk)
            return result
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
        :meth:`RunResult.slowdown` compares against.  With ``workspace``
        the run is cached by its full spec hash under ``name``: computed
        once per configuration, reused bit for bit after
        (:func:`repro_torch.workspace.campaign.run_cached`)."""
        clone = Experiment(
            policy=self.policy, scheduler=self.scheduler, params=self.params,
            n_servers=self.n_servers, n_workers=self.n_workers,
            server_bw=self.server_bw, max_jobs=self._slots(),
            seed=self.seed, device=self.device, **self.engine_kw)
        clone.jobs = [copy.deepcopy(self.jobs[job])]
        if workspace is not None:
            return run_cached(clone, seconds, store=_store(workspace),
                              name=name)
        return clone.run(seconds)

    def serve(self, *, autodrain: bool = True,
              lam_s: Optional[float] = None,
              stripes: int = 1) -> ExperimentService:
        """Stand up the functional plane for this spec: a :class:`BBCluster`
        driven by the same scheduler object and params, plus one client per
        declared job (job ids are 1-based to match the service's examples).

        ``lam_s`` (the service's λ-sync cadence) defaults to the engine
        config's ``sync_ticks × dt``, so both planes sync segments at the
        same virtual-time cadence unless explicitly overridden."""
        cfg = self.engine_config()
        if lam_s is None:
            lam_s = cfg.sync_ticks * cfg.dt if cfg.sync_ticks > 0 else 0.5
        cluster = BBCluster(
            n_servers=self.n_servers,
            policy=self.policy if self.policy is not None else "job-fair",
            scheduler=self.scheduler, scheduler_params=self.params,
            n_workers=self.n_workers, bandwidth=self.server_bw,
            max_jobs=self._slots(), lam_s=lam_s, seed=self.seed,
            stripes=stripes, device=self.device)
        # Same spec, both planes: hand the service the exact engine config
        # (incl. dt / engine_kw overrides the BBCluster ctor doesn't take),
        # so e.g. μ boundaries fall at identical virtual times.
        cluster.cfg = dataclasses.replace(cfg, policy=cluster.cfg.policy)
        clients = [
            BBClient(cluster,
                     JobMeta(job_id=j + 1, user=spec.get("user", 0),
                             group=spec.get("group", 0),
                             size=spec.get("size", 1),
                             priority=spec.get("priority", 1.0)),
                     autodrain=autodrain)
            for j, spec in enumerate(self.jobs)]
        return ExperimentService(cluster=cluster, clients=clients,
                                 jobs=copy.deepcopy(self.jobs))


def _store(workspace) -> WorkspaceStore:
    """A :class:`~repro_torch.workspace.WorkspaceStore`, or one opened at a
    directory path."""
    return (workspace if isinstance(workspace, WorkspaceStore)
            else WorkspaceStore(workspace))


__all__ = [
    "Experiment", "BatchExperiment", "BatchResult", "ExperimentService",
    "RunResult", "BatchRunResult", "SweepResult", "ReplayResult",
]

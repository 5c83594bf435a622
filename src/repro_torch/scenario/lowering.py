"""The port's lowering pipeline: job specs / combinator trees -> validated
``[J, P]`` phase arrays.

The port's own copy of the reference's ``scenario/lowering.py``: the same
vocabulary, validation, seconds-domain phase resolution and arrays, bit for
bit, so both engines run from identical workloads.  Every construction path
-- flat spec dicts, the Experiment builder's ``.phase/.bursts/.ramp`` sugar,
:class:`~repro_torch.scenario.Scenario` JSON, the preset library, the trace
importer and combinator trees (:mod:`repro_torch.scenario.ir`) -- funnels
through :func:`lower`:

    source -> job spec dicts -> normalize_phases() -> [J, P] arrays

The engine (``repro_torch.core.engine.make_workload``) and the burst-buffer
service's scenario replay consume it.  Two sources that lower to identical
arrays (plus identical job-table attributes, :meth:`LoweredScenario.canonical`)
are the same scenario.  Numpy only.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np

#: Seconds -> ticks clamps here: the int32-safe horizon (``round(1e9 s /
#: 1e-3 s)`` overflows i32, and a flat spec's default ``end_s`` is 1e9).
I32_TICK_HORIZON = np.iinfo(np.int32).max

#: Arrival modes a phase can run in (``Workload.arrival_mode`` codes).
ARRIVAL_CLOSED, ARRIVAL_INTERVAL, ARRIVAL_POISSON = 0, 1, 2
ARRIVAL_MODES = {"closed": ARRIVAL_CLOSED, "interval": ARRIVAL_INTERVAL,
                 "poisson": ARRIVAL_POISSON}

#: The job-spec vocabulary :func:`lower` (and the Experiment builder /
#: Scenario JSON) accept.  Anything else is a typo and raises ``TypeError``.
JOB_SPEC_KEYS = frozenset({
    "user", "group", "size", "priority", "procs", "req_mb", "start_s",
    "end_s", "think_s", "servers", "overhead_us", "phases", "arrival",
    "interval_s", "rate_hz"})

#: Keys accepted inside one entry of a spec's ``phases`` list.
PHASE_SPEC_KEYS = frozenset({
    "start_s", "end_s", "duration_s", "req_mb", "think_s", "arrival",
    "interval_s", "rate_hz"})

#: A flat spec with no ``end_s`` runs "forever": this sentinel (seconds).
#: Combinators that need a bounded span (``repeat``/``concat``) reject
#: fragments whose phases end at/after it.
OPEN_END_S = 1e9


def validate_job_spec(spec, where: str = "job spec") -> None:
    """Reject unknown keys with the accepted vocabulary spelled out —
    the same fail-loudly UX as ``Policy.parse`` on a misspelled policy
    (``req_md`` must not silently fall back to the 10 MB default)."""
    if not isinstance(spec, Mapping):
        raise TypeError(f"{where}: expected a dict, got {type(spec).__name__}")
    unknown = sorted(set(spec) - JOB_SPEC_KEYS)
    if unknown:
        raise TypeError(
            f"{where}: unknown key(s) {unknown}. Accepted job keys: "
            f"{sorted(JOB_SPEC_KEYS)}.")
    for i, ph in enumerate(spec.get("phases") or ()):
        if not isinstance(ph, Mapping):
            raise TypeError(f"{where} phase {i}: expected a dict, got "
                            f"{type(ph).__name__}")
        bad = sorted(set(ph) - PHASE_SPEC_KEYS)
        if bad:
            raise TypeError(
                f"{where} phase {i}: unknown key(s) {bad}. Accepted phase "
                f"keys: {sorted(PHASE_SPEC_KEYS)}.")


def normalize_phases(spec, where: str = "job spec") -> list[dict]:
    """Resolve a job spec into its phase list (seconds-domain, defaults
    applied, validated).

    A flat spec (no ``phases``) is one phase spanning ``start_s..end_s``.
    Explicit phases inherit the spec's ``req_mb``/``think_s``/arrival
    fields as defaults, must each carry ``start_s`` plus ``end_s`` or
    ``duration_s``, must be non-empty, and must not overlap (sorted by
    start).  Arrival modes: ``closed`` (default), ``interval`` (needs
    ``interval_s > 0``), ``poisson`` (needs ``rate_hz > 0``).
    """
    validate_job_spec(spec, where)
    base = dict(
        req_mb=float(spec.get("req_mb", 10.0)),
        think_s=float(spec.get("think_s", 0.0)),
        arrival=spec.get("arrival", "closed"),
        interval_s=spec.get("interval_s"),
        rate_hz=spec.get("rate_hz"))
    raw = spec.get("phases")
    if not raw:
        raw = [dict(start_s=spec.get("start_s", 0.0),
                    end_s=spec.get("end_s", OPEN_END_S))]
        explicit = False
    else:
        explicit = True
    out = []
    for i, ph in enumerate(raw):
        tag = f"{where} phase {i}"
        if "start_s" not in ph:
            raise ValueError(f"{tag}: needs start_s")
        start = float(ph["start_s"])
        if "end_s" in ph and "duration_s" in ph:
            raise ValueError(f"{tag}: give end_s or duration_s, not both")
        if "duration_s" in ph:
            end = start + float(ph["duration_s"])
        elif "end_s" in ph:
            end = float(ph["end_s"])
        else:
            raise ValueError(f"{tag}: needs end_s or duration_s")
        if explicit and end <= start:
            raise ValueError(f"{tag}: empty window [{start}, {end})")
        mode = ph.get("arrival", base["arrival"])
        if mode not in ARRIVAL_MODES:
            raise ValueError(
                f"{tag}: unknown arrival mode {mode!r}; one of "
                f"{sorted(ARRIVAL_MODES)}")
        interval_s = ph.get("interval_s", base["interval_s"])
        rate_hz = ph.get("rate_hz", base["rate_hz"])
        if mode == "interval" and not (interval_s and float(interval_s) > 0):
            raise ValueError(f"{tag}: arrival='interval' needs interval_s > 0")
        if mode == "poisson" and not (rate_hz and float(rate_hz) > 0):
            raise ValueError(f"{tag}: arrival='poisson' needs rate_hz > 0")
        if out:
            prev_end = out[-1]["end_s"]
            # ulp tolerance: bursts()/ramp() accumulate starts and ends by
            # different float paths, so a contiguous boundary can differ by
            # rounding; only a *material* overlap is an error.
            tol = 1e-9 * max(1.0, abs(prev_end))
            if start < prev_end - tol:
                raise ValueError(
                    f"{tag}: starts at {start} inside the previous phase "
                    f"(ends {prev_end}); phases must be sorted and "
                    f"non-overlapping")
            if start < prev_end:
                start = prev_end          # snap ulp-gaps to exact contiguity
        out.append(dict(
            start_s=start, end_s=end,
            req_mb=float(ph.get("req_mb", base["req_mb"])),
            think_s=float(ph.get("think_s", base["think_s"])),
            arrival=mode,
            interval_s=float(interval_s) if interval_s else 0.0,
            rate_hz=float(rate_hz) if rate_hz else 0.0))
    return out


def ticks_i32(seconds: float, dt: float) -> int:
    """Seconds -> ticks, clamped to the int32-safe horizon."""
    return int(min(round(seconds / dt), I32_TICK_HORIZON))


#: The canonical array fields, in hashing order.
ARRAY_FIELDS = ("phase_start", "phase_end", "phase_req", "phase_think",
                "arrival_mode", "arrival_every", "arrival_rate",
                "procs", "overhead_s")


class LoweredScenario(NamedTuple):
    """A scenario lowered to its canonical form: the validated ``[J, P]``
    arrays (numpy — the engine moves them onto its device as a ``Workload``)
    plus the per-job table attributes and the resolved seconds-domain
    phase lists (what the service plane's replay walks)."""

    jobs: list                 # the source job spec dicts
    phases: tuple              # per job: tuple of resolved phase dicts
    phase_start: np.ndarray    # i32[max_jobs, P]  phase start tick
    phase_end: np.ndarray      # i32[max_jobs, P]  arrivals stop at this tick
    phase_req: np.ndarray      # f32[max_jobs, P]  request bytes
    phase_think: np.ndarray    # i32[max_jobs, P]  closed-loop think ticks
    arrival_mode: np.ndarray   # i32[max_jobs, P]  ARRIVAL_* codes
    arrival_every: np.ndarray  # i32[max_jobs, P]  inter-burst ticks
    arrival_rate: np.ndarray   # f32[max_jobs, P]  per-proc arrivals/tick
    procs: np.ndarray          # i32[n_servers, max_jobs]
    overhead_s: np.ndarray     # f32[max_jobs]  fixed per-request cost
    attrs: tuple               # per job: (user, group, size, priority)

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def canonical(self) -> dict:
        """The content a scenario *is*, independent of how it was spelled:
        the lowered arrays plus the job-table attributes.  Two sources
        (flat dicts, sugar, a combinator tree) with equal canonical forms
        run bit-identically — feed this through the workspace's
        bit-identical ndarray codec (``encode_payload``) to key caches."""
        return {
            "arrays": {f: getattr(self, f) for f in ARRAY_FIELDS},
            "attrs": [[int(u), int(g), int(s), float(p)]
                      for u, g, s, p in self.attrs],
        }


def resolve_jobs(source, where: str = "job") -> list[dict]:
    """Normalize any scenario source to its job spec dict list.

    Accepts a combinator tree (:class:`~repro_torch.scenario.ir.ScenarioNode`),
    a :class:`~repro_torch.scenario.Scenario` (anything with a ``jobs`` list),
    or a plain sequence of job spec dicts.
    """
    from .ir import ScenarioNode, to_jobs
    if isinstance(source, ScenarioNode):
        return to_jobs(source)
    if hasattr(source, "jobs") and not isinstance(source, Mapping):
        return list(source.jobs)
    if isinstance(source, Mapping):
        raise TypeError(
            f"{where}: expected a ScenarioNode, a Scenario, or a sequence "
            f"of job spec dicts — got a single dict (wrap it in a list)")
    return list(source)


def lower(source, *, dt: float = 1e-3, n_servers: int = 1,
          max_jobs: Optional[int] = None, ring_cap: int = 512,
          ) -> LoweredScenario:
    """THE lowering entry point: any scenario source -> canonical arrays.

    ``dt``/``n_servers``/``max_jobs``/``ring_cap`` are the geometry the
    arrays are shaped for (the matching ``EngineConfig`` fields); every
    other config knob is irrelevant to the workload.  Validation is the
    job-spec contract: unknown keys ``TypeError`` with the vocabulary,
    malformed windows/arrival modes ``ValueError``, and a job putting more
    procs on one server than ``ring_cap`` can hold is rejected here rather
    than overflowing rings silently at run time.
    """
    jobs = resolve_jobs(source)
    s_ = int(n_servers)
    j_ = int(max_jobs) if max_jobs is not None else max(1, len(jobs))
    per_job = [normalize_phases(spec, f"job {j}") for j, spec in
               enumerate(jobs)]
    p_ = max([1] + [len(ph) for ph in per_job])
    start = np.zeros((j_, p_), np.int32)
    end = np.zeros((j_, p_), np.int32)
    req = np.ones((j_, p_), np.float32)
    think = np.zeros((j_, p_), np.int32)
    mode = np.zeros((j_, p_), np.int32)
    every = np.ones((j_, p_), np.int32)
    rate = np.zeros((j_, p_), np.float32)
    procs = np.zeros((s_, j_), np.int32)
    over = np.zeros((j_,), np.float32)
    attrs = []
    for j, (spec, phases) in enumerate(zip(jobs, per_job)):
        for k, ph in enumerate(phases):
            start[j, k] = ticks_i32(ph["start_s"], dt)
            end[j, k] = ticks_i32(ph["end_s"], dt)
            req[j, k] = ph["req_mb"] * 1e6
            think[j, k] = ticks_i32(ph["think_s"], dt)
            mode[j, k] = ARRIVAL_MODES[ph["arrival"]]
            every[j, k] = max(1, ticks_i32(ph["interval_s"], dt))
            rate[j, k] = ph["rate_hz"] * dt
        servers = spec.get("servers", list(range(s_)))
        total_procs = int(spec.get("procs", spec.get("size", 1) * 56))
        share = np.zeros((s_,), np.int64)
        for i, sv in enumerate(servers):
            share[sv] += total_procs // len(servers) + (1 if i < total_procs % len(servers) else 0)
        procs[:, j] = share
        over[j] = float(spec.get("overhead_us", 0.0)) * 1e-6
        if share.max() > ring_cap:
            raise ValueError(f"job {j}: {share.max()} procs on one server > ring_cap {ring_cap}")
        attrs.append((int(spec.get("user", 0)), int(spec.get("group", 0)),
                      int(spec.get("size", 1)),
                      float(spec.get("priority", 1.0))))
    return LoweredScenario(
        jobs=jobs, phases=tuple(tuple(ph) for ph in per_job),
        phase_start=start, phase_end=end, phase_req=req, phase_think=think,
        arrival_mode=mode, arrival_every=every, arrival_rate=rate,
        procs=procs, overhead_s=over, attrs=tuple(attrs))


def lower_for_config(source, cfg) -> LoweredScenario:
    """:func:`lower` with geometry taken from an ``EngineConfig``-shaped
    object (``dt``, ``n_servers``, ``max_jobs``, ``ring_cap``)."""
    return lower(source, dt=cfg.dt, n_servers=cfg.n_servers,
                 max_jobs=cfg.max_jobs, ring_cap=cfg.ring_cap)

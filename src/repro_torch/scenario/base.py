"""Named, JSON-pinnable workload scenarios.

A :class:`Scenario` is the serializable half of the Experiment spec:
either a list of job dicts (the :func:`repro_torch.scenario.lowering.lower`
vocabulary, including per-job ``phases``) or a combinator *tree*
(:mod:`repro_torch.scenario.ir`), plus a name.  It exists so benchmarks and
tests can *pin* a workload — an ON/OFF checkpoint loop, an idle-window
opportunity-fairness case, a Fig. 13-style interference mix — as a JSON
trace, re-load it anywhere, and know both planes run exactly that spec::

    from repro_torch.api import Experiment
    from repro_torch.scenario import Scenario

    exp = (Experiment(policy="job-fair")
           .add_job(user=0, procs=56, req_mb=10, end_s=12)
           .add_job(user=1, procs=56, req_mb=10)
           .bursts(period_s=4.0, duty=0.5, n=3))
    exp.scenario("ckpt-interference").save("ckpt.json")

    exp2 = Experiment.from_scenario(Scenario.load("ckpt.json"),
                                    policy="job-fair")
    # exp2.run(12) is bit-identical to exp.run(12)

The JSON schema is ``{"name", "version", "jobs": [job-spec, ...]}``
(version 1) or ``{"name", "version", "tree": <combinator doc>}``
(version 2, when the scenario was built from a combinator tree).  A job
spec uses :data:`repro_torch.scenario.lowering.JOB_SPEC_KEYS` and each entry of
its optional ``phases`` list uses
:data:`repro_torch.scenario.lowering.PHASE_SPEC_KEYS`.  Specs are validated on
construction and on load, so a typo in a pinned trace (``req_md``) fails
with the accepted vocabulary, not a silent default.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Optional, Sequence

from .ir import ScenarioNode, node_from_doc, node_to_doc, to_jobs
from .lowering import normalize_phases
from .trace import parse_trace, trace_jobs

#: Current writer version.  Version 1 documents carry ``jobs``; version 2
#: adds combinator ``tree`` documents.  Plain-jobs scenarios still write
#: version 1 so older readers keep loading them.
SCENARIO_VERSION = 2


@dataclasses.dataclass
class Scenario:
    """A named, validated workload spec: job dicts, or a combinator tree
    (which expands to job dicts — ``jobs`` is always populated)."""

    jobs: list = dataclasses.field(default_factory=list)
    name: str = ""
    tree: Optional[ScenarioNode] = None

    def __post_init__(self):
        if self.tree is not None:
            if self.jobs:
                raise ValueError(
                    f"scenario {self.name!r}: give jobs or tree, not both "
                    f"(the tree expands to the job list)")
            if not isinstance(self.tree, ScenarioNode):
                raise TypeError(
                    f"scenario {self.name!r}: tree must be a ScenarioNode, "
                    f"got {type(self.tree).__name__}")
            self.jobs = to_jobs(self.tree)
        self.jobs = [copy.deepcopy(dict(spec)) for spec in self.jobs]
        for j, spec in enumerate(self.jobs):
            # normalize_phases validates keys, windows, and arrival modes
            tag = f"scenario {self.name!r} job {j}" if self.name else f"job {j}"
            normalize_phases(spec, tag)

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def phases(self, job: int) -> list[dict]:
        """The resolved (seconds-domain, defaults-applied) phase list of one
        job — what the engine's ``[J, P]`` arrays are built from."""
        return normalize_phases(self.jobs[job], f"job {job}")

    def lowered(self, **geometry):
        """This scenario's canonical ``[J, P]`` lowering (see
        :func:`repro_torch.scenario.lowering.lower` for the geometry knobs)."""
        from .lowering import lower
        return lower(self.jobs, **geometry)

    # -- JSON trace ----------------------------------------------------------
    def to_json(self, indent: int = 2) -> str:
        if self.tree is not None:
            return json.dumps(
                {"name": self.name, "version": SCENARIO_VERSION,
                 "tree": node_to_doc(self.tree)}, indent=indent)
        return json.dumps(
            {"name": self.name, "version": 1, "jobs": self.jobs},
            indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Scenario":
        doc = json.loads(text)
        if not isinstance(doc, dict) or not ("jobs" in doc or "tree" in doc):
            raise ValueError(
                "scenario JSON must be an object with a 'jobs' list "
                "(version 1) or a 'tree' combinator document (version 2) "
                "(schema: {name, version, jobs | tree})")
        version = doc.get("version", 1)
        try:
            version = int(version)
        except (TypeError, ValueError):
            raise ValueError(
                f"scenario version must be an integer, got {version!r}"
            ) from None
        if version > SCENARIO_VERSION:
            raise ValueError(
                f"scenario version {version} is newer than this reader "
                f"(supported versions: "
                f"{list(range(1, SCENARIO_VERSION + 1))})")
        if "tree" in doc:
            return cls(tree=node_from_doc(doc["tree"]),
                       name=doc.get("name", ""))
        return cls(jobs=doc["jobs"], name=doc.get("name", ""))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_json(f.read())

    def copy(self) -> "Scenario":
        if self.tree is not None:
            return Scenario(tree=self.tree, name=self.name)
        return Scenario(jobs=copy.deepcopy(self.jobs), name=self.name)

    # -- real-trace ingestion ------------------------------------------------
    @classmethod
    def from_trace(cls, records, *, name: str = "trace",
                   gap_s: Optional[float] = None,
                   ops: Optional[Sequence[str] | str] = None,
                   mode: str = "interval",
                   time_scale: float = 1.0,
                   min_phase_s: float = 1e-3) -> "Scenario":
        """Lower Darshan-style per-rank I/O records to a phased scenario.

        ``records`` is an iterable of dicts with
        :data:`repro_torch.scenario.trace.TRACE_FIELDS` (``start_s``/``end_s``
        required, ``rank``/``user``/``bytes``/``op`` defaulted), **or** a
        path to a CSV / JSON-lines trace file (see :func:`parse_trace`).
        One job is built per distinct ``user``; its ``procs`` is the
        number of distinct ranks that appear, and its records are
        **burst-clustered**: sorted by start time, two records join one
        cluster when the gap between them is at most ``gap_s`` (default:
        5% of the whole trace's time span), and each cluster becomes one
        phase whose ``req_mb`` is the cluster's mean record size.  Start
        times are shifted so the trace begins at 0 and scaled by
        ``time_scale``.

        ``mode`` picks the arrival lowering: ``"interval"`` (default)
        replays each phase open-loop at the recorded request rate
        (``interval_s = procs * duration / n_records``); ``"closed"``
        makes each phase a closed loop (the population saturates the
        phase window — demand shape from the clusters, intensity from
        ``procs`` and request size).  ``ops`` filters records by their
        ``op`` field (e.g. ``"write"`` or ``("read", "write")``).

        Knobs are validated at entry: ``mode`` must be one of the
        accepted modes, ``time_scale``/``min_phase_s`` must be positive,
        ``gap_s`` (when given) must be positive, and the trace must
        contain at least one record (after any ``ops`` filter).

        The result is an ordinary :class:`Scenario`: it JSON round-trips,
        sweeps in one compile, and replays on both planes like any
        hand-written spec.
        """
        jobs = trace_jobs(records, name=name, gap_s=gap_s, ops=ops,
                          mode=mode, time_scale=time_scale,
                          min_phase_s=min_phase_s)
        return cls(jobs=jobs, name=name)

"""Real-trace ingestion: Darshan-style per-rank records -> job specs.

:func:`parse_trace` normalizes any trace input (record dicts, an open
stream, a CSV / JSON-lines file path) to validated record dicts;
:func:`trace_jobs` burst-clusters them into per-user phased job specs —
the backend of :meth:`repro_torch.scenario.Scenario.from_trace`.
"""
from __future__ import annotations

import csv
import io
import json
import math
import os
from typing import Iterable, Mapping, Optional, Sequence

#: Darshan-style per-rank trace record fields :func:`trace_jobs` ingests.
#: ``start_s``/``end_s`` are required; the rest default.
TRACE_FIELDS = ("rank", "user", "start_s", "end_s", "bytes", "op")

_TRACE_DEFAULTS = {"rank": 0, "user": 0, "bytes": 10e6, "op": "write"}

#: Arrival lowerings :func:`trace_jobs` accepts for its ``mode`` knob.
TRACE_MODES = ("closed", "interval")


def parse_trace(records) -> list[dict]:
    """Normalize trace input to a list of per-rank record dicts.

    Accepts an iterable of mappings (already-parsed records), an open text
    stream, or a path (str / ``os.PathLike``) to a trace file.  Files are
    sniffed by their first non-blank character: ``{`` means JSON-lines (one
    record object per line), anything else is CSV with a header row naming
    a subset of :data:`TRACE_FIELDS`.  Every record is validated the way
    job specs are: unknown fields raise with the accepted vocabulary,
    missing ``start_s``/``end_s`` raise, the rest take defaults.
    """
    if isinstance(records, (str, os.PathLike)):
        with open(records) as f:
            return _parse_trace_text(f.read(), str(records))
    if isinstance(records, io.TextIOBase):
        return _parse_trace_text(records.read(), "<stream>")
    return [_normalize_record(r, i) for i, r in enumerate(records)]


def _parse_trace_text(text: str, where: str) -> list[dict]:
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return []
    if lines[0].lstrip().startswith("{"):
        docs = []
        for i, ln in enumerate(lines):
            try:
                docs.append(json.loads(ln))
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{where} line {i + 1}: bad JSON record: {e}") from None
        return [_normalize_record(r, i) for i, r in enumerate(docs)]
    rows = list(csv.DictReader(io.StringIO("\n".join(lines))))
    return [_normalize_record(r, i) for i, r in enumerate(rows)]


def _normalize_record(rec, i: int) -> dict:
    if not isinstance(rec, Mapping):
        raise TypeError(
            f"trace record {i}: expected a dict, got {type(rec).__name__}")
    unknown = sorted(set(rec) - set(TRACE_FIELDS))
    if unknown:
        raise ValueError(
            f"trace record {i}: unknown field(s) {unknown}. Accepted "
            f"fields: {list(TRACE_FIELDS)}.")
    for f in ("start_s", "end_s"):
        if rec.get(f) in (None, ""):
            raise ValueError(
                f"trace record {i}: missing required field {f!r} "
                f"(fields: {list(TRACE_FIELDS)})")
    out = {**_TRACE_DEFAULTS, **{k: v for k, v in rec.items()
                                 if v not in (None, "")}}
    try:
        out = dict(rank=int(out["rank"]), user=int(out["user"]),
                   start_s=float(out["start_s"]), end_s=float(out["end_s"]),
                   bytes=float(out["bytes"]), op=str(out["op"]))
    except (TypeError, ValueError) as e:
        raise ValueError(f"trace record {i}: bad value: {e}") from None
    if out["end_s"] < out["start_s"]:
        raise ValueError(
            f"trace record {i}: end_s {out['end_s']} < start_s "
            f"{out['start_s']}")
    return out


def _validate_trace_knobs(name: str, gap_s, mode, time_scale,
                          min_phase_s) -> None:
    """Fail the knobs at entry, in the Accepted-fields style of the
    record parser — before any record is touched."""
    if mode not in TRACE_MODES:
        raise ValueError(
            f"trace {name!r}: unknown mode {mode!r}. Accepted modes: "
            f"{list(TRACE_MODES)}.")
    if not (isinstance(time_scale, (int, float)) and time_scale > 0):
        raise ValueError(
            f"trace {name!r}: time_scale must be > 0, got {time_scale!r}")
    if gap_s is not None and not (isinstance(gap_s, (int, float))
                                  and gap_s > 0):
        raise ValueError(
            f"trace {name!r}: gap_s must be > 0 (or None for the 5%-of-"
            f"span default), got {gap_s!r}")
    if not (isinstance(min_phase_s, (int, float)) and min_phase_s > 0):
        raise ValueError(
            f"trace {name!r}: min_phase_s must be > 0, got {min_phase_s!r}")


def trace_jobs(records, *, name: str = "trace",
               gap_s: Optional[float] = None,
               ops: Optional[Sequence[str] | str] = None,
               mode: str = "interval",
               time_scale: float = 1.0,
               min_phase_s: float = 1e-3) -> list[dict]:
    """Burst-cluster trace records into per-user phased job specs (see
    :meth:`repro_torch.scenario.Scenario.from_trace` for semantics)."""
    _validate_trace_knobs(name, gap_s, mode, time_scale, min_phase_s)
    recs = parse_trace(records)
    if isinstance(ops, str):
        ops = (ops,)
    if ops is not None:
        recs = [r for r in recs if r["op"] in ops]
    if not recs:
        raise ValueError(
            f"trace {name!r}: no records"
            + (f" with op in {tuple(ops)}" if ops else ""))
    t0 = min(r["start_s"] for r in recs)
    span = max(r["end_s"] for r in recs) - t0
    if gap_s is None:
        gap_s = 0.05 * span * time_scale
    jobs = []
    by_user: dict[int, list[dict]] = {}
    for r in recs:
        by_user.setdefault(r["user"], []).append(r)
    for user in sorted(by_user):
        urecs = sorted(by_user[user],
                       key=lambda r: (r["start_s"], r["end_s"], r["rank"]))
        procs = len({r["rank"] for r in urecs})
        clusters = _cluster_bursts(urecs, t0, time_scale, gap_s,
                                   min_phase_s)
        phases = []
        for c in clusters:
            ph = dict(start_s=c["start_s"], end_s=c["end_s"],
                      req_mb=c["bytes"] / c["count"] / 1e6)
            if mode == "interval":
                ph["arrival"] = "interval"
                ph["interval_s"] = max(
                    procs * (c["end_s"] - c["start_s"]) / c["count"],
                    1e-6)
            phases.append(ph)
        jobs.append(dict(user=int(user), procs=procs,
                         size=max(1, math.ceil(procs / 56)),
                         phases=phases))
    return jobs


def _cluster_bursts(urecs: Iterable[Mapping], t0: float, time_scale: float,
                    gap_s: float, min_phase_s: float) -> list[dict]:
    """Greedy single-pass burst clustering of one user's sorted records:
    a record joins the open cluster when it starts within ``gap_s`` of the
    cluster's current end, else it opens a new one.  Returns cluster dicts
    ``{start_s, end_s, bytes, count}`` in the shifted/scaled time domain,
    each at least ``min_phase_s`` long and clamped non-overlapping."""
    clusters: list[dict] = []
    for r in urecs:
        s = (r["start_s"] - t0) * time_scale
        e = (r["end_s"] - t0) * time_scale
        if clusters and s <= clusters[-1]["end_s"] + gap_s:
            c = clusters[-1]
            c["end_s"] = max(c["end_s"], e)
            c["bytes"] += r["bytes"]
            c["count"] += 1
        else:
            clusters.append(dict(start_s=s, end_s=e, bytes=r["bytes"],
                                 count=1))
    for c in clusters:
        c["end_s"] = max(c["end_s"], c["start_s"] + min_phase_s)
    for a, b in zip(clusters, clusters[1:]):     # keep phases non-overlapping
        a["end_s"] = min(a["end_s"], b["start_s"])
    return clusters

"""Checkpoint/resume for sweeps and cached runs (the campaign layer), the
port's copy of the reference's ``repro.workspace.campaign``.

A *campaign* is a named journal of completed grid points.  :func:`run_sweep`
keys every point of an ``Experiment.sweep`` grid on

    (section="sweep", name=<campaign>, scheduler, params_hash,
     scenario_hash, env)

where ``scenario_hash`` (:func:`spec_hash`) canonically hashes the *lowered*
scenario (the canonical ``[J, P]`` arrays of the port's own
:func:`~repro_torch.scenario.lowering.lower_for_config`, through the
bit-identical ndarray codec), the engine geometry, the horizon and the seed
set: the same experiment gives the reference's key.  On every run it looks
each grid point up in the store, computes only the missing points as one
``Experiment.sweep`` sub-grid per chunk (``chunk=None``: everything missing
at once), flushing each chunk's records through the write buffer, and
merges stored and fresh points back into a full :class:`SweepResult` in
grid order.

The merge equals an uninterrupted sweep bit for bit: each ``(point, seed)``
lane of the port's ``run_batch`` equals a sequential run with that point's
params, and arrays round-trip through the store as raw buffers.  The device
does not enter the key: a point recorded on the CPU is reused on the card.
``max_chunks`` bounds one invocation's work: the campaign raises
:class:`CampaignInterrupted` *after* flushing that many chunks, and the next
invocation picks up where it stopped.

In a ``torch.distributed`` world (a sharded experiment) every rank calls
these functions: rank 0 alone writes, between barriers, and the other ranks
read back what it wrote, so every rank returns the same result.
"""
from __future__ import annotations

import numpy as np

from ..core.shard import barrier, is_writer
from .store import (RunKey, RunRecord, WorkspaceStore, canonical_json,
                    content_hash, encode_payload, env_fingerprint)


class CampaignInterrupted(RuntimeError):
    """Raised when ``max_chunks`` stops a campaign early; carries the
    progress report so callers can print resume instructions."""

    def __init__(self, report: dict):
        self.report = report
        super().__init__(
            f"campaign {report['campaign']!r} interrupted after "
            f"{report['computed']}/{report['points'] - report['reused']} "
            f"missing points ({report['reused']} already recorded); "
            f"re-run to resume")


def _jsonable(value):
    """Canonical-JSON-safe view of an arbitrary config value (tuples,
    numpy scalars, params objects); ``repr`` is the fallback spelling."""
    try:
        canonical_json(value)
        return value
    except TypeError:
        if isinstance(value, (tuple, list)):
            return [_jsonable(v) for v in value]
        if isinstance(value, (np.generic,)):
            return value.item()
        return repr(value)


def _scenario_doc(exp) -> dict:
    """The workload part of :func:`spec_hash`: the lowered canonical
    ``[J, P]`` arrays through the bit-identical ndarray codec, so two
    spellings of one scenario share keys."""
    from ..scenario.lowering import lower_for_config
    low = lower_for_config(exp.jobs, exp.engine_config())
    return encode_payload(low.canonical())


def spec_hash(exp, seconds, seeds) -> str:
    """Canonical hash of everything that determines a sweep lane's bits
    besides the swept params point: the lowered scenario, geometry, policy,
    base seed, engine overrides, horizon, and seed set."""
    doc = {
        "scenario": _scenario_doc(exp),
        "scheduler": exp.scheduler,
        "policy": (exp.policy.name or None) if exp.policy else None,
        "n_servers": exp.n_servers,
        "n_workers": exp.n_workers,
        "server_bw": float(exp.server_bw),
        "slots": exp._slots(),
        "seed": int(exp.seed),
        "engine_kw": {k: _jsonable(v)
                      for k, v in sorted(exp.engine_kw.items())},
        "seconds": float(seconds),
        "seeds": [int(s) for s in seeds],
    }
    return content_hash(doc)


def point_key(campaign: str, exp, point, scenario_hash: str) -> RunKey:
    return RunKey(section="sweep", name=campaign, scheduler=exp.scheduler,
                  params_hash=point.params_hash(),
                  scenario_hash=scenario_hash, env=env_fingerprint())


def _point_payload(sub, j: int) -> dict:
    """The per-point slice of a sub-sweep result, stored per record."""
    return {
        "gbps": np.asarray(sub.gbps[j]),
        "issued": np.asarray(sub.issued[j]),
        "completed": np.asarray(sub.completed[j]),
        "dropped": np.asarray(sub.dropped[j]),
        "idle_worker_ticks": np.asarray(sub.idle_worker_ticks[j]),
        "bin_s": float(sub.bin_s),
        "ticks": int(sub.ticks),
        "seconds": float(sub.seconds),
        "n_jobs": int(sub.n_jobs),
        "seeds": [int(s) for s in np.asarray(sub.seeds)],
        "params": {f: float(getattr(sub.points[j], f))
                   for f in sub.points[j].numeric_fields()},
    }


def _chunked(items: list, chunk) -> list[list]:
    if not items:
        return []
    if chunk is None or chunk >= len(items):
        return [items]
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return [items[i:i + chunk] for i in range(0, len(items), chunk)]


def run_sweep(exp, grid, seconds, seeds=tuple(range(4)), *,
              store: WorkspaceStore, campaign: str = "sweep",
              chunk=None, max_chunks=None, progress=None):
    """Resumable :meth:`Experiment.sweep`: compute only grid points not yet
    recorded under ``campaign``, record them (one buffered flush per
    chunk), and return ``(SweepResult, report)``; the report counts
    ``points`` / ``reused`` / ``computed`` / ``chunks`` / ``io_writes``.
    ``progress(chunk_index, n_chunks)`` fires after each chunk's flush."""
    if not exp.jobs:
        raise ValueError("run_sweep() needs at least one add_job()")
    points = exp._expand_grid(grid)
    seeds = tuple(int(s) for s in seeds)
    sh = spec_hash(exp, seconds, seeds)
    keys = [point_key(campaign, exp, p, sh) for p in points]
    _sync(store)

    stored: dict[int, dict] = {}
    missing: list[int] = []
    for i, key in enumerate(keys):
        rec = store.get(key)
        if rec is not None:
            stored[i] = rec.payload
        else:
            missing.append(i)
    writes_before = store.io_writes
    report = {"campaign": campaign, "points": len(points),
              "reused": len(stored), "computed": 0, "chunks": 0,
              "scenario_hash": sh, "io_writes": 0}

    fresh: dict[int, dict] = {}
    chunks = _chunked(missing, chunk)
    for ci, idxs in enumerate(chunks):
        if max_chunks is not None and ci >= max_chunks:
            report["io_writes"] = store.io_writes - writes_before
            raise CampaignInterrupted(report)
        sub = exp.sweep([points[i] for i in idxs], seconds, seeds=seeds)
        if is_writer():
            with store.buffered(campaign) as buf:
                for j, i in enumerate(idxs):
                    buf.put(RunRecord(key=keys[i],
                                      payload=_point_payload(sub, j)))
        _sync(store)
        for i in idxs:
            fresh[i] = store.get(keys[i]).payload
        report["computed"] += len(idxs)
        report["chunks"] += 1
        if progress is not None:
            progress(ci, len(chunks))
    report["io_writes"] = store.io_writes - writes_before

    payloads = {**stored, **fresh}
    return _merge(exp, points, seconds, seeds, payloads), report


def _merge(exp, points, seconds, seeds, payloads: dict[int, dict]):
    from ..api import SweepResult

    first = payloads[0]
    for i, p in payloads.items():
        if (p["ticks"], p["bin_s"], tuple(p["seeds"])) != (
                first["ticks"], first["bin_s"], tuple(first["seeds"])):
            raise ValueError(
                f"campaign point {i} was recorded under a different horizon "
                f"(ticks/bin/seeds mismatch) — this should be impossible "
                f"under one scenario_hash; the workspace is inconsistent")

    def stack(field):
        return np.stack([payloads[i][field] for i in range(len(points))])

    return SweepResult(
        scheduler=exp.scheduler,
        policy=(exp.policy.name or None) if exp.policy else None,
        points=tuple(points),
        seeds=np.asarray(first["seeds"]),
        n_jobs=int(first["n_jobs"]), seconds=float(seconds),
        gbps=stack("gbps"), bin_s=float(first["bin_s"]),
        issued=stack("issued"), completed=stack("completed"),
        dropped=stack("dropped"),
        idle_worker_ticks=stack("idle_worker_ticks"),
        ticks=int(first["ticks"]))


def _sync(store: WorkspaceStore) -> None:
    """Wait for every rank; then the ranks that do not write re-read the
    store (nothing without a process group)."""
    barrier()
    if not is_writer():
        store.refresh()


# -- cached single runs -------------------------------------------------------

def run_cached(exp, seconds, *, store: WorkspaceStore, name: str):
    """A workspace-cached :meth:`Experiment.run`, keyed like a sweep point
    (params hash of the resolved schema + spec hash + env); a hit runs no
    engine.  Returns a :class:`RunResult` (``state`` is not persisted)."""
    from ..api import RunResult

    params = exp.resolved_params()
    key = RunKey(section="run", name=name, scheduler=exp.scheduler,
                 params_hash=params.params_hash(),
                 scenario_hash=spec_hash(exp, seconds, (exp.seed,)),
                 env=env_fingerprint())
    _sync(store)
    rec = store.get(key)
    if rec is None:
        res = exp.run(seconds)
        rec = RunRecord(key=key, payload={
            "gbps": np.asarray(res.gbps), "bin_s": float(res.bin_s),
            "issued": np.asarray(res.issued),
            "completed": np.asarray(res.completed),
            "dropped": int(res.dropped),
            "idle_worker_ticks": int(res.idle_worker_ticks),
            "ticks": int(res.ticks), "seconds": float(res.seconds),
            "n_jobs": int(res.n_jobs)})
        if is_writer():
            store.put(rec)
        _sync(store)
        rec = store.get(key)
    p = rec.payload
    return RunResult(
        scheduler=exp.scheduler, params=params,
        policy=(exp.policy.name or None) if exp.policy else None,
        n_jobs=int(p["n_jobs"]), seconds=float(p["seconds"]),
        gbps=p["gbps"], bin_s=float(p["bin_s"]), issued=p["issued"],
        completed=p["completed"], dropped=int(p["dropped"]),
        idle_worker_ticks=int(p["idle_worker_ticks"]), ticks=int(p["ticks"]))

"""Rank-side jobs of ``tests/test_torch_shard.py``: run in every rank of a
world started by ``repro_torch.launch.mesh.spawn``.  Imports no ``jax`` and
nothing of ``repro``; rank 0's results come back to the test as numpy
arrays, beside a digest of every rank's results.
"""
from __future__ import annotations

import hashlib
import pickle

import numpy as np
import torch.distributed as dist

#: ``tests/test_shard.py``'s ``_BIT_IDENTITY`` job list (its Poisson phase
#: included) and engine geometry.
JOBS = [dict(user=0, size=2, procs=40, req_mb=8, think_s=0.002),
        dict(user=1, size=1, procs=20, req_mb=4,
             phases=[dict(start_s=0.0, duration_s=0.08,
                          arrival="poisson", rate_hz=300),
                     dict(start_s=0.1, duration_s=0.1)]),
        dict(user=2, size=1, procs=10, req_mb=16, start_s=0.04,
             think_s=0.001)]
GEOMETRY = dict(n_servers=4, max_jobs=8, n_workers=4, seed=3)
SECONDS = 0.2
#: The schedulers checked at ``SECONDS`` in every kind of run: one
#: segment-sync and one cross-shard scheduler.  The others' ``run`` stops
#: at ``SHORT_SECONDS``, past the start of every phase of ``JOBS``.
QUICK = ("themis", "adaptbf")
SHORT_SECONDS = 0.12
BATCH_SEEDS = [1, 2, 3, 4]
#: The horizon of the short runs (the solo, the sweep-only mesh).
SOLO_SECONDS = 0.03

#: ``tests/test_shard.py``'s ``_SWEEP_IDENTITY`` experiment and grid.
SWEEP_GRID = dict(burst_s=[0.02, 2.0], donate=[0.0, 0.5])
SWEEP_SEEDS = (1, 2)


def state_arrays(state) -> dict:
    """Every leaf of an ``EngineState`` (aux included) as numpy."""
    out = {"t": np.asarray(state.t)}
    for f in state._fields:
        if f == "aux":
            out.update({f"aux.{a}": getattr(state.aux, a).cpu().numpy()
                        for a in state.aux._fields})
        elif f != "t":
            out[f] = getattr(state, f).cpu().numpy()
    return out


def engine_config(scheduler: str, **kw):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.policy import Policy
    return EngineConfig(scheduler=scheduler,
                        policy=Policy.parse("user-fair"), device="cpu",
                        **GEOMETRY, **kw)


def sweep_experiment(scheduler="adaptbf", **kw):
    from repro_torch.api import Experiment
    ex = Experiment("user-fair", scheduler, n_servers=4, n_workers=4, seed=5,
                    device="cpu", **kw)
    ex.add_job(user=0, procs=30, req_mb=8, think_s=0.001)
    ex.add_job(user=1, procs=12, req_mb=4, think_s=0.004)
    return ex


def sweep_arrays(res) -> dict:
    return {f: np.asarray(getattr(res, f))
            for f in ("gbps", "issued", "completed", "dropped",
                      "idle_worker_ticks")}


def drained(device: str = "cpu", **kw) -> list:
    """``tests/test_shard.py``'s ``_SERVICE_PLANE`` drain order."""
    from repro_torch.bb.service import BBClient, BBCluster, JobMeta
    bb = BBCluster(n_servers=2, scheduler="adaptbf", policy="user-fair",
                   seed=7, device=device, **kw)
    clients = [BBClient(bb, JobMeta(job_id=i, user=i % 2, size=1 + i),
                        autodrain=False) for i in range(3)]
    for c in clients:
        c.open("/j%d" % c.job.job_id, "w")
    bb.drain()
    for i in range(6):
        for c in clients:
            c._req("write", "/j%d" % c.job.job_id, offset=i * 64,
                   data=b"x" * 64)
    return [(r.job.job_id, r.seqno, r.done_at) for r in bb.drain()]


def solo_arrays(res) -> dict:
    return {"gbps": np.asarray(res.gbps), "issued": np.asarray(res.issued),
            "completed": np.asarray(res.completed),
            "state": state_arrays(res.state)}


def jobs(schedulers, batch_schedulers, workspace=None, **knobs) -> dict:
    """Every check's runs: ``run`` for each of ``schedulers`` (for
    ``SHORT_SECONDS`` outside :data:`QUICK`),
    ``run_batch`` over ``BATCH_SEEDS`` for each of ``batch_schedulers``
    (and for fifo for ``SOLO_SECONDS``: ``sweep_only``),
    the adaptbf sweep (through a workspace when ``workspace`` is given), a
    themis solo for ``SOLO_SECONDS`` and the service's drain.  ``knobs``
    maps each kind of run to its mesh knobs (none: unsharded)."""
    from repro_torch.core import engine, shard
    out = {"run": {}, "run_batch": {}, "collectives": {}}
    for name in schedulers:
        cfg = engine_config(name, **knobs.get("run", {}))
        wl, table = engine.make_workload(cfg, JOBS)
        c0 = shard.COLLECTIVES
        res = engine.run(cfg, wl, table,
                         SECONDS if name in QUICK else SHORT_SECONDS)
        out["collectives"][name] = (shard.COLLECTIVES - c0, res["ticks"])
        out["run"][name] = state_arrays(res["state"])
    for name in batch_schedulers:
        cfg = engine_config(name, **knobs.get("run_batch", {}))
        wl, table = engine.make_workload(cfg, JOBS)
        out["run_batch"][name] = state_arrays(engine.run_batch(
            cfg, wl, table, SECONDS, seeds=BATCH_SEEDS)["state"])
    cfg = engine_config("fifo", **knobs.get("sweep_only", {}))
    wl, table = engine.make_workload(cfg, JOBS)
    c0 = shard.COLLECTIVES
    out["sweep_only"] = state_arrays(engine.run_batch(
        cfg, wl, table, SOLO_SECONDS, seeds=BATCH_SEEDS)["state"])
    out["collectives"]["sweep_only"] = shard.COLLECTIVES - c0
    out["sweep"] = sweep_arrays(sweep_experiment(**knobs.get("sweep", {}))
                                .sweep(SWEEP_GRID, SECONDS, seeds=SWEEP_SEEDS,
                                       workspace=workspace))
    out["solo"] = solo_arrays(sweep_experiment(
        "themis", **knobs.get("solo", {})).solo(0, SOLO_SECONDS))
    out["service"] = drained(**knobs.get("service", {}))
    return out


#: The mesh knobs of every kind of run in the world: 4 server slabs for
#: ``run``, a 2 x 2 mesh for ``run_batch`` and the sweep, 4 sweep ranks and
#: one slab for fifo's ``run_batch``, a 2-rank mesh for the solo (ranks 2
#: and 3 outside it) and the service.
WORLD_KNOBS = {"run": dict(shard_servers=4), "run_batch": dict(mesh_shape=(2, 2)),
               "sweep_only": dict(mesh_shape=(4, 1)),
               "sweep": dict(mesh_shape=(2, 2)), "solo": dict(shard_servers=2),
               "service": dict(shard_servers=2)}


def world_jobs(schedulers, batch_schedulers, workspace) -> dict:
    """:func:`jobs` with :data:`WORLD_KNOBS` on a rank of a 4-rank world.
    Returns rank 0's results, every rank's digest of its own, and whether
    this rank loaded ``jax``."""
    import sys
    out = jobs(schedulers, batch_schedulers, workspace, **WORLD_KNOBS)
    digest = hashlib.sha256(pickle.dumps(out)).hexdigest()
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, (digest, "jax" in sys.modules))
    return {"results": out, "digests": digests}


def fail():
    """A rank that raises (the launcher's error path)."""
    raise ValueError("rank failed on purpose")


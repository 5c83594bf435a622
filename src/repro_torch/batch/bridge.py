"""Bridge: an admitted batch timeline -> a scenario combinator tree (the
port's copy of the reference's ``repro.batch.bridge``, over
:mod:`repro_torch.scenario` and :class:`repro_torch.api.Experiment`).

The batch plane decides *when* jobs run; the serving planes decide how the
burst buffer's cycles are shared *while* they run.  This bridge closes the
loop: take any schedule (FCFS / EASY / plan — a per-job start vector) and
lower its admitted-job timeline into the scenario algebra, one
:func:`~repro_torch.scenario.leaf` per job overlaid into a single tree, so the
same timeline drives the engine or the live bb service and
themis/adaptbf/plan can be compared end-to-end on the workload the batch
scheduler actually admitted.

Mapping (documented in docs/batch.md#bridge-to-the-serving-planes):

  * **time** — batch hours compress into engine seconds: the timeline is
    scaled so its makespan lands on ``horizon_s`` (engine runs are a few
    seconds at dt=1 ms);
  * **size** — the BB reservation determines striping: a job reserving more
    than one server's capacity stripes over
    ``ceil(bb_bytes / bb_per_server)`` servers, reusing the engine's server
    geometry the cluster spec carried all along;
  * **procs / req_mb** — I/O pressure scales with the BB reservation (a
    checkpoint-heavy job drives more concurrent requests), compute size
    with the node count.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ..scenario import Scenario, leaf, overlay, to_jobs
from .queue import BatchQueue

#: Engine-seconds the scaled timeline spans by default.
DEFAULT_HORIZON_S = 8.0


def timeline_to_tree(queue: BatchQueue, start, *,
                     horizon_s: float = DEFAULT_HORIZON_S,
                     max_procs: int = 12, max_req_mb: int = 10):
    """The admitted timeline as one overlay of per-job leaves.

    Returns ``(tree, time_scale)`` — ``time_scale`` is the batch-seconds ->
    engine-seconds factor applied, so callers can translate windows back.
    """
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
    a = queue.arrays()
    start = np.asarray(start, np.float64)
    if start.shape != a["submit"].shape:
        raise ValueError(
            f"start has shape {start.shape}, queue has {queue.n_jobs} jobs")
    makespan = float((start + a["wall"]).max() - start.min())
    ts = horizon_s / max(makespan, 1e-9)
    t0 = float(start.min())
    cl = queue.cluster
    leaves = []
    for j in range(queue.n_jobs):
        bb_frac = float(a["bb"][j]) / cl.bb_total
        size = min(cl.n_servers,
                   max(1, math.ceil(float(a["bb"][j]) / cl.bb_per_server)))
        procs = int(np.clip(round(1 + bb_frac * (max_procs - 1)),
                            1, max_procs))
        req_mb = int(np.clip(a["nodes"][j], 1, max_req_mb))
        leaves.append(leaf(dict(
            user=j, size=size, procs=procs, req_mb=req_mb,
            phases=[dict(start_s=(float(start[j]) - t0) * ts,
                         duration_s=max(float(a["wall"][j]) * ts, 1e-3))])))
    return overlay(*leaves), ts


def to_scenario(queue: BatchQueue, start, *, name: str = "batch-admitted",
                horizon_s: float = DEFAULT_HORIZON_S) -> Scenario:
    """The admitted timeline as a named, JSON-round-trippable scenario."""
    tree, _ = timeline_to_tree(queue, start, horizon_s=horizon_s)
    return Scenario(name=name, tree=tree)


def to_experiment(queue: BatchQueue, start, *, scheduler: str = "themis",
                  policy: str = "job-fair",
                  horizon_s: float = DEFAULT_HORIZON_S,
                  **experiment_kw) -> Tuple["object", float]:
    """An :class:`repro_torch.api.Experiment` running the admitted timeline
    on the cluster's server geometry (``device`` and the rest of
    ``experiment_kw`` go to the Experiment); returns ``(experiment,
    horizon_s)`` so the caller runs exactly the window the timeline was
    scaled to."""
    from ..api import Experiment
    tree, _ = timeline_to_tree(queue, start, horizon_s=horizon_s)
    experiment_kw.setdefault("n_servers", queue.cluster.n_servers)
    experiment_kw.setdefault("max_jobs", max(8, queue.n_jobs))
    exp = Experiment(policy=policy, scheduler=scheduler,
                     **experiment_kw).add_jobs(to_jobs(tree))
    return exp, horizon_s

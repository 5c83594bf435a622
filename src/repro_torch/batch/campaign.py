"""Resumable batch campaigns: annealing sweeps cached in the workspace (the
port's copy of the reference's ``repro.batch.campaign``).

The batch analogue of :func:`repro_torch.workspace.campaign.run_sweep`: every
``(policy, seed)`` point of a batch sweep is keyed on

    (section="batch", name=<campaign>/s<seed>, scheduler=<policy>,
     params_hash=<PlanOptParams hash | "">, scenario_hash=<queue hash>, env)

where the queue-spec hash (:meth:`repro_torch.batch.queue.BatchQueue.queue_hash`)
canonically covers the job arrays + cluster geometry, so a record can only
be reused for the *identical* queue and — for ``plan`` — the identical
annealing configuration.  Re-running an interrupted (or grown) seed sweep
computes only the missing points; start vectors round-trip through the
workspace's bit-identical ndarray codec, so a cache hit reproduces the
plan exactly, not approximately.  All fresh points flush as one buffered
journal append per campaign invocation.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from ..workspace import RunKey, RunRecord, WorkspaceStore, env_fingerprint


def batch_point_key(bx, policy: str, seed: int, campaign: str,
                    queue_hash: str) -> RunKey:
    """The per-point workspace key; ``plan`` carries its params hash so a
    retuned annealer starts a new cache line instead of poisoning the old."""
    return RunKey(
        section="batch", name=f"{campaign}/s{int(seed)}", scheduler=policy,
        params_hash=bx.params.params_hash() if policy == "plan" else "",
        scenario_hash=queue_hash, env=env_fingerprint())


def run_batch_campaign(bx, policies: Sequence[str], seeds: Sequence[int], *,
                       store: WorkspaceStore, campaign: str = "batch"
                       ) -> Tuple[Dict[tuple, "object"], dict]:
    """Compute/reuse every ``(policy, seed)`` point; returns
    ``({(policy, seed): BatchResult}, report)`` with ``points`` / ``reused``
    / ``computed`` counters in the report, like :func:`run_sweep`'s."""
    from .api import BatchResult

    qh = bx.queue_hash()
    results: Dict[tuple, BatchResult] = {}
    report = {"campaign": campaign, "queue_hash": qh,
              "points": len(policies) * len(seeds),
              "reused": 0, "computed": 0}
    missing = []
    for policy in policies:
        for seed in seeds:
            key = batch_point_key(bx, policy, int(seed), campaign, qh)
            rec = store.get(key)
            if rec is None:
                missing.append((policy, int(seed), key))
                continue
            p = rec.payload
            results[(policy, int(seed))] = BatchResult(
                policy=policy, queue=bx.queue,
                start=np.asarray(p["start"], np.float64),
                order=(None if p.get("order") is None
                       else np.asarray(p["order"], np.int64)),
                seed=int(seed), metrics=dict(p["metrics"]))
            report["reused"] += 1
    if missing:
        with store.buffered(campaign) as buf:
            for policy, seed, key in missing:
                res = bx.run(policy, seed=seed)
                results[(policy, seed)] = res
                buf.put(RunRecord(key=key, payload={
                    "start": np.asarray(res.start),
                    "order": (None if res.order is None
                              else np.asarray(res.order)),
                    "metrics": {k: float(v)
                                for k, v in res.metrics.items()}}))
                report["computed"] += 1
    return results, report

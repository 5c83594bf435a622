"""The fleet rows on the port: the engine at facility scale and the shard
ladder, with the row names, geometry and job list of the reference's
``benchmarks/bench_fleet.py``.

The identical workload runs at 1, 2, 4, ... ranks
(``EngineConfig.shard_servers``), each rank owning a contiguous slab of
servers (:mod:`repro_torch.core.shard`).  x1 runs in this process on the
fused tick; every other rung is a world of its own, started by
:func:`repro_torch.launch.mesh.spawn` (gloo; on the card every rank shares
it), whose ranks run the sharded scan.  The ranks' results equal x1's, so
the ladder is a cost curve, not a speed-up.

    fleet_run_us_per_tick_x{k}   wall us/tick at k ranks (rank 0's clock
                                 between barriers around the run; the
                                 kernels are built beforehand)
    fleet_x{k}_vs_x1             wall-time ratio against x1
    fleet_gbps_x1                aggregate delivered GB/s at x1

Rungs stop at ``min(MAX_RANKS, S)``; a rung that does not divide ``S`` is
skipped.  Shrink knobs, as the reference's (full defaults in parentheses):
``BENCH_FLEET_SERVERS`` (128), ``BENCH_FLEET_JOBS`` (1024),
``BENCH_FLEET_WORKERS`` (4), ``BENCH_FLEET_SECONDS`` (0.1).
``fleet_reference.json`` holds the reference's rows at the full geometry
and 0.02 s, and its x1 run's integer counters
(``tools/record_figure_reference.py --fleet``).
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Optional

import numpy as np

from ..api import Experiment
from ..core import metrics
from .common import Row

REFERENCE_FILE = pathlib.Path(__file__).with_name("fleet_reference.json")

#: The rungs' transport: gloo, the backend for ranks that share one card.
BACKEND = "gloo"

#: The top of the ladder: the ranks of the largest rung.
MAX_RANKS = 4

#: The reference's fleet geometry besides S, J and W.
ENGINE_KW = dict(dt=2e-4, wheel=128, ring_cap=16, bin_ticks=500)


def load_reference() -> dict:
    """``fleet_reference.json``: ``{"rows": {name: {"derived", ...}}}``."""
    return json.loads(REFERENCE_FILE.read_text())


def geometry() -> tuple[int, int, int, float]:
    """(S, J, W, seconds) from the ``BENCH_FLEET_*`` knobs."""
    s = int(os.environ.get("BENCH_FLEET_SERVERS", "128"))
    j = int(os.environ.get("BENCH_FLEET_JOBS", "1024"))
    w = int(os.environ.get("BENCH_FLEET_WORKERS", "4"))
    seconds = float(os.environ.get("BENCH_FLEET_SECONDS", "0.1"))
    return s, j, w, seconds


def fleet_jobs(n_jobs: int, n_servers: int) -> list[dict]:
    """The reference's mixed fleet: 8 users, job spans of 1-4 servers,
    staggered starts."""
    return [dict(user=i % 8, size=min(1 + i % 4, n_servers), procs=2 + i % 6,
                 req_mb=1 + i % 4, start_s=0.002 * (i % 50),
                 think_s=0.004 + 0.001 * (i % 5)) for i in range(n_jobs)]


def ladder(n_servers: int) -> list[int]:
    """Powers of two up to ``min(MAX_RANKS, n_servers)`` that divide S."""
    out, k = [], 1
    while k <= min(MAX_RANKS, n_servers):
        if n_servers % k == 0:
            out.append(k)
        k *= 2
    return out


def experiment(s: int, j: int, w: int, device: str, k: int) -> Experiment:
    return Experiment(policy="user-fair", scheduler="themis", n_servers=s,
                      max_jobs=j, n_workers=w, device=device,
                      **ENGINE_KW, **({"shard_servers": k} if k > 1 else {})
                      ).add_jobs(fleet_jobs(j, s))


def rung(s: int, j: int, w: int, seconds: float, device: str, k: int
         ) -> dict:
    """One rung on every rank of a ``k``-rank world (``k = 1``: this
    process alone).  Returns the run's integer counters and aggregate,
    rank 0's wall seconds between barriers, and per rank its kernel
    launches and collectives per tick."""
    import torch
    import torch.distributed as dist
    from ..core import shard
    from ..kernels.tick_step import ops as ts_ops
    from ..kernels.token_select import ops as tk_ops

    exp = experiment(s, j, w, device, k)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    ts_ops.LAUNCHES = tk_ops.LAUNCHES = 0
    c0 = shard.COLLECTIVES
    shard.barrier()
    sync()
    t0 = time.perf_counter()
    res = exp.run(seconds)
    sync()
    shard.barrier()
    wall = time.perf_counter() - t0
    mine = {"tick_step": ts_ops.LAUNCHES, "token_select": tk_ops.LAUNCHES,
            "collectives_per_tick": (shard.COLLECTIVES - c0) / res.ticks}
    ranks = [mine]
    if k > 1:
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
    return {"wall_s": wall, "ticks": res.ticks, "ranks": ranks,
            "issued": np.asarray(res.issued),
            "completed": np.asarray(res.completed),
            "dropped": int(res.dropped),
            "idle_worker_ticks": int(res.idle_worker_ticks),
            "gbps": metrics.total_gbps(res, 0.0, seconds)}


def run_fleet(device: str = "cuda", seconds: Optional[float] = None,
              results: Optional[dict] = None) -> list[Row]:
    """The reference's fleet rows over ``seconds`` (default
    ``BENCH_FLEET_SECONDS``).  ``results``, when given, is filled with
    ``{k: rung(...)}`` plus each spawned rung's ``spawn_s`` (the world's
    seconds from start to its last process's exit)."""
    from ..launch.mesh import spawn

    s, j, w, knob_seconds = geometry()
    seconds = knob_seconds if seconds is None else seconds
    rows, base = [], None
    for k in ladder(s):
        t0 = time.perf_counter()
        if k == 1:
            out = rung(s, j, w, seconds, device, 1)
        else:
            out = spawn(rung, k, args=(s, j, w, seconds, device, k),
                        backend=BACKEND, device=device)
            out["spawn_s"] = time.perf_counter() - t0
        if results is not None:
            results[k] = out
        per_tick = out["wall_s"] * 1e6 / out["ticks"]
        path = "fused tick" if k == 1 else f"sharded scan, {BACKEND}"
        rows.append(Row(f"fleet_run_us_per_tick_x{k}", f"{per_tick:.1f}",
                        f"{per_tick:.1f} us/tick (S={s} J={j} W={w}, {k} "
                        f"rank{'s' if k > 1 else ''} on {device}, {path})",
                        (per_tick,), ()))
        if base is None:
            base = out["wall_s"]
            rows.append(Row("fleet_gbps_x1", "",
                            f"{out['gbps']:.1f} GB/s aggregate (S={s} J={j})",
                            (out["gbps"],), ()))
        else:
            ratio = out["wall_s"] / base
            rows.append(Row(f"fleet_x{k}_vs_x1", "",
                            f"{ratio:.2f}x wall vs 1 rank (x1 runs the fused "
                            f"tick, x{k} the sharded scan on {k} ranks: a "
                            "cost curve, not a speed-up)", (ratio,), ()))
    if len(ladder(s)) == 1:
        rows.append(Row("fleet_ladder_truncated", "",
                        f"1 rung; S={s} leaves no even split over 2 to "
                        f"{MAX_RANKS} ranks", (), ()))
    return rows

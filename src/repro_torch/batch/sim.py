"""Reservation-aware batch scheduling: the list-scheduling core and the
baselines, ported from the reference's ``repro.batch.sim``.

A job occupies ``nodes`` compute nodes **and** ``bb_bytes`` of the shared
burst-buffer pool for its whole ``[start, start + walltime)`` interval; a
start is feasible when both fit at the interval's left edge and at every
already-placed start inside it (usage is piecewise constant).

* :func:`schedule_order` places jobs one at a time in a priority order at
  their earliest feasible start, in float32 on the queue's device, with a
  leading batch axis of orders (the annealer's restarts).  It is the
  annealer's move evaluator, and it equals the reference's bit for bit:
  the usage at a point is summed over the placed jobs in XLA's order
  (:func:`repro_torch.core.ordered.ordered_sum`), since the burst-buffer
  sums add float32 reservations near 1e11 bytes and round.  The loop over
  the N placements reads nothing back to the host.
* :func:`simulate_fcfs`: arrival order with no overtaking.
* :func:`simulate_easy`: EASY backfilling, a host event loop in float64
  (as in the reference).

:func:`wait_metrics` gives the waiting-time objectives and
:func:`validate_schedule` replays a start vector against the capacity model.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from ..core.ordered import SUM_WINDOW, ordered_sum
from .queue import BatchQueue

#: Relative capacity slack absorbing f32 summation noise when many
#: ~1e11-byte reservations are added up; scheduler and validator share it.
CAP_TOL = 1e-5

#: Bounded-slowdown runtime floor (s).
BSLD_TAU_S = 10.0


def _limit(cap, device) -> torch.Tensor:
    """``float32(cap) * (1 + CAP_TOL)`` rounded in float32, as the
    reference computes the node and pool limits (a fill on the device, so
    a CUDA graph can hold it)."""
    return torch.full((), float(np.float32(cap) * np.float32(1.0 + CAP_TOL)),
                      dtype=torch.float32, device=device)


def queue_columns(queue: BatchQueue, device) -> torch.Tensor:
    """The queue's float32 columns ``[4, N]`` (submit, wall, nodes, bb) on
    ``device``: one upload, rounded from float64 as the reference's
    ``jnp.asarray(x, jnp.float32)`` rounds."""
    a = queue.arrays()
    cols = np.stack([a["submit"], a["wall"], a["nodes"], a["bb"]])
    return torch.from_numpy(cols.astype(np.float32)).to(device)


def _slot_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    """Sum over the last axis of the ``k`` placed slots as the reference
    sums the row of all ``n`` slots, where the unplaced ones hold +0.0:
    in order when ``n <= 32`` (the trailing zeros change nothing), else in
    XLA's windows over the zero-padded row."""
    if n > SUM_WINDOW:
        x = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    return ordered_sum(x)


def schedule_order(order: torch.Tensor, cols: torch.Tensor, n_nodes: int,
                   bb_cap: float, *, fcfs: bool = False) -> torch.Tensor:
    """Earliest-feasible-start list scheduling of ``order``.

    ``order`` holds permutations of the job indices, ``[N]`` or ``[R, N]``
    (integer); ``cols`` is :func:`queue_columns`'s ``[4, N]`` on the same
    device.  Returns float32 starts in original job indexing with
    ``order``'s shape.  With ``fcfs=True`` a job starts no earlier than the
    previous ordered job (no overtaking).

    Candidate starts for a job are its lower bound and every placed job's
    end (clamped up to the bound); a candidate is feasible when node and
    burst-buffer usage plus the job's demand fit at the candidate and at
    every placed start strictly inside the job's would-be interval.  The
    usage at a placed start does not depend on the candidate, so it is
    summed once per start, not once per (candidate, start) pair as the
    reference does: the same sums, in the same order."""
    squeeze = order.dim() == 1
    order = order.reshape(-1, order.shape[-1]).to(torch.int64)
    r, n = order.shape
    dev = cols.device
    node_lim, bb_lim = _limit(n_nodes, dev), _limit(bb_cap, dev)
    p_start = torch.full((r, n), torch.inf, device=dev)
    p_end = torch.full((r, n), -torch.inf, device=dev)
    p_use = torch.zeros((r, 2, n), device=dev)       # nodes, bb per slot
    prev = torch.zeros((r,), device=dev)
    start_out = torch.zeros((r, n), device=dev)
    for k in range(n):
        j = order[:, k]
        submit, wall, nodes, bb = cols[:, j]          # [R] each
        lower = torch.maximum(submit, prev) if fcfs else submit
        # Slots [0, k) are placed: candidates are the bound and their ends.
        ps, pe = p_start[:, :k], p_end[:, :k]
        cand = torch.maximum(torch.cat([torch.zeros_like(lower[:, None]), pe],
                                       dim=1), lower[:, None])   # [R, C]
        if k:
            # Usage at the k + 1 candidates and the k placed starts.
            x = torch.cat([cand, ps], dim=1)[:, :, None]          # [R, 2k+1, 1]
            active = (ps[:, None, :] <= x) & (pe[:, None, :] > x)
            use = _slot_sum(torch.where(active[:, :, None, :],
                                        p_use[:, None, :, :k], 0.0), n)
            fits = ((use[..., 0] + nodes[:, None] <= node_lim)
                    & (use[..., 1] + bb[:, None] <= bb_lim))       # [R, 2k+1]
            c = cand[:, :, None]
            inside = (ps[:, None, :] > c) & (ps[:, None, :] < c + wall[:, None, None])
            feasible = fits[:, :k + 1] & (fits[:, None, k + 1:]
                                          | ~inside).all(dim=2)   # [R, C]
        else:
            feasible = ((nodes <= node_lim) & (bb <= bb_lim))[:, None]
        start = torch.where(feasible, cand, torch.inf).amin(dim=1)
        p_start[:, k] = start
        p_end[:, k] = start + wall
        p_use[:, 0, k] = nodes
        p_use[:, 1, k] = bb
        prev = start
        start_out.scatter_(1, j[:, None], start[:, None])
    return start_out[0] if squeeze else start_out


def arrival_order(queue: BatchQueue) -> np.ndarray:
    """Stable submit-time order (ties keep declaration order)."""
    return np.argsort(queue.arrays()["submit"], kind="stable").astype(np.int32)


def simulate_fcfs(queue: BatchQueue, *, device="cuda") -> np.ndarray:
    """First-come-first-served with node + BB reservations: arrival order,
    no overtaking — a big BB reservation at the head blocks everyone."""
    dev = resolve_device(device)
    order = torch.from_numpy(arrival_order(queue)).to(dev)
    start = schedule_order(order, queue_columns(queue, dev),
                           queue.cluster.n_nodes, queue.cluster.bb_total,
                           fcfs=True)
    return start.cpu().numpy().astype(np.float64)


def _usage_at(t, ivals):
    nd = sum(i[2] for i in ivals if i[0] <= t < i[1])
    b = sum(i[3] for i in ivals if i[0] <= t < i[1])
    return nd, b


def _fits(t, w, nd, b, ivals, n_nodes, bb_cap) -> bool:
    pts = [t] + [s for (s, _e, _n, _b) in ivals if t < s < t + w]
    for x in pts:
        un, ub = _usage_at(x, ivals)
        if un + nd > n_nodes * (1.0 + CAP_TOL):
            return False
        if ub + b > bb_cap * (1.0 + CAP_TOL):
            return False
    return True


def _earliest_fit(t, w, nd, b, ivals, n_nodes, bb_cap) -> float:
    for c in sorted({t, *(e for (_s, e, _n, _b) in ivals if e > t)}):
        if _fits(c, w, nd, b, ivals, n_nodes, bb_cap):
            return c
    raise AssertionError("no feasible start — job exceeds cluster capacity")


def simulate_easy(queue: BatchQueue) -> np.ndarray:
    """EASY backfilling, BB-reservation-aware (host event loop, float64).

    At every arrival/completion event: start the queue head whenever it
    fits; otherwise give it a reservation at its earliest feasible time and
    let later queued jobs start *now* only if they also fit alongside that
    reservation — backfilling never delays the head."""
    a = queue.arrays()
    submit, wall, nodes, bb = a["submit"], a["wall"], a["nodes"], a["bb"]
    n_nodes, bb_cap = int(queue.cluster.n_nodes), float(queue.cluster.bb_total)
    n = len(submit)
    order = arrival_order(queue)
    start = np.full(n, np.inf)
    ivals: list[tuple] = []        # (start, end, nodes, bb) of started jobs
    queued: list[int] = []
    i, t = 0, 0.0
    while i < n or queued:
        while i < n and submit[order[i]] <= t + 1e-9:
            queued.append(int(order[i]))
            i += 1
        while queued:
            h = queued[0]
            if _fits(t, wall[h], nodes[h], bb[h], ivals, n_nodes, bb_cap):
                start[h] = t
                ivals.append((t, t + wall[h], int(nodes[h]), float(bb[h])))
                queued.pop(0)
                continue
            t_res = _earliest_fit(t, wall[h], nodes[h], bb[h], ivals,
                                  n_nodes, bb_cap)
            virt = ivals + [(t_res, t_res + wall[h], int(nodes[h]),
                             float(bb[h]))]
            for q in list(queued[1:]):
                if _fits(t, wall[q], nodes[q], bb[q], virt, n_nodes, bb_cap):
                    start[q] = t
                    entry = (t, t + wall[q], int(nodes[q]), float(bb[q]))
                    ivals.append(entry)
                    virt.append(entry)
                    queued.remove(q)
            break
        nxt = []
        if i < n:
            nxt.append(submit[order[i]])
        if queued:
            ends = [e for (_s, e, _n, _b) in ivals if e > t]
            if ends:
                nxt.append(min(ends))
        if not nxt:
            break
        t = min(nxt)
    if not np.all(np.isfinite(start)):
        raise AssertionError("EASY left a job unscheduled")
    return start


def wait_metrics(queue: BatchQueue, start,
                 *, tau_s: float = BSLD_TAU_S) -> Dict[str, float]:
    """The waiting-time objectives: mean, p95 and max wait, mean/p95
    bounded slowdown, and makespan."""
    a = queue.arrays()
    start = np.asarray(start, np.float64)
    wait = np.maximum(start - a["submit"], 0.0)
    bsld = np.maximum(1.0, (wait + a["wall"]) / np.maximum(a["wall"], tau_s))
    return {
        "mean_wait_s": float(wait.mean()),
        "p95_wait_s": float(np.percentile(wait, 95)),
        "max_wait_s": float(wait.max()),
        "mean_bsld": float(bsld.mean()),
        "p95_bsld": float(np.percentile(bsld, 95)),
        "makespan_s": float((start + a["wall"]).max() - a["submit"].min()),
    }


def validate_schedule(queue: BatchQueue, start) -> None:
    """Raise ``AssertionError`` unless ``start`` is a feasible schedule:
    every start at/after its submit and node/BB usage within capacity at
    every start event (checked just after it, as the reference does).
    The checks raise explicitly, so they also hold under ``python -O``."""
    def require(cond, msg):
        if not cond:
            raise AssertionError(msg)

    a = queue.arrays()
    start = np.asarray(start, np.float64)
    require(np.all(np.isfinite(start)), "non-finite start time")
    # f32 starts of late events lose sub-ms precision; compare with slack
    slack = 1e-4 * max(1.0, float(np.abs(start).max()))
    require(np.all(start >= a["submit"] - slack),
            f"job starts before submit: {start - a['submit']}")
    end = start + a["wall"]
    n_lim = queue.cluster.n_nodes * (1.0 + 2 * CAP_TOL)
    b_lim = queue.cluster.bb_total * (1.0 + 2 * CAP_TOL)
    eps = max(1e-6, float(np.abs(end).max()) * 4 * 2.0 ** -23)
    for x0 in start:
        x = x0 + eps
        on = (start <= x) & (end > x)
        require(a["nodes"][on].sum() <= n_lim,
                f"node capacity violated at t={x}: "
                f"{a['nodes'][on].sum()} > {queue.cluster.n_nodes}")
        require(a["bb"][on].sum() <= b_lim,
                f"BB capacity violated at t={x}: "
                f"{a['bb'][on].sum():.4g} > {queue.cluster.bb_total:.4g}")

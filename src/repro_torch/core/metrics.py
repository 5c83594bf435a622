"""Measurement plane: throughput bins -> the paper's reported metrics (numpy
only; the port's own copy of the reference's ``repro.core.metrics``)."""
from __future__ import annotations

import numpy as np


def jain_index(values) -> float:
    """Jain's fairness index of an allocation vector: ``(Σx)² / (n·Σx²)``.

    1.0 is a perfectly even split, ``1/n`` is one entity taking everything.
    Entries that are exactly zero are kept (a starved job *is* unfairness);
    an empty or all-zero vector returns 1.0 (nothing to be unfair about).
    """
    x = np.asarray(list(values), dtype=np.float64)
    if x.size == 0:
        return 1.0
    sq = float((x * x).sum())
    if sq == 0.0:
        return 1.0
    return float(x.sum()) ** 2 / (x.size * sq)


def mean_cov(values) -> tuple[float, float]:
    """Mean and coefficient of variation (std/mean) of a metric across runs —
    the reduction the paper's variance-at-scale claims are stated in.  A
    zero mean reports CoV 0.0 (no signal, no variation claim)."""
    a = np.asarray(list(values), dtype=np.float64)
    m = float(a.mean())
    return m, (float(a.std() / abs(m)) if m else 0.0)


def median_gbps(result, job: int, t0: float, t1: float) -> float:
    """Median per-bin throughput of a job over [t0, t1) seconds."""
    g = result["gbps"][job]
    b0, b1 = int(t0 / result["bin_s"]), int(t1 / result["bin_s"])
    window = g[b0:b1]
    return float(np.median(window)) if window.size else 0.0


def std_gbps(result, job: int, t0: float, t1: float) -> float:
    g = result["gbps"][job]
    b0, b1 = int(t0 / result["bin_s"]), int(t1 / result["bin_s"])
    window = g[b0:b1]
    return float(np.std(window)) if window.size else 0.0


def total_gbps(result, t0: float, t1: float) -> float:
    g = result["gbps"].sum(axis=0)
    b0, b1 = int(t0 / result["bin_s"]), int(t1 / result["bin_s"])
    window = g[b0:b1]
    return float(np.median(window)) if window.size else 0.0


def share_trace(result, jobs, t0: float = 0.0, t1: float = None) -> np.ndarray:
    """Per-bin share of total throughput for each job (paper Fig. 14 view)."""
    g = result["gbps"][list(jobs)]
    tot = np.maximum(g.sum(axis=0, keepdims=True), 1e-12)
    tr = g / tot
    b0 = int(t0 / result["bin_s"])
    b1 = tr.shape[1] if t1 is None else int(t1 / result["bin_s"])
    return tr[:, b0:b1]


def time_to_fairness(result, jobs, targets, tol: float = 0.1,
                     t0: float = 0.0) -> float:
    """First time (s) after t0 when every job's share is within tol of target
    and stays there for 3 consecutive bins; inf if never."""
    tr = share_trace(result, jobs)
    b0 = int(t0 / result["bin_s"])
    ok = np.all(np.abs(tr - np.asarray(targets)[:, None]) <= tol, axis=0)
    run = 0
    for b in range(b0, ok.shape[0]):
        run = run + 1 if ok[b] else 0
        if run >= 3:
            return (b - 2) * result["bin_s"]
    return float("inf")


def completion_time(result, job: int, n_requests: int) -> float:
    """Time (s) at which the job finished its n-th request (bin resolution)."""
    per_bin = result["gbps"][job] * result["bin_s"] * 1e9  # bytes per bin
    cum = np.cumsum(per_bin)
    # bytes per request from totals
    done = result["completed"][job]
    if done == 0:
        return float("inf")
    req_b = cum[-1] / done
    target = n_requests * req_b
    idx = np.searchsorted(cum, target - 1e-6)
    if idx >= len(cum):
        return float("inf")
    return (idx + 1) * result["bin_s"]

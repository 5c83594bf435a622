"""Batch-queue model: jobs with node + burst-buffer reservations (the port's
copy of the reference's ``repro.batch.queue``; pure numpy, the same arrays
and the same ``queue_hash`` for the same ``(name, n_jobs, seed)``).

The third plane's workload vocabulary (docs/batch.md#queue-model).  A
:class:`BatchJob` is what an HPC user submits: a submit time, a requested
walltime, a node count, and a **burst-buffer reservation** — the paper's
setting (and Kopanski & Rzadca's, arXiv:2109.00082) where BB capacity is a
first-class scheduled resource next to nodes, reserved for the job's whole
lifetime.  A :class:`ClusterSpec` reuses the engine's server geometry: the
BB pool is ``n_servers × bb_per_server`` bytes, the same shape
:class:`repro_torch.core.engine.EngineConfig` and the bb service carve up.

Everything is deterministic: presets generate queues from
``np.random.default_rng`` seeded through
:func:`repro_torch.core.prng.normalize_seed`, and
:meth:`BatchQueue.queue_hash` canonically hashes the job arrays + cluster
geometry (the bit-identical ndarray codec of :mod:`repro_torch.workspace`), so
workspace campaign records key on the *exact* queue they were computed for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np

GB = 2 ** 30


@dataclasses.dataclass(frozen=True)
class BatchJob:
    """One submitted job: reservation demands, not live I/O traffic."""

    submit_s: float            # arrival at the batch queue
    walltime_s: float          # requested (and, in the sim, actual) runtime
    nodes: int                 # compute-node reservation
    bb_bytes: float            # burst-buffer reservation, held for the run

    def __post_init__(self):
        if self.submit_s < 0:
            raise ValueError(f"submit_s must be >= 0, got {self.submit_s}")
        if self.walltime_s <= 0:
            raise ValueError(f"walltime_s must be > 0, got {self.walltime_s}")
        if self.nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {self.nodes}")
        if self.bb_bytes < 0:
            raise ValueError(f"bb_bytes must be >= 0, got {self.bb_bytes}")


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Cluster geometry: compute nodes + the engine's BB server pool."""

    n_nodes: int = 32
    n_servers: int = 2          # engine server geometry (EngineConfig.n_servers)
    bb_per_server: float = 64 * GB

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.n_servers < 1:
            raise ValueError(f"n_servers must be >= 1, got {self.n_servers}")
        if self.bb_per_server <= 0:
            raise ValueError(
                f"bb_per_server must be > 0, got {self.bb_per_server}")

    @property
    def bb_total(self) -> float:
        """The shared pool every reservation draws from (paper §2: the
        burst buffer is remote-shared, striped over all servers)."""
        return float(self.n_servers * self.bb_per_server)


@dataclasses.dataclass(frozen=True)
class BatchQueue:
    """An immutable queue: jobs + the cluster they contend for."""

    jobs: Tuple[BatchJob, ...]
    cluster: ClusterSpec = ClusterSpec()

    def __post_init__(self):
        for i, job in enumerate(self.jobs):
            if job.nodes > self.cluster.n_nodes:
                raise ValueError(
                    f"job {i} requests {job.nodes} nodes > cluster "
                    f"{self.cluster.n_nodes}: it can never be scheduled")
            if job.bb_bytes > self.cluster.bb_total:
                raise ValueError(
                    f"job {i} reserves {job.bb_bytes:.3g} BB bytes > pool "
                    f"{self.cluster.bb_total:.3g}: it can never be scheduled")

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    def arrays(self) -> Dict[str, np.ndarray]:
        """The simulator's columnar view (f64 seconds / f64 bytes / i32)."""
        return {
            "submit": np.asarray([j.submit_s for j in self.jobs], np.float64),
            "wall": np.asarray([j.walltime_s for j in self.jobs], np.float64),
            "nodes": np.asarray([j.nodes for j in self.jobs], np.int32),
            "bb": np.asarray([j.bb_bytes for j in self.jobs], np.float64),
        }

    def queue_hash(self) -> str:
        """Canonical content hash of the queue spec: the job arrays through
        the workspace's bit-identical ndarray codec + cluster geometry.
        Two spellings of the same queue share the hash; one changed second
        of one walltime re-keys — campaign records can only ever be reused
        for the identical computation."""
        from ..workspace import content_hash, encode_payload
        doc = {
            "jobs": encode_payload(self.arrays()),
            "cluster": {"n_nodes": self.cluster.n_nodes,
                        "n_servers": self.cluster.n_servers,
                        "bb_per_server": float(self.cluster.bb_per_server)},
        }
        return content_hash(doc)


def make_queue(jobs: Iterable[BatchJob | dict],
               cluster: ClusterSpec | None = None) -> BatchQueue:
    """Queue from jobs or plain dicts (the JSON-ish spelling)."""
    out = tuple(j if isinstance(j, BatchJob) else BatchJob(**j) for j in jobs)
    return BatchQueue(jobs=out, cluster=cluster or ClusterSpec())


# -- presets ------------------------------------------------------------------

#: Preset name -> one-line description (the bench section and docs list it).
PRESET_DOCS = {
    "bb-heavy": "checkpoint jobs whose BB reservations contend hard for the "
                "pool while nodes stay plentiful (the paper's headline case)",
    "longtail": "lognormal long-tail walltimes, moderate BB demand — "
                "head-of-line blocking territory for FCFS",
    "mixed": "bimodal small/large jobs in both nodes and BB demand",
}


def queue_presets() -> Tuple[str, ...]:
    return tuple(PRESET_DOCS)


def queue_preset(name: str, *, n_jobs: int = 32, seed: int = 0,
                 cluster: ClusterSpec | None = None) -> BatchQueue:
    """A named workload family, deterministic per ``(name, n_jobs, seed)``.

    Seeding routes through :func:`~repro_torch.core.prng.normalize_seed`,
    so negative/huge seeds normalize exactly as they do on every other PRNG
    path.  Arrival rates are tuned so the queue
    saturates — an empty queue has no waiting time to schedule."""
    from ..core.prng import normalize_seed
    if name not in PRESET_DOCS:
        raise ValueError(f"unknown queue preset {name!r}; "
                         f"have {sorted(PRESET_DOCS)}")
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    cl = cluster or ClusterSpec()
    rng = np.random.default_rng(int(normalize_seed(seed)))
    pool = cl.bb_total

    # mean inter-arrival chosen well below mean service demand so a backlog
    # forms (load > 1 over the generated window): that is where FCFS vs
    # EASY vs plan-based actually differ.
    if name == "bb-heavy":
        wall = rng.uniform(300.0, 900.0, n_jobs)
        nodes = rng.integers(1, max(2, cl.n_nodes // 8), n_jobs)
        bb = rng.uniform(0.35, 0.75, n_jobs) * pool     # 2 rarely fit at once
        gap = wall.mean() / 4.0
    elif name == "longtail":
        wall = np.minimum(rng.lognormal(mean=5.5, sigma=1.1, size=n_jobs)
                          + 60.0, 6 * 3600.0)
        nodes = rng.integers(1, max(2, cl.n_nodes // 2), n_jobs)
        bb = rng.uniform(0.05, 0.30, n_jobs) * pool
        gap = wall.mean() / 6.0
    else:   # mixed
        small = rng.random(n_jobs) < 0.7
        wall = np.where(small, rng.uniform(120.0, 600.0, n_jobs),
                        rng.uniform(1800.0, 5400.0, n_jobs))
        nodes = np.where(small, rng.integers(1, 4, n_jobs),
                         rng.integers(cl.n_nodes // 4,
                                      cl.n_nodes // 2 + 1, n_jobs))
        bb = np.where(small, rng.uniform(0.02, 0.15, n_jobs),
                      rng.uniform(0.30, 0.60, n_jobs)) * pool
        gap = wall.mean() / 5.0
    submit = np.cumsum(rng.exponential(gap, n_jobs))
    submit -= submit[0]                       # first job arrives at t=0
    jobs = tuple(BatchJob(submit_s=float(submit[i]),
                          walltime_s=float(wall[i]),
                          nodes=int(np.clip(nodes[i], 1, cl.n_nodes)),
                          bb_bytes=float(np.clip(bb[i], 0.0, pool)))
                 for i in range(n_jobs))
    return BatchQueue(jobs=jobs, cluster=cl)

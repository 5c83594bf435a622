"""Burst-buffer service: ThemisIO servers + metadata-stamped clients (§4).

The port of the reference's ``bb/service.py``: the *functional* plane
(ordering, correctness, data integrity) that the engine models the
*performance* of.  Every client call is a :class:`Request` carrying job
metadata (job id, user, group, node count — §4.1); servers queue requests
per job and drain them in the order chosen by a scheduler of the port's
registry (:mod:`repro_torch.core.scheduler`) — the *same* objects the engine
runs.  A virtual clock accounts service time (bytes / bandwidth), so tests
assert ordering and bounded delay without wall-clock sleeps.

The scheduler state (aux, segments, share table) lives on the cluster's
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``); the queues are
Python.  Every worker pop reads its pick back to the host, as the
reference's eager drain does: the completion order is the observable, so
pops are not batched.  On the card a themis pop launches the
``token_select`` kernel on one ``[1, J]`` row; on the CPU it runs the
kernel's plain version.

Where the port's scheduler core differs from the reference's, the service
adapts and the hooks stay as the engine uses them:

* keys: the service splits its key once per pop, as the reference does, and
  hands ``select`` that sub-key's uniforms (:meth:`Scheduler.draws`, one
  worker per pop), bit-exact to ``jax.random``; the key chain is walked on
  the host and the draws of 256 pops are taken at once;
* shares and sync take a :class:`~repro_torch.core.policy.PolicyChain`,
  built once per job-table change;
* a charge debits one server's row: the hook runs on a one-row slice of the
  aux state.

The client is the POSIX-compliance analogue of the paper's interception
(§4.4): the file-like object *is* the interception boundary — applications
use plain open/read/write/close and never see job metadata being attached.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import _device
from ..core import prng
from ..core.baselines import AuxState
from ..core.engine import EngineConfig
from ..core.global_sync import sync_segments
from ..core.job_table import JobTable, make_table
from ..core.policy import Policy, PolicyChain
from ..core.scheduler import Scheduler, TickView, get_scheduler
from ..fs.store import FileSystem


#: Pops whose draws :meth:`BBCluster._pop_draws` takes in one batch.
DRAW_BLOCK = 256


def _split(key: tuple) -> tuple:
    """``jax.random.split(key)`` on a key held as two Python integers:
    ``(new key, sub-key)``."""
    return (prng.threefry2x32(key[0], key[1], 0, 0),
            prng.threefry2x32(key[0], key[1], 0, 1))


def phase_at(phases, t0: float) -> Optional[dict]:
    """The resolved phase covering scenario time ``t0``, or ``None``.

    ``phases`` is one job's entry of ``LoweredScenario.phases`` — the
    lowering the engine's ``[J, P]`` arrays are built from, so the two
    planes cannot disagree about when a job is live."""
    return next((p for p in phases
                 if p["start_s"] <= t0 < p["end_s"]), None)


@dataclasses.dataclass
class JobMeta:
    job_id: int
    user: int = 0
    group: int = 0
    size: int = 1          # node count
    priority: float = 1.0


@dataclasses.dataclass
class Request:
    job: JobMeta
    op: str                # write | read | stat | mkdir | readdir | unlink
    path: str
    offset: int = 0
    data: Optional[bytes] = None
    size: int = 0
    seqno: int = 0
    done_at: float = 0.0
    result: object = None


def _nbytes(req: Request) -> int:
    return len(req.data) if req.data is not None else req.size


class BBServer:
    """One burst-buffer node: job monitor + communicator + controller + workers."""

    def __init__(self, sid: int, fs: FileSystem, *, n_workers: int = 8,
                 bandwidth: float = 22e9, meta_op_s: float = 20e-6):
        self.sid = sid
        self.fs = fs
        self.n_workers = n_workers
        self.worker_bw = bandwidth / n_workers
        self.meta_op_s = meta_op_s
        self.queues: dict[int, deque[Request]] = {}
        self.worker_free = np.zeros(n_workers)
        self.known_jobs: dict[int, JobMeta] = {}
        self.last_heartbeat: dict[int, float] = {}
        self.segments: Optional[np.ndarray] = None  # λ-synced, set by cluster
        self.processed: list[tuple[float, int, str]] = []  # (t, job, op)

    # -- communicator ---------------------------------------------------------
    def submit(self, req: Request):
        self.known_jobs[req.job.job_id] = req.job
        self.queues.setdefault(req.job.job_id, deque()).append(req)

    def heartbeat(self, job: JobMeta, now: float):
        self.known_jobs[job.job_id] = job
        self.last_heartbeat[job.job_id] = now

    def demand(self) -> dict[int, int]:
        return {j: len(q) for j, q in self.queues.items() if q}

    # -- worker ----------------------------------------------------------------
    def _service(self, req: Request) -> float:
        if req.op in ("stat", "mkdir", "readdir", "unlink", "create"):
            return self.meta_op_s
        return self.meta_op_s + _nbytes(req) / self.worker_bw

    def _execute(self, req: Request):
        fs = self.fs
        if req.op == "write":
            fs.write(req.path, req.offset, req.data)
        elif req.op == "read":
            req.result = fs.read(req.path, req.offset, req.size)
        elif req.op == "stat":
            req.result = fs.stat(req.path)
        elif req.op == "create":
            req.result = fs.create(req.path)
        elif req.op == "mkdir":
            req.result = fs.create(req.path, is_dir=True)
        elif req.op == "readdir":
            req.result = fs.listdir(req.path)
        elif req.op == "unlink":
            fs.unlink(req.path)

    def pop_order(self, sched: Scheduler, cfg: EngineConfig, p,
                  shares: torch.Tensor, slot_of: dict[int, int],
                  aux: AuxState, rand) -> Optional[Request]:
        """One worker pop: delegate the pick to the shared scheduler core.

        ``shares`` is this server's row ``[1, J]`` of the cluster's share
        table, ``aux`` the cluster-wide scheduler state (sliced here to this
        server's row, so every hook sees the engine's ``[S, J]`` layout) and
        ``rand`` the pop's uniforms (None for a scheduler that draws
        nothing)."""
        if not self.queues:
            return None
        nslots = shares.shape[-1]
        qcount = np.zeros((1, nslots), np.int32)
        head_time = np.full((1, nslots), np.inf, np.float32)
        req_bytes = np.zeros((nslots,), np.float32)
        for j in sorted(self.queues):
            q = self.queues[j]
            if not q or j not in slot_of:
                continue
            slot = slot_of[j]
            qcount[0, slot] = len(q)
            head_time[0, slot] = float(q[0].seqno)
            req_bytes[slot] = float(_nbytes(q[0]))
        if qcount.sum() == 0:
            return None
        dev = shares.device
        aux_row = AuxState(*(x[self.sid:self.sid + 1] for x in aux))
        idx = int(sched.select(
            cfg, p, shares, torch.as_tensor(head_time, device=dev),
            torch.as_tensor(qcount > 0, device=dev), aux_row,
            torch.as_tensor(req_bytes, device=dev), rand)[0])
        if idx < 0:
            return None
        job = {v: k for k, v in slot_of.items()}[idx]
        return self.queues[job].popleft()


class BBCluster:
    """A group of I/O nodes + the λ-sync controller loop.

    ``scheduler`` names any entry of the port's scheduler registry; the
    cluster drives drain order through that shared object, as the engine
    does.  ``tick_impl`` is accepted for the reference's signature and
    selects nothing: a themis pop launches ``token_select`` on the card and
    runs its plain version on the CPU.  ``shard_servers``/``mesh_shape`` go
    to the engine's config, which refuses sharding (not ported)."""

    def __init__(self, n_servers: int = 2, *, policy: str | Policy = "size-fair",
                 scheduler: str = "themis", scheduler_params=None,
                 n_workers: int = 8,
                 bandwidth: float = 22e9, max_jobs: int = 32,
                 lam_s: float = 0.5, seed: int = 0, stripes: int = 1,
                 tick_impl: str = "auto", shard_servers: int = 1,
                 mesh_shape=None, device: str = "cuda"):
        self.device = _device.resolve_device(device)
        self.fs = FileSystem(n_servers, default_stripes=stripes)
        self.servers = [BBServer(s, self.fs, n_workers=n_workers,
                                 bandwidth=bandwidth) for s in range(n_servers)]
        self.policy = Policy.parse(policy) if isinstance(policy, str) else policy
        self.sched = get_scheduler(scheduler)
        self.cfg = EngineConfig(
            n_servers=n_servers, max_jobs=max_jobs, n_workers=n_workers,
            server_bw=bandwidth, scheduler=scheduler,
            scheduler_params=scheduler_params, policy=self.policy,
            shard_servers=shard_servers, mesh_shape=mesh_shape, seed=seed,
            device=str(self.device))
        self.aux = self.sched.init_aux(n_servers, max_jobs, self.device)
        self.max_jobs = max_jobs
        self.lam_s = lam_s
        self.clock = 0.0
        self.last_sync = -1e9
        self._last_interval = -1e9
        self._key = tuple(int(w) for w in prng.PRNGKey(seed))
        self._draws, self._draw_i = None, DRAW_BLOCK
        self._seq = itertools.count()
        self.slot_of: dict[int, int] = {}
        self._synced = np.zeros((max_jobs,), bool)
        self._table_cache: Optional[JobTable] = None
        self._table_key: Optional[tuple] = None
        self._chains: dict[int, PolicyChain] = {}

    def _slot(self, job_id: int) -> int:
        if job_id not in self.slot_of:
            self.slot_of[job_id] = len(self.slot_of)
            if len(self.slot_of) > self.max_jobs:
                raise RuntimeError("job slots exhausted")
        return self.slot_of[job_id]

    def _table(self) -> JobTable:
        metas = {}
        for srv in self.servers:
            metas.update(srv.known_jobs)
        ordered = sorted(self.slot_of.items(), key=lambda kv: kv[1])
        rows = []
        for job_id, slot in ordered:
            m = metas.get(job_id, JobMeta(job_id))
            rows.append((job_id, slot, m.user, m.group, m.size, m.priority))
        key = tuple(rows)
        if key != self._table_key:
            specs = [{"user": u, "group": g, "size": sz, "priority": p}
                     for _, _, u, g, sz, p in rows]
            self._table_cache = make_table(specs, max_jobs=self.max_jobs,
                                           device=self.device)
            self._table_key = key
            self._chains = {}
        return self._table_cache

    def _chain(self, policy: Policy) -> PolicyChain:
        """``policy`` compiled against the current job table (cached until
        the table changes)."""
        table = self._table()
        if id(policy) not in self._chains:
            self._chains[id(policy)] = PolicyChain.from_table(policy, table)
        return self._chains[id(policy)]

    def sync(self):
        """λ-sync: all-gather demand, Sinkhorn-balance global shares (§3.1)."""
        demand = np.zeros((len(self.servers), self.max_jobs), bool)
        for si, srv in enumerate(self.servers):
            for j, n in srv.demand().items():
                demand[si, self._slot(j)] = n > 0
        segs = sync_segments(self._chain(self.policy),
                             torch.as_tensor(demand, device=self.device))
        segs = segs.cpu().numpy()
        for si, srv in enumerate(self.servers):
            srv.segments = segs[si]
        self._synced = demand.any(axis=0)
        self.last_sync = self.clock

    def submit(self, req: Request):
        req.seqno = next(self._seq)
        self._slot(req.job.job_id)
        # route by first stripe server (data ops) / hash server (meta ops)
        if req.op in ("write", "read"):
            try:
                plan = list(self.fs.stripe_plan(req.path, req.offset,
                                                req.size or len(req.data or b"")))
                sid = plan[0][0] if plan else 0
            except FileNotFoundError:
                sid = self.fs.ring.server_of(req.path)
        else:
            sid = self.fs.ring.server_of(req.path)
        self.servers[sid].submit(req)

    def _tick_view(self) -> tuple[TickView, int]:
        """Snapshot the Python-side queues into a :class:`TickView` on the
        cluster's device, with the number of queued requests."""
        s_, j_ = len(self.servers), self.max_jobs
        qcount = np.zeros((s_, j_), np.int32)
        known = np.zeros((s_, j_), bool)
        seg = np.zeros((s_, j_), np.float32)
        for si, srv in enumerate(self.servers):
            for j in srv.known_jobs:
                if j in self.slot_of:
                    known[si, self.slot_of[j]] = True
            for j, n in srv.demand().items():
                qcount[si, self._slot(j)] = n
            if srv.segments is not None:
                seg[si] = srv.segments
        t = lambda a: torch.as_tensor(a, device=self.device)
        view = TickView(qcount=t(qcount), known=t(known), seg=t(seg),
                        synced=t(self._synced),
                        live=torch.ones((j_,), dtype=torch.bool,
                                        device=self.device))
        return view, int(qcount.sum())

    def _pop_draws(self):
        """The uniforms of this pop's sub-key (None for a scheduler that
        draws nothing).  The cluster splits its key once per pop, as the
        reference does; the chain of keys is walked on the host in Python
        integers and its draws are taken :data:`DRAW_BLOCK` pops at a time
        (one :meth:`Scheduler.draws` call, moved to the device at once)."""
        if self._draw_i == DRAW_BLOCK:
            subs = []
            for _ in range(DRAW_BLOCK):
                self._key, sub = _split(self._key)
                subs.append(sub)
            draws = self.sched.draws(torch.tensor(subs, dtype=torch.int64), 1)
            self._draws = None if draws is None else draws.to(self.device)
            self._draw_i = 0
        self._draw_i += 1
        return None if self._draws is None else self._draws[self._draw_i - 1]

    def _charge(self, cfg, p, sid: int, slot: int, nbytes: float):
        """Debit server ``sid``'s accounts for one pop: the hook on that
        server's row of the aux state, written back into the row."""
        if type(self.sched).charge is Scheduler.charge:
            return
        row = AuxState(*(x[sid:sid + 1] for x in self.aux))
        dev = self.device
        row = self.sched.charge(
            cfg, p, row, torch.full((1,), slot, dtype=torch.int64, device=dev),
            torch.full((1,), nbytes, dtype=torch.float32, device=dev))
        for x, r in zip(self.aux, row):
            x[sid:sid + 1] = r

    def drain(self) -> list[Request]:
        """Process every queued request in scheduler order; returns them in
        global completion order (the observable the paper's policies shape)."""
        done: list[Request] = []
        cfg, sched = self.cfg, self.sched
        # Resolve the params schema once per drain: concrete on this plane.
        p = sched.params(cfg)
        mu_s = sched.mu_s(p, cfg.dt)
        ctrl_s = float(sched.ctrl_overhead_s(p))
        stalls = 0
        while True:
            if sched.uses_segments and (
                    self.clock - self.last_sync >= self.lam_s
                    or any(s.segments is None for s in self.servers)):
                self.sync()
            view, queued = self._tick_view()
            if queued == 0:
                break
            # μ-interval bookkeeping: the functional plane has no fixed tick,
            # so refill/update fire when the virtual clock passes a boundary.
            if self.clock - self._last_interval >= mu_s:
                elapsed = (mu_s if self._last_interval < -1e8
                           else self.clock - self._last_interval)
                self.aux = sched.refill(cfg, p, self.aux, float(elapsed))
                self.aux = sched.interval_update(cfg, p, self.aux, view.qcount)
                self._last_interval = self.clock
            shares = sched.tick_shares(
                cfg, self._chain(cfg.policy) if cfg.policy else None, view)
            progressed = False
            for srv in self.servers:
                for w in range(srv.n_workers):
                    rand = self._pop_draws()
                    req = srv.pop_order(
                        sched, cfg, p, shares[srv.sid:srv.sid + 1],
                        self.slot_of, self.aux, rand)
                    if req is None:
                        continue
                    progressed = True
                    slot = self.slot_of[req.job.job_id]
                    self._charge(cfg, p, srv.sid, slot, float(_nbytes(req)))
                    srv._execute(req)
                    t0 = max(srv.worker_free[w], self.clock)
                    srv.worker_free[w] = t0 + srv._service(req) + ctrl_s
                    req.done_at = srv.worker_free[w]
                    srv.processed.append((req.done_at, req.job.job_id, req.op))
                    done.append(req)
            if not progressed:
                # Interval schedulers may throttle (budgets exhausted mid-μ):
                # jump the virtual clock to the next boundary so the next
                # round recomputes budgets; two fruitless jumps in a row mean
                # a request no quota can ever admit.
                if sched.has_intervals and stalls < 2:
                    stalls += 1
                    self.clock = self._last_interval + mu_s
                    continue
                break
            stalls = 0
            self.clock = max(self.clock, min(s.worker_free.min()
                                             for s in self.servers))
        done.sort(key=lambda r: r.done_at)
        return done


class BBFile:
    """POSIX-style file handle over the cluster (client side, §4.4)."""

    def __init__(self, client: "BBClient", path: str, mode: str):
        self.client = client
        self.path = path
        self.pos = 0
        if "w" in mode:
            client._req("create", path)

    def write(self, data: bytes) -> int:
        self.client._req("write", self.path, offset=self.pos, data=data)
        self.pos += len(data)
        return len(data)

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            size = self.client.cluster.fs.stat(self.path).size - self.pos
        r = self.client._req("read", self.path, offset=self.pos, size=size)
        self.pos += size
        return r.result

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self.pos = offset
        elif whence == 1:
            self.pos += offset
        else:
            self.pos = self.client.cluster.fs.stat(self.path).size + offset
        return self.pos

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BBClient:
    """Per-process client: stamps job metadata on every request (§4.1)."""

    def __init__(self, cluster: BBCluster, job: JobMeta, *, autodrain: bool = True):
        self.cluster = cluster
        self.job = job
        self.autodrain = autodrain

    def _req(self, op, path, **kw) -> Request:
        req = Request(job=self.job, op=op, path=path, **kw)
        self.cluster.submit(req)
        if self.autodrain:
            self.cluster.drain()
        return req

    def open(self, path: str, mode: str = "r") -> BBFile:
        return BBFile(self, path, mode)

    def write_burst(self, path: str, n: int, nbytes: int, *,
                    offset: int = 0) -> list[Request]:
        """Queue ``n`` back-to-back writes of ``nbytes`` without draining —
        one checkpoint-style burst, so one drain round sees the whole
        phase's demand at once (:meth:`repro_torch.api.ExperimentService.replay`)."""
        reqs = []
        for i in range(n):
            req = Request(job=self.job, op="write", path=path,
                          offset=offset + i * nbytes, data=b"\0" * nbytes)
            self.cluster.submit(req)
            reqs.append(req)
        return reqs

    def mkdir(self, path: str):
        self._req("mkdir", path)

    def stat(self, path: str):
        return self._req("stat", path).result

    def readdir(self, path: str) -> list[str]:
        return self._req("readdir", path).result

    def unlink(self, path: str):
        self._req("unlink", path)

    def heartbeat(self, now: float):
        for srv in self.cluster.servers:
            srv.heartbeat(self.job, now)

"""Discrete-event burst-buffer engine (paper §5 testbed), in PyTorch.

The port of ``repro.core.engine`` for one device: ``S`` servers, each with
``W`` workers sharing the server's bandwidth, serving phased client
populations held in fixed-shape tensors.  The reference's ``lax.scan`` over
ticks is a Python loop here; ``t`` is a Python int in that loop, so the
cadences that depend on it (the ring slot, the throughput bin, the λ-sync
every ``sync_ticks``, an interval scheduler's μ boundary) are decided on
the host, and nothing inside the loop reads a value back from the card.

Each tick: (1) arrivals from the time wheel, phase starts, interval bursts
and Poisson draws go into the per-(server, job) rings, (2) the scheduler
builds the ``[S, J]`` share table, (3) the W workers draw and pop — for
themis and fifo (the schedulers with a kernel mode and no aux state) in
one ``tick_step`` kernel launch (``tick_impl="fused"``, the default), for
the others, or on request (``tick_impl="scan"``), one worker at a time,
the themis draw through the ``token_select`` kernel — and (4) every
``sync_ticks`` the λ-sync rebalances the segments.  The PRNG stream is the
reference's (:mod:`.prng`), so from the same state both engines draw the
same numbers.

Every state tensor leads with a lane axis ``L``: :func:`run_batch`
runs P parameter points × K seeds as ``L = P * K`` lanes, and one tick
advances all of them with one set of launches (the kernels take the lanes
as ``L * S`` server rows).  :func:`run` is one lane.  The numeric knobs of
the scheduler's params are per-lane float32 tensors
(:func:`~.params.lane_params`); structural ones (``mu_ticks``) are shared.

The tick updates the state's time wheel and arrival rings in place (they
are the two large tensors); every other leaf is replaced.

Fleet sharding (:mod:`.shard`): with ``shard_servers``/``mesh_shape`` set,
every rank of a ``torch.distributed`` world calls :func:`run` or
:func:`run_batch`; each rank of the mesh keeps a slab of the servers and
runs the per-worker scan on the gathered control plane, and every rank
returns the full result, equal to the unsharded run's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _device
from . import prng
from .baselines import AuxState
from .global_sync import sync_segments
from .job_table import JobTable, make_table
from .ordered import ordered_sum
from .params import SchedulerParams, lane_params
from .policy import Policy, PolicyChain
from .scheduler import Scheduler, TickView, get_scheduler
from .shard import (AXIS_SERVERS, AXIS_SWEEP, SLAB_FIELDS, ServerSlabs,
                    any_rank, broadcast, resolve_shard, server_shards,
                    state_specs, world_size)
from ..kernels.tick_step.ops import tick_step
from ..scenario.lowering import (ARRIVAL_CLOSED, ARRIVAL_INTERVAL,
                                 ARRIVAL_POISSON, lower_for_config)

#: ``EngineConfig.tick_impl`` vocabulary: one ``tick_step`` launch per tick,
#: or the per-worker loop.
TICK_IMPLS = ("fused", "scan")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine configuration; the fields and defaults of the reference's
    ``EngineConfig`` plus ``device`` (``"cuda"`` unless the caller asks for
    ``"cpu"``).  ``tick_impl`` is ``"fused"`` or ``"scan"``."""

    n_servers: int = 2
    max_jobs: int = 16
    n_workers: int = 8           # per server
    dt: float = 1e-3             # seconds per tick
    server_bw: float = 22e9      # bytes/s combined per server
    wheel: int = 4096            # future-arrival time-wheel horizon (ticks)
    ring_cap: int = 512          # per (server, job) arrival-time ring
    bin_ticks: int = 100         # throughput bin
    scheduler: str = "themis"
    policy: Optional[Policy] = None
    sync_ticks: int = 500        # λ in ticks; 0 disables sync
    sinkhorn_iters: int = 32
    scheduler_params: Optional[SchedulerParams] = None
    fabric_exponent: float = 0.0
    tick_impl: str = "fused"
    shard_servers: int = 1
    mesh_shape: Optional[tuple] = None
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        for name in ("n_servers", "max_jobs", "n_workers"):
            v = getattr(self, name)
            if not isinstance(v, (int, np.integer)) or v < 1:
                raise ValueError(
                    f"EngineConfig.{name} must be a positive int, got {v!r}")
        if self.tick_impl not in TICK_IMPLS:
            raise ValueError(
                f"unknown tick_impl {self.tick_impl!r}; one of {TICK_IMPLS}")
        get_scheduler(self.scheduler)
        resolve_shard(self)    # the mesh knobs fail here, before any run

    @property
    def worker_bw(self) -> float:
        """Per-worker bandwidth (bytes/s), derated by the fabric exponent."""
        eff = float(self.n_servers) ** (-self.fabric_exponent)
        return self.server_bw / self.n_workers * eff


def resolve_tick_impl(cfg: EngineConfig, sched: Scheduler) -> str:
    """The worker path of this (config, scheduler), by the reference's rule:
    the fused kernel needs a scheduler with a kernel mode (``kernel_tick``)
    whose ``charge`` is the base no-op (the kernel carries no aux state);
    every other scheduler runs the per-worker scan.  A server-sharded
    config always runs the scan, silently: the fused kernel's ``[S, J, W]``
    window is not slab-local."""
    lowered = (sched.kernel_tick and type(sched).charge is Scheduler.charge
               and server_shards(cfg) == 1)
    return "fused" if cfg.tick_impl == "fused" and lowered else "scan"


class Workload(NamedTuple):
    """Phased client population (static over a run); see the reference."""

    phase_start: torch.Tensor   # i32[J, P]  phase start tick
    phase_end: torch.Tensor     # i32[J, P]  arrivals stop at/after this tick
    phase_req: torch.Tensor     # f32[J, P]  request bytes while phase is current
    phase_think: torch.Tensor   # i32[J, P]  closed-loop think ticks
    arrival_mode: torch.Tensor  # i32[J, P]  ARRIVAL_CLOSED/_INTERVAL/_POISSON
    arrival_every: torch.Tensor  # i32[J, P] inter-burst ticks (interval mode)
    arrival_rate: torch.Tensor  # f32[J, P]  per-proc arrivals/tick (poisson)
    procs: torch.Tensor         # i32[S, J]  client processes of job j on server s
    overhead_s: torch.Tensor    # f32[J]  fixed per-request server cost

    @property
    def n_phases(self) -> int:
        return self.phase_start.shape[1]


class EngineState(NamedTuple):
    """Engine state; every tensor leaf may lead with a lane axis ``[L]``."""

    t: int                       # tick (host-side)
    key: torch.Tensor            # int64[2]  threefry key words (uint32 values)
    qcount: torch.Tensor         # i32[S, J]
    head: torch.Tensor           # i32[S, J]
    arr_time: torch.Tensor       # f32[S, J, CAP]
    wheel: torch.Tensor          # i32[S, J, H]
    free_at: torch.Tensor        # f32[S, W]
    known: torch.Tensor          # bool[S, J]
    seg: torch.Tensor            # f32[S, J]  λ-synced segments
    synced: torch.Tensor         # bool[J]    included in last sync
    aux: AuxState
    bytes_bin: torch.Tensor      # f32[J, NB]
    issued: torch.Tensor         # i32[J]
    completed: torch.Tensor      # i32[J]
    idle_worker_ticks: torch.Tensor  # i32[] workers idle while demand existed
    dropped: torch.Tensor        # i32[] arrivals rejected by full rings


def map_state(state: EngineState, fn) -> EngineState:
    """Apply ``fn`` to every tensor leaf of ``state`` (aux included)."""
    return EngineState(**{
        f: (state.t if f == "t" else
            AuxState(*map(fn, state.aux)) if f == "aux" else
            fn(getattr(state, f)))
        for f in EngineState._fields})


def make_workload(cfg: EngineConfig, jobs: Sequence[dict]
                  ) -> tuple[Workload, JobTable]:
    """Lower job spec dicts (see ``scenario.lowering``) into a workload and
    a job table on ``cfg.device``."""
    device = _device.resolve_device(cfg.device)
    low = lower_for_config(jobs, cfg)
    wl = Workload(*(torch.as_tensor(getattr(low, f), device=device)
                    for f in Workload._fields))
    return wl, make_table(low.jobs, max_jobs=cfg.max_jobs, device=device)


def init_state(cfg: EngineConfig, n_bins: int, device=None,
               seeds: Optional[Sequence[int]] = None,
               rows: Optional[int] = None) -> EngineState:
    """The zero state of one lane per seed (by default the one seed
    ``cfg.seed``); every leaf leads with ``[len(seeds)]``.  ``rows`` sizes
    the server axis of the slab fields (a rank's slab; default all
    ``n_servers``)."""
    device = _device.resolve_device(cfg.device if device is None else device)
    s_ = cfg.n_servers if rows is None else rows
    j_, w_ = cfg.max_jobs, cfg.n_workers
    seeds = (cfg.seed,) if seeds is None else seeds
    lanes = (len(seeds),)
    z = lambda shape, dtype: torch.zeros(lanes + shape, dtype=dtype,
                                         device=device)
    key = torch.stack([prng.PRNGKey(s, device) for s in seeds])
    return EngineState(
        t=0, key=key,
        qcount=z((s_, j_), torch.int32), head=z((s_, j_), torch.int32),
        arr_time=z((s_, j_, cfg.ring_cap), torch.float32),
        wheel=z((s_, j_, cfg.wheel), torch.int32),
        free_at=z((s_, w_), torch.float32), known=z((s_, j_), torch.bool),
        seg=z((s_, j_), torch.float32), synced=z((j_,), torch.bool),
        aux=get_scheduler(cfg.scheduler).init_aux(s_, j_, device, lanes),
        bytes_bin=z((j_, n_bins), torch.float32),
        issued=z((j_,), torch.int32), completed=z((j_,), torch.int32),
        idle_worker_ticks=z((), torch.int32), dropped=z((), torch.int32))


def _accept(qcount: torch.Tensor, arrivals: torch.Tensor, cap: int):
    """The arrivals each ring has room for."""
    return torch.minimum(arrivals, torch.clamp_min(cap - qcount, 0))


def _write_ring(arr_time, head, qcount, accepted, t_sec: float) -> None:
    """Stamp ``accepted[l, s, j]`` new requests into each ring, in place."""
    cap = arr_time.shape[-1]
    idx = torch.arange(cap, dtype=torch.int32, device=arr_time.device)
    pos = (idx - (head + qcount)[..., None]) % cap
    arr_time.masked_fill_(pos < accepted[..., None], t_sec)


def _account_arrivals(state: EngineState, arrivals: torch.Tensor,
                      accepted: torch.Tensor) -> EngineState:
    """The counters after ``accepted`` of ``arrivals[l, s, j]`` went into
    the rings; the rest are rejected and counted in ``dropped``."""
    return state._replace(
        qcount=state.qcount + accepted,
        known=state.known | (accepted > 0),
        issued=state.issued + accepted.sum(dim=-2).to(torch.int32),
        dropped=state.dropped
        + (arrivals - accepted).sum(dim=(-2, -1)).to(torch.int32))


def _push_arrivals(state: EngineState, arrivals: torch.Tensor,
                   t_sec: float) -> EngineState:
    """Append ``arrivals[l, s, j]`` identically-stamped requests to each
    ring (in place); arrivals beyond a ring's free space are rejected and
    counted in ``dropped``."""
    accepted = _accept(state.qcount, arrivals, state.arr_time.shape[-1])
    _write_ring(state.arr_time, state.head, state.qcount, accepted, t_sec)
    return _account_arrivals(state, arrivals, accepted)


def make_tick(cfg: EngineConfig, wl: Workload, table: JobTable, n_bins: int,
              slabs: Optional[ServerSlabs] = None,
              n_lanes: Optional[int] = None):
    """Build the per-tick transition ``tick(p, state) -> state``.

    ``state`` leads every leaf with its lanes (:func:`init_state`); ``p`` is a params schema of the configured scheduler,
    with Python numbers (every lane the same) or per-lane tensors
    (:func:`~.params.lane_params`).  ``tick.poisson_unfinished`` holds, per
    lane, whether a Poisson draw ran out of iterations (see
    :func:`~.prng.poisson`); :func:`run` raises if it is set.

    With ``slabs`` (a server-sharded run) the state's slab fields hold this
    rank's rows: each tick gathers the control plane (one collective),
    computes every decision on the full ``[L, S, ...]`` plane with the
    unsharded tick's ops, and keeps its own rows.  ``n_lanes``, the run's
    lanes over every sweep rank, sizes the Poisson loops (default: this
    state's lanes), so each rank runs the iterations the unsharded run
    does."""
    s_, j_, w_ = cfg.n_servers, cfg.max_jobs, cfg.n_workers
    cap, h_ = cfg.ring_cap, cfg.wheel
    device = wl.procs.device
    sched = get_scheduler(cfg.scheduler)
    fused = resolve_tick_impl(cfg, sched) == "fused"
    # fifo and plan draw nothing: their ticks skip the workers' uniforms.
    draws = (sched.kernel_select_mode == "themis" if fused
             else type(sched).draws is not Scheduler.draws)
    mode_np = wl.arrival_mode.cpu().numpy()
    has_interval = bool((mode_np == ARRIVAL_INTERVAL).any())
    has_poisson = bool((mode_np == ARRIVAL_POISSON).any())
    chain = None
    if sched.uses_segments:
        if cfg.policy is None:
            raise ValueError(f"scheduler {cfg.scheduler!r} needs a policy")
        chain = PolicyChain.from_table(cfg.policy, table)
    # A sharded tick gathers the aux only for schedulers that keep aux
    # state (themis and fifo never touch it).
    keeps_aux = (type(sched).pre_tick is not Scheduler.pre_tick
                 or type(sched).charge is not Scheduler.charge)
    worker_ids = torch.arange(w_, dtype=torch.int64, device=device)
    # True divisions by device scalars: dividing by a Python float on the
    # card multiplies by its reciprocal, which rounds differently.
    dt_t = torch.tensor(cfg.dt, dtype=torch.float32, device=device)
    wbw_t = torch.tensor(cfg.worker_bw, dtype=torch.float32, device=device)
    dt32 = np.float32(cfg.dt)

    phase_real = wl.phase_end > wl.phase_start                    # [J, P]
    phase_idx = torch.arange(wl.n_phases, dtype=torch.int32,
                             device=device)[None, :]
    real_np = phase_real.cpu().numpy()
    start_np = wl.phase_start.cpu().numpy()
    end_np = wl.phase_end.cpu().numpy()
    contig = np.zeros_like(real_np)
    contig[:, 1:] = (real_np[:, 1:] & real_np[:, :-1]
                     & (start_np[:, 1:] == end_np[:, :-1])
                     & (mode_np[:, 1:] == ARRIVAL_CLOSED)
                     & (mode_np[:, :-1] == ARRIVAL_CLOSED))
    fresh_start = torch.as_tensor(~contig, device=device)
    closed_start = phase_real & fresh_start & (wl.arrival_mode == ARRIVAL_CLOSED)
    every = torch.clamp_min(wl.arrival_every, 1)
    poisson_mode = wl.arrival_mode == ARRIVAL_POISSON
    rate_np = wl.arrival_rate.cpu().numpy()
    procs_np = wl.procs.cpu().numpy().astype(np.float32)
    poisson_plans: dict = {}

    def poisson_plan(t: int, n_lanes: int) -> tuple[int, int]:
        """Iterations of the two Poisson loops at tick ``t``, from the
        host's copy of the rates (the workload is static).  A small margin
        around λ = 10 runs a branch whose lanes the select then drops,
        never skips one that is needed."""
        live = (real_np & (start_np <= t) & (end_np > t)
                & (mode_np == ARRIVAL_POISSON))
        sig = (live.tobytes(), n_lanes)
        if sig not in poisson_plans:
            lam = (np.where(live, rate_np, 0.0).sum(axis=1)[None, :]
                   * procs_np).astype(np.float64)
            knuth = (lam > 0) & (lam < 10 * (1 + 1e-5))
            ki = prng.poisson_iters(float(lam[knuth].max(initial=0.0)),
                                    int(knuth.sum()) * n_lanes)
            ri = (prng.rejection_iters(lam.size * n_lanes)
                  if (lam >= 10 * (1 - 1e-5)).any() else 0)
            poisson_plans[sig] = (ki, ri)
        return poisson_plans[sig]

    lane_cache: dict = {}

    def lanes_of(p, n_lanes: int):
        """``p`` with per-lane tensors (cached: no host-to-device copy on
        later ticks)."""
        names = p.numeric_fields()
        if not names or torch.is_tensor(getattr(p, names[0])):
            return p
        if (p, n_lanes) not in lane_cache:
            lane_cache[p, n_lanes] = lane_params([p], n_lanes, device)
        return lane_cache[p, n_lanes]

    lanes_of(sched.params(cfg), 1)

    def gather_plane(state: EngineState, arrivals, slot: int, t_sec: float):
        """The sharded tick's arrivals: stamp this slab's rings, then gather
        the control plane (the wheel's current slot, the ring window of
        the W requests at each head, and every small slab field) and
        account the arrivals on the full plane.  Returns that plane
        (``arr_time`` and ``wheel`` stay this rank's) and the read of a
        ring's head stamp at a full-plane ``head``."""
        rows = slabs.rows
        wheel_slot = state.wheel[..., slot].clone()
        _write_ring(state.arr_time, state.head, state.qcount,
                    _accept(state.qcount, wheel_slot + rows(arrivals), cap),
                    t_sec)
        state.wheel[..., slot] = 0
        ring_idx = ((state.head[..., None] + worker_ids) % cap).to(torch.int64)
        window = state.arr_time.gather(3, ring_idx)
        aux = list(state.aux) if keeps_aux else []
        (wheel_slot, qcount, head, known, seg, free_at, window, *aux
         ) = slabs.gather([wheel_slot, state.qcount, state.head, state.known,
                           state.seg, state.free_at, window, *aux])
        plane = state._replace(
            qcount=qcount, head=head, known=known, seg=seg, free_at=free_at,
            aux=AuxState(*aux) if keeps_aux else state.aux)
        arrivals = wheel_slot + arrivals
        plane = _account_arrivals(plane, arrivals,
                                  _accept(qcount, arrivals, cap))

        def head_stamp(h):
            # Worker w pops at ring offset (h - head) % cap <= w < W, so the
            # window covers every head a tick reads.
            off = ((h - head) % cap).clamp_max(w_ - 1).to(torch.int64)
            return window.gather(3, off[..., None])[..., 0]
        return plane, head_stamp

    def tick(p, state: EngineState) -> EngineState:
        n_l = state.qcount.shape[0]
        p = lanes_of(p, n_l)
        ctrl = sched.ctrl_overhead_s(p)
        lane = torch.arange(n_l, device=device)
        t = state.t
        # The reference's compiled tick contracts ``t*dt + dt`` into one
        # fused multiply-add (one rounding).  It is exact in float64 (both
        # terms are multiples of dt's last bit), so the port rounds the
        # float64 sum once to float32.
        t_prod = float(np.float64(np.float32(t)) * np.float64(dt32))
        t_sec = float(np.float32(t_prod))
        t_next = float(np.float32(t_prod + np.float64(dt32)))
        started = (wl.phase_start <= t) & phase_real
        phase_live = started & (wl.phase_end > t)
        live = phase_live.any(dim=1)
        cur = torch.clamp_min(
            torch.where(started, phase_idx, -1).amax(dim=1), 0).to(torch.int64)
        take_cur = lambda a: a.gather(1, cur[:, None])[:, 0]
        req_now = take_cur(wl.phase_req)
        think_now = take_cur(wl.phase_think)
        recycle = live & (take_cur(wl.arrival_mode) == ARRIVAL_CLOSED)

        # -- 1. arrivals: time-wheel slot + phase starts + open-loop --------
        slot = t % h_
        inject = ((wl.phase_start == t) & closed_start).any(dim=1)
        if has_interval:
            gap = (t - wl.phase_start) % every
            inject = inject | (phase_live & (gap == 0)
                               & (wl.arrival_mode == ARRIVAL_INTERVAL)
                               ).any(dim=1)
        arrivals = torch.where(inject[None, :], wl.procs, 0).expand(
            n_l, s_, j_)
        key_carry = state.key
        if has_poisson:
            ks = prng.split(state.key)
            key_carry, kp = ks[:, 0], ks[:, 1]
            lam = ordered_sum(torch.where(phase_live & poisson_mode,
                                          wl.arrival_rate, 0.0))
            knuth_iters, rejection_iters = poisson_plan(t, n_lanes or n_l)
            counts, unfinished = prng.poisson(
                kp, (lam[None, :] * wl.procs).expand(n_l, s_, j_),
                knuth_iters=knuth_iters, rejection_iters=rejection_iters)
            arrivals = arrivals + counts
            tick.poisson_unfinished = (unfinished
                                       if tick.poisson_unfinished is None
                                       else tick.poisson_unfinished | unfinished)
        if slabs is None:
            arrivals = state.wheel[..., slot] + arrivals
            state.wheel[..., slot] = 0
            state = _push_arrivals(state, arrivals, t_sec)
            arr_time = state.arr_time
            head_stamp = lambda h: arr_time.gather(
                3, (h % cap).to(torch.int64)[..., None])[..., 0]
        else:
            state, head_stamp = gather_plane(state, arrivals, slot, t_sec)

        # -- 2. scheduler bookkeeping -----------------------------------------
        aux = sched.pre_tick(cfg, p, state.aux, state.qcount, t)
        shares = sched.tick_shares(cfg, chain, TickView(
            qcount=state.qcount, known=state.known, seg=state.seg,
            synced=state.synced, live=live))

        # -- 3. workers -------------------------------------------------------
        keys = prng.split(key_carry)
        key, sub = keys[:, 0], keys[:, 1]
        # Worker w's key, fold_in(sub, w), for the schedulers that draw.
        worker_keys = lambda: prng.fold_in(sub[None], worker_ids[:, None])
        wheel = state.wheel
        # Flat offset of row (l, s) in the [L, S, J, H] wheel (a sharded
        # tick's holds its slab's rows).
        n_rows = wheel.shape[1]
        row_base = (lane[:, None] * n_rows
                    + torch.arange(n_rows, device=device)) * j_
        bytes_job = torch.zeros((n_l * j_,), dtype=torch.float32, device=device)
        pops_job = torch.zeros((n_l * j_,), dtype=torch.int32, device=device)

        def service_of(j_safe, ctrl):
            rb = req_now[j_safe]
            return rb, rb / wbw_t + wl.overhead_s[j_safe] + ctrl

        def rearm_slot(new_free, j_safe):
            """Wheel slot of the closed-loop re-arrival after completion +
            think time."""
            off = torch.clamp(
                torch.ceil((new_free - t_sec) / dt_t).to(torch.int32)
                + think_now[j_safe], 1, h_ - 1)
            return ((t + off) % h_).to(torch.int64)

        def wheel_add(j_safe, slot, vals):
            """``wheel[l, s, j_safe, slot] += vals`` (integer adds, any
            order), one ``index_add_`` on the flat wheel; a sharded tick
            adds its own rows."""
            if slabs is not None:
                j_safe, slot, vals = map(slabs.rows, (j_safe, slot, vals))
            base = row_base.view(row_base.shape + (1,) * (j_safe.dim() - 2))
            wheel.view(-1).index_add_(0, ((base + j_safe) * h_ + slot).reshape(-1),
                                      vals.reshape(-1))

        def job_slot(j_safe):
            """Flat index of (lane, job) into the ``[L * J]`` tallies."""
            return (lane.view((n_l,) + (1,) * (j_safe.dim() - 1)) * j_
                    + j_safe).reshape(-1)

        if fused:
            free = state.free_at < t_next                          # [L, S, W]
            u_all = (prng.uniform(worker_keys(), (s_,)).permute(1, 2, 0)
                     if draws else free.new_zeros(free.shape, dtype=torch.float32))
            ring_idx = ((state.head[..., None] + worker_ids) % cap).to(torch.int64)
            window = state.arr_time.gather(3, ring_idx)
            rows = lambda x: x.reshape((n_l * s_,) + x.shape[2:]).contiguous()
            sel, valid, demand_any, qcount, pops_sj = tick_step(
                rows(shares), rows(state.qcount), rows(window), rows(free),
                rows(u_all), mode=sched.kernel_select_mode)
            lanes_back = lambda x: x.reshape((n_l, s_) + x.shape[1:])
            sel, valid, demand_any, qcount, pops_sj = map(
                lanes_back, (sel, valid, demand_any, qcount, pops_sj))
            head = (state.head + pops_sj) % cap
            j_safe = torch.clamp_min(sel, 0).to(torch.int64)        # [L, S, W]
            rb, service = service_of(j_safe, ctrl)
            start_t = torch.clamp_min(state.free_at, t_sec)
            free_at = torch.where(valid, start_t + service, state.free_at)
            slot2 = rearm_slot(free_at, j_safe)
            wheel_add(j_safe, slot2, (valid & recycle[j_safe]).to(torch.int32))
            add_b = torch.where(valid, rb, 0.0)
            # Per-worker order, as the scan adds (float sums follow it on
            # the CPU; on the card index_add_ is atomic).
            for w in range(w_):
                bytes_job.index_add_(0, job_slot(j_safe[..., w]),
                                     add_b[..., w].reshape(-1))
            pops_job.index_add_(0, job_slot(j_safe),
                                valid.reshape(-1).to(torch.int32))
            idle = (free & ~valid & demand_any).sum(dim=(1, 2))
        else:
            rand = sched.draws(worker_keys(), s_) if draws else None
            ctrl_row = ctrl[..., 0] if torch.is_tensor(ctrl) else ctrl
            qcount, head = state.qcount, state.head
            free_at = state.free_at.clone()
            idle = torch.zeros((n_l,), dtype=torch.int64, device=device)
            for w in range(w_):
                free = free_at[..., w] < t_next
                demand = qcount > 0
                head_time = torch.where(demand, head_stamp(head), torch.inf)
                j_sel = sched.select(cfg, p, shares, head_time, demand, aux,
                                     req_now, None if rand is None else rand[w])
                valid = free & (j_sel >= 0)
                j_safe = torch.clamp_min(j_sel, 0).to(torch.int64)
                step = valid.to(torch.int32)
                # One pop per server row: a scatter along the job axis.
                col = j_safe[..., None]
                qcount = qcount.scatter_add(-1, col, -step[..., None])
                head = head.scatter_add(-1, col, step[..., None]) % cap
                rb, service = service_of(j_safe, ctrl_row)
                start_t = torch.clamp_min(free_at[..., w], t_sec)
                new_free = torch.where(valid, start_t + service, free_at[..., w])
                free_at[..., w] = new_free
                wheel_add(j_safe, rearm_slot(new_free, j_safe),
                          (valid & recycle[j_safe]).to(torch.int32))
                add_b = torch.where(valid, rb, 0.0)
                bytes_job.index_add_(0, job_slot(j_safe), add_b.reshape(-1))
                pops_job.index_add_(0, job_slot(j_safe), step.reshape(-1))
                aux = sched.charge(cfg, p, aux, j_safe, add_b)
                idle = idle + (free & ~valid & demand.any(dim=-1)).sum(dim=-1)

        # -- fold the phase into the state, then the λ-sync -----------------
        b = min(t // cfg.bin_ticks, n_bins - 1)
        state.bytes_bin[..., b] += bytes_job.view(n_l, j_)
        state = state._replace(
            t=t + 1, key=key, qcount=qcount, head=head, wheel=wheel,
            free_at=free_at, aux=aux,
            completed=state.completed + pops_job.view(n_l, j_),
            idle_worker_ticks=state.idle_worker_ticks + idle.to(torch.int32))
        if sched.uses_segments and cfg.sync_ticks > 0 \
                and state.t % cfg.sync_ticks == 0:
            support = state.known & live
            state = state._replace(
                seg=sync_segments(chain, support, n_iters=cfg.sinkhorn_iters),
                synced=support.any(dim=-2))
        if slabs is not None:
            slab = lambda x: slabs.rows(x).contiguous()
            state = state._replace(
                qcount=slab(state.qcount), head=slab(state.head),
                free_at=slab(state.free_at), known=slab(state.known),
                seg=slab(state.seg),
                aux=AuxState(*map(slab, state.aux)) if keeps_aux else state.aux)
        return state

    tick.poisson_unfinished = None
    return tick


def _poisson_short(tick) -> bool:
    return (tick.poisson_unfinished is not None
            and bool(tick.poisson_unfinished.any()))


def _check_poisson(short: bool) -> None:
    if short:
        raise RuntimeError(
            "a Poisson draw needed more iterations than the engine gave it "
            "(prng.poisson_iters / prng.rejection_iters); its count differs "
            "from jax.random.poisson")


def _ticks_bins(cfg: EngineConfig, sim_seconds: float) -> tuple[int, int]:
    ticks = int(round(sim_seconds / cfg.dt))
    return ticks, max(1, (ticks + cfg.bin_ticks - 1) // cfg.bin_ticks)


def _check_device(cfg: EngineConfig, wl: Workload, table: JobTable):
    device = _device.resolve_device(cfg.device)
    if wl.procs.device != device or table.active.device != device:
        raise ValueError(f"workload/table live on {wl.procs.device}, the "
                         f"config asks for {device}")
    return device


def _simulate(cfg, wl, table, ticks, n_bins, device, points, seeds,
              p_lanes, grid: Optional[str] = None) -> EngineState:
    """``len(points) * len(seeds)`` lanes (point-major) for ``ticks`` ticks;
    ``p_lanes(points, seeds)`` gives the params the tick takes.  With
    ``cfg``'s mesh knobs set the run is sharded, and ``grid`` (``"points"``
    or ``"seeds"``; None for :func:`run`) names the axis a sweep axis
    splits."""
    shard = resolve_shard(cfg)
    if shard is None:
        tick = make_tick(cfg, wl, table, n_bins)
        state = init_state(cfg, n_bins, device, seeds=seeds * len(points))
        p = p_lanes(points, seeds)
        for _ in range(ticks):
            state = tick(p, state)
        _check_poisson(_poisson_short(tick))
        return state
    split = grid is not None and shard.n_sweep > 1
    lanes = points if grid == "points" else seeds
    if split and len(lanes) % shard.n_sweep:
        what = "params_points" if grid == "points" else "seeds"
        raise ValueError(
            f"len({what})={len(lanes)} is not divisible by the mesh's sweep "
            f"axis ({shard.n_sweep}); each rank sweeps an equal slice of "
            "the grid")
    n_lanes = len(points) * len(seeds)
    mesh = shard.mesh(device.type)
    state, short = None, False
    if mesh.get_coordinate() is not None:
        slabs = ServerSlabs(shard, mesh, cfg.n_servers)
        if split:
            block = len(lanes) // shard.n_sweep
            mine = lanes[slabs.sweep_index * block:
                         (slabs.sweep_index + 1) * block]
            points, seeds = ((mine, seeds) if grid == "points"
                             else (points, mine))
        # A sweep-only mesh (one server slab) gathers nothing per tick.
        tick = make_tick(cfg, wl, table, n_bins, n_lanes=n_lanes,
                         slabs=slabs if shard.n_servers > 1 else None)
        state = init_state(cfg, n_bins, device, seeds=seeds * len(points),
                           rows=slabs.height)
        p = p_lanes(points, seeds)
        for _ in range(ticks):
            state = tick(p, state)
        short = _poisson_short(tick)
        state = _collect(state, slabs, split)
    _check_poisson(any_rank(short))
    if state is None:       # a rank outside the mesh: rank 0 sends it all
        state = init_state(cfg, n_bins, device,
                           seeds=[0] * n_lanes)._replace(t=ticks)
    return _from_rank0(state, everything=world_size() > shard.n_devices)


_LEAVES = ([f for f in EngineState._fields if f not in ("t", "aux")]
           + [f"aux.{f}" for f in AuxState._fields])


def _get(state: EngineState, name: str) -> torch.Tensor:
    if name.startswith("aux."):
        return getattr(state.aux, name[4:])
    return getattr(state, name)


def _with(state: EngineState, names, values) -> EngineState:
    new = dict(zip(names, values))
    aux = {f[4:]: v for f, v in new.items() if f.startswith("aux.")}
    top = {f: v for f, v in new.items() if not f.startswith("aux.")}
    return state._replace(aux=state.aux._replace(**aux), **top)


def _collect(state: EngineState, slabs: ServerSlabs, split: bool
             ) -> EngineState:
    """The full state from this rank's: the fields :func:`.shard.state_specs`
    splits over the servers axis gathered over it, then (``split``) every
    field over the sweep axis."""
    specs = state_specs(state, slabs.spec,
                        (AXIS_SWEEP,) if split else (None,))
    for axis, gather in ((AXIS_SERVERS, slabs.gather),
                         (AXIS_SWEEP, slabs.gather_lanes)):
        names = [n for n in _LEAVES
                 if axis in getattr(specs, n.split(".")[0])]
        if names:
            state = _with(state, names,
                          gather([_get(state, n) for n in names]))
    return state


def _from_rank0(state: EngineState, everything: bool) -> EngineState:
    """Rank 0's replicated fields on every rank of the world (on the card a
    rank's float throughput bins follow its own atomic adds), and with
    ``everything`` every field (for ranks outside the mesh)."""
    names = [n for n in _LEAVES
             if everything or n.split(".")[0] not in SLAB_FIELDS]
    return _with(state, names,
                 broadcast([_get(state, n) for n in names], src=0))


def run(cfg: EngineConfig, wl: Workload, table: JobTable, sim_seconds: float):
    """Run the simulation on ``cfg.device``; returns the reference's dict:
    ``state`` (final :class:`EngineState`), ``gbps[J, NB]``, ``bin_s``,
    ``issued``, ``completed``, ``dropped``, ``idle_worker_ticks``, ``ticks``.

    With ``cfg.mesh_shape``/``shard_servers`` set, every rank of the world
    calls this and gets the full result (see :mod:`.shard`); a sweep axis
    is idle here (one run has one lane).
    """
    device = _check_device(cfg, wl, table)
    ticks, n_bins = _ticks_bins(cfg, sim_seconds)
    params = get_scheduler(cfg.scheduler).params(cfg)
    state = _simulate(cfg, wl, table, ticks, n_bins, device, [params],
                      [cfg.seed], lambda points, seeds: points[0])
    state = map_state(state, lambda x: x[0])
    bin_s = cfg.bin_ticks * cfg.dt
    return {
        "state": state,
        "gbps": state.bytes_bin.cpu().numpy() / bin_s / 1e9,
        "bin_s": bin_s,
        "issued": state.issued.cpu().numpy(),
        "completed": state.completed.cpu().numpy(),
        "dropped": int(state.dropped),
        "idle_worker_ticks": int(state.idle_worker_ticks),
        "ticks": ticks,
    }


def run_batch(cfg: EngineConfig, wl: Workload, table: JobTable,
              sim_seconds: float, *, seeds: Sequence[int],
              params_points: Optional[Sequence[SchedulerParams]] = None):
    """Run the simulation over PRNG ``seeds`` — and optionally a params grid
    — as lanes of one tick loop.

    Every seed (and grid point) shares the workload, table and geometry;
    only the PRNG stream and the scheduler's numeric knobs differ.  Each
    lane equals a sequential :func:`run` with ``cfg.seed = s`` (and
    ``cfg.scheduler_params = p``): on the CPU bit for bit, on the card with
    integer counters equal and the float throughput bins within the order
    of ``index_add_``'s atomic adds.  Without ``params_points`` every array
    leads with ``K = len(seeds)``; with them (concrete params of
    ``cfg.scheduler``, one schema, one ``mu_ticks``) with ``[P, K]``.

    Sharded (:mod:`.shard`): a ``servers`` mesh axis slabs the servers as
    in :func:`run`; a ``sweep`` axis splits the leading grid axis (the
    ``params_points`` when given, else the seeds), which must divide
    evenly.  Every rank of the world returns the full result.
    """
    device = _check_device(cfg, wl, table)
    seeds = [prng.normalize_seed(s) for s in seeds]
    if not seeds:
        raise ValueError("run_batch needs at least one seed")
    sched = get_scheduler(cfg.scheduler)
    if params_points is None:
        points, lead = [sched.params(cfg)], (len(seeds),)
    else:
        points = list(params_points)
        for p in points:
            if type(p) is not sched.params_cls:
                raise TypeError(
                    f"params_points entries must be {sched.params_cls.__name__} "
                    f"for scheduler {cfg.scheduler!r}, got {type(p).__name__}")
        lead = (len(points), len(seeds))
    ticks, n_bins = _ticks_bins(cfg, sim_seconds)
    state = _simulate(
        cfg, wl, table, ticks, n_bins, device, points, seeds,
        lambda points, seeds: lane_params(points, len(seeds), device),
        grid="seeds" if params_points is None else "points")
    state = map_state(state, lambda x: x.reshape(lead + x.shape[1:]))
    bin_s = cfg.bin_ticks * cfg.dt
    host = lambda x: x.cpu().numpy()
    return {
        "state": state,
        "seeds": np.asarray(seeds, dtype=np.uint32),
        "gbps": host(state.bytes_bin) / bin_s / 1e9,         # [(P,) K, J, NB]
        "bin_s": bin_s,
        "issued": host(state.issued),                        # [(P,) K, J]
        "completed": host(state.completed),                  # [(P,) K, J]
        "dropped": host(state.dropped),                      # [(P,) K]
        "idle_worker_ticks": host(state.idle_worker_ticks),  # [(P,) K]
        "ticks": ticks,
    }

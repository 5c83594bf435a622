"""Discrete-event burst-buffer engine (paper §5 testbed), in PyTorch.

The port of ``repro.core.engine`` for one device: ``S`` servers, each with
``W`` workers sharing the server's bandwidth, serving phased client
populations held in fixed-shape tensors.  The reference's ``lax.scan`` over
ticks is a Python loop here; ``t`` is a Python int in that loop, so the
cadences that depend on it (the ring slot, the throughput bin, the λ-sync
every ``sync_ticks``) are decided on the host, and nothing inside the loop
reads a value back from the card.

Each tick: (1) arrivals from the time wheel and phase starts go into the
per-(server, job) rings, (2) the scheduler builds the ``[S, J]`` share
table, (3) the W workers draw and pop — on the fused path
(``tick_impl="fused"``, the default) in one ``tick_step`` kernel launch, on
the scan path (``tick_impl="scan"``) one worker at a time, the themis draw
through the ``token_select`` kernel — and (4) every ``sync_ticks`` the
λ-sync rebalances the segments.  The PRNG stream is the reference's
(:mod:`.prng`), so from the same state both engines draw the same numbers.

The tick updates the state's time wheel and arrival rings in place (they
are the two large tensors); every other leaf is replaced.

Not ported yet, and refused with ``NotImplementedError``: the schedulers
gift/tbf/adaptbf/plan, Poisson arrival phases, fleet sharding
(``shard_servers``/``mesh_shape``) and ``run_batch``.
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
from .params import SchedulerParams
from .policy import Policy, PolicyChain
from .scheduler import TickView, get_scheduler
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
        if self.shard_servers != 1 or self.mesh_shape is not None:
            raise NotImplementedError(
                "fleet sharding (shard_servers / mesh_shape) is not ported to "
                "repro_torch yet")
        get_scheduler(self.scheduler)

    @property
    def worker_bw(self) -> float:
        """Per-worker bandwidth (bytes/s), derated by the fabric exponent."""
        eff = float(self.n_servers) ** (-self.fabric_exponent)
        return self.server_bw / self.n_workers * eff


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


def make_workload(cfg: EngineConfig, jobs: Sequence[dict]
                  ) -> tuple[Workload, JobTable]:
    """Lower job spec dicts (see ``scenario.lowering``) into a workload and
    a job table on ``cfg.device``."""
    device = _device.resolve_device(cfg.device)
    low = lower_for_config(jobs, cfg)
    wl = Workload(*(torch.as_tensor(getattr(low, f), device=device)
                    for f in Workload._fields))
    return wl, make_table(low.jobs, max_jobs=cfg.max_jobs, device=device)


def init_state(cfg: EngineConfig, n_bins: int, device=None) -> EngineState:
    device = _device.resolve_device(cfg.device if device is None else device)
    s_, j_, w_ = cfg.n_servers, cfg.max_jobs, cfg.n_workers
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return EngineState(
        t=0, key=prng.PRNGKey(cfg.seed, device),
        qcount=z((s_, j_), torch.int32), head=z((s_, j_), torch.int32),
        arr_time=z((s_, j_, cfg.ring_cap), torch.float32),
        wheel=z((s_, j_, cfg.wheel), torch.int32),
        free_at=z((s_, w_), torch.float32), known=z((s_, j_), torch.bool),
        seg=z((s_, j_), torch.float32), synced=z((j_,), torch.bool),
        aux=get_scheduler(cfg.scheduler).init_aux(s_, j_, device),
        bytes_bin=z((j_, n_bins), torch.float32),
        issued=z((j_,), torch.int32), completed=z((j_,), torch.int32),
        idle_worker_ticks=z((), torch.int32), dropped=z((), torch.int32))


def _push_arrivals(state: EngineState, arrivals: torch.Tensor,
                   t_sec: float) -> EngineState:
    """Append ``arrivals[s, j]`` identically-stamped requests to each ring
    (in place); arrivals beyond a ring's free space are rejected and
    counted in ``dropped``."""
    cap = state.arr_time.shape[-1]
    space = torch.clamp_min(cap - state.qcount, 0)
    accepted = torch.minimum(arrivals, space)
    idx = torch.arange(cap, dtype=torch.int32, device=arrivals.device)
    tail = (state.head + state.qcount)[..., None]
    pos = (idx - tail) % cap
    state.arr_time.masked_fill_(pos < accepted[..., None], t_sec)
    return state._replace(
        qcount=state.qcount + accepted,
        known=state.known | (accepted > 0),
        issued=state.issued + accepted.sum(dim=0).to(torch.int32),
        dropped=state.dropped + (arrivals - accepted).sum().to(torch.int32))


def make_tick(cfg: EngineConfig, wl: Workload, table: JobTable, n_bins: int):
    """Build the per-tick transition ``tick(p, state) -> state``."""
    s_, j_, w_ = cfg.n_servers, cfg.max_jobs, cfg.n_workers
    cap, h_ = cfg.ring_cap, cfg.wheel
    device = wl.procs.device
    sched = get_scheduler(cfg.scheduler)
    mode_np = wl.arrival_mode.cpu().numpy()
    if (mode_np == ARRIVAL_POISSON).any():
        raise NotImplementedError(
            "Poisson arrival phases are not ported to repro_torch yet")
    has_interval = bool((mode_np == ARRIVAL_INTERVAL).any())
    chain = None
    if sched.uses_segments:
        if cfg.policy is None:
            raise ValueError(f"scheduler {cfg.scheduler!r} needs a policy")
        chain = PolicyChain.from_table(cfg.policy, table)
    srv_idx = torch.arange(s_, device=device)
    srv_sw = srv_idx[:, None].expand(s_, w_)
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
    contig = np.zeros_like(real_np)
    contig[:, 1:] = (real_np[:, 1:] & real_np[:, :-1]
                     & (start_np[:, 1:] == wl.phase_end.cpu().numpy()[:, :-1])
                     & (mode_np[:, 1:] == ARRIVAL_CLOSED)
                     & (mode_np[:, :-1] == ARRIVAL_CLOSED))
    fresh_start = torch.as_tensor(~contig, device=device)
    closed_start = phase_real & fresh_start & (wl.arrival_mode == ARRIVAL_CLOSED)
    every = torch.clamp_min(wl.arrival_every, 1)

    def tick(p, state: EngineState) -> EngineState:
        ctrl = sched.ctrl_overhead_s(p)
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

        # -- 1. arrivals: time-wheel slot + phase starts + interval bursts --
        slot = t % h_
        inject = ((wl.phase_start == t) & closed_start).any(dim=1)
        if has_interval:
            gap = (t - wl.phase_start) % every
            inject = inject | (phase_live & (gap == 0)
                               & (wl.arrival_mode == ARRIVAL_INTERVAL)
                               ).any(dim=1)
        arrivals = state.wheel[:, :, slot] + torch.where(
            inject[None, :], wl.procs, 0)
        state.wheel[:, :, slot] = 0
        state = _push_arrivals(state, arrivals, t_sec)

        # -- 2. scheduler bookkeeping -----------------------------------------
        aux = sched.pre_tick(cfg, p, state.aux, state.qcount, t)
        shares = sched.tick_shares(cfg, chain, TickView(
            qcount=state.qcount, known=state.known, seg=state.seg,
            synced=state.synced, live=live))

        # -- 3. workers -------------------------------------------------------
        keys = prng.split(state.key)
        key, sub = keys[0], keys[1]
        wheel = state.wheel
        bytes_job = torch.zeros((j_,), dtype=torch.float32, device=device)

        def service_of(j_safe):
            rb = req_now[j_safe]
            return rb, rb / wbw_t + wl.overhead_s[j_safe] + ctrl

        def rearm_slot(new_free, j_safe):
            """Wheel slot of the closed-loop re-arrival after completion +
            think time."""
            off = torch.clamp(
                torch.ceil((new_free - t_sec) / dt_t).to(torch.int32)
                + think_now[j_safe], 1, h_ - 1)
            return ((t + off) % h_).to(torch.int64)

        if cfg.tick_impl == "fused":
            free = state.free_at < t_next                           # [S, W]
            u_all = prng.uniform(prng.fold_in(sub, worker_ids),
                                 (s_,)).t().contiguous()            # [S, W]
            ring_idx = ((state.head[..., None] + worker_ids) % cap).to(torch.int64)
            window = state.arr_time.gather(2, ring_idx).contiguous()
            sel, valid, demand_any, qcount, pops_sj = tick_step(
                shares.contiguous(), state.qcount, window, free, u_all,
                mode=sched.kernel_select_mode)
            head = (state.head + pops_sj) % cap
            j_safe = torch.clamp_min(sel, 0).to(torch.int64)        # [S, W]
            rb, service = service_of(j_safe)
            start_t = torch.clamp_min(state.free_at, t_sec)
            free_at = torch.where(valid, start_t + service, state.free_at)
            slot2 = rearm_slot(free_at, j_safe)
            wheel.index_put_((srv_sw, j_safe, slot2),
                             (valid & recycle[j_safe]).to(torch.int32),
                             accumulate=True)
            add_b = torch.where(valid, rb, 0.0)
            # Per-worker order, as the scan adds (float sums follow it on
            # the CPU; on the card index_add_ is atomic).
            for w in range(w_):
                bytes_job.index_add_(0, j_safe[:, w], add_b[:, w])
            pops_job = torch.zeros((j_,), dtype=torch.int32, device=device)
            pops_job.index_add_(0, j_safe.reshape(-1),
                                valid.reshape(-1).to(torch.int32))
            idle = (free & ~valid & demand_any).sum()
        else:
            qcount, head = state.qcount, state.head
            free_at = state.free_at.clone()
            pops_job = torch.zeros((j_,), dtype=torch.int32, device=device)
            idle = torch.zeros((), dtype=torch.int64, device=device)
            for w in range(w_):
                kw = prng.fold_in(sub, worker_ids[w])
                free = free_at[:, w] < t_next
                demand = qcount > 0
                head_time = torch.where(
                    demand,
                    state.arr_time.gather(
                        2, (head % cap).to(torch.int64)[..., None])[..., 0],
                    torch.inf)
                j_sel = sched.select(cfg, p, shares, head_time, demand, aux,
                                     req_now, kw)
                valid = free & (j_sel >= 0)
                j_safe = torch.clamp_min(j_sel, 0).to(torch.int64)
                step = valid.to(torch.int32)
                qcount = qcount.index_put((srv_idx, j_safe), -step,
                                          accumulate=True)
                head = head.index_put((srv_idx, j_safe), step,
                                      accumulate=True) % cap
                rb, service = service_of(j_safe)
                start_t = torch.clamp_min(free_at[:, w], t_sec)
                new_free = torch.where(valid, start_t + service, free_at[:, w])
                free_at[:, w] = new_free
                slot2 = rearm_slot(new_free, j_safe)
                wheel.index_put_((srv_idx, j_safe, slot2),
                                 (valid & recycle[j_safe]).to(torch.int32),
                                 accumulate=True)
                add_b = torch.where(valid, rb, 0.0)
                bytes_job.index_add_(0, j_safe, add_b)
                pops_job.index_add_(0, j_safe, step)
                aux = sched.charge(cfg, p, aux, srv_idx, j_safe, add_b)
                idle = idle + (free & ~valid & demand.any(dim=1)).sum()

        # -- fold the phase into the state, then the λ-sync -----------------
        b = min(t // cfg.bin_ticks, n_bins - 1)
        state.bytes_bin[:, b] += bytes_job
        state = state._replace(
            t=t + 1, key=key, qcount=qcount, head=head, wheel=wheel,
            free_at=free_at, aux=aux, completed=state.completed + pops_job,
            idle_worker_ticks=state.idle_worker_ticks + idle.to(torch.int32))
        if sched.uses_segments and cfg.sync_ticks > 0 \
                and state.t % cfg.sync_ticks == 0:
            support = state.known & live[None, :]
            state = state._replace(
                seg=sync_segments(chain, support, n_iters=cfg.sinkhorn_iters),
                synced=support.any(dim=0))
        return state

    return tick


def run(cfg: EngineConfig, wl: Workload, table: JobTable, sim_seconds: float):
    """Run the simulation on ``cfg.device``; returns the reference's dict:
    ``state`` (final :class:`EngineState`), ``gbps[J, NB]``, ``bin_s``,
    ``issued``, ``completed``, ``dropped``, ``idle_worker_ticks``, ``ticks``.
    """
    device = _device.resolve_device(cfg.device)
    if wl.procs.device != device or table.active.device != device:
        raise ValueError(f"workload/table live on {wl.procs.device}, the "
                         f"config asks for {device}")
    ticks = int(round(sim_seconds / cfg.dt))
    n_bins = max(1, (ticks + cfg.bin_ticks - 1) // cfg.bin_ticks)
    tick = make_tick(cfg, wl, table, n_bins)
    state = init_state(cfg, n_bins, device)
    params = get_scheduler(cfg.scheduler).params(cfg)
    for _ in range(ticks):
        state = tick(params, state)
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


def run_batch(*args, **kwargs):
    raise NotImplementedError(
        "run_batch (seeds x params sweeps in one call) is not ported to "
        "repro_torch yet; loop over run() with cfg.seed set")

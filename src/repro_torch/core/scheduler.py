"""Scheduler registry for the port: the reference's six schedulers.

The hooks, names and flags follow the reference ``repro.core.scheduler``.
Four differences:

* ``tick_shares`` takes a :class:`~repro_torch.core.policy.PolicyChain`
  (the policy compiled against the job table once) where the reference
  takes the policy and the table;
* ``select`` takes the worker's uniforms where the reference takes its key:
  :meth:`Scheduler.draws` draws every worker's uniforms of a tick in one
  batch from the same keys (``fold_in(sub, w)``), so the bits are the
  reference's and the tick makes one threefry evaluation, not ``W``;
* the μ cadence of the interval schedulers is decided on the host from the
  Python tick ``t`` (the reference's ``lax.cond``), so no tick reads the
  card;
* ``charge`` takes the popped job of every server row, ``j_sel[..., S]``,
  where the reference takes ``(arange(S), j_sel)``.

Every hook takes the engine's lane axis in front of ``[S, J]``, and the
numeric knobs of ``p`` are float32 tensors ``[L, 1, 1]`` there
(:func:`~repro_torch.core.params.lane_params`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Type

import torch

from . import baselines, params as params_, prng
from .baselines import AuxState
from .global_sync import local_segments
from .policy import PolicyChain
from .tokens import select_job, shares_have_mass


class TickView(NamedTuple):
    """Snapshot of the queue/segment state feeding a tick."""

    qcount: torch.Tensor   # i32[..., S, J]  queued requests per (server, job)
    known: torch.Tensor    # bool[..., S, J] job has ever issued I/O on the server
    seg: torch.Tensor      # f32[..., S, J]  λ-synced segment table
    synced: torch.Tensor   # bool[..., J]    job was included in the last λ-sync
    live: torch.Tensor     # bool[J]         job is inside its arrival window


class Scheduler:
    """Base scheduler: idles on select, carries no aux state of its own."""

    name: str = ""
    uses_segments: bool = False   # participates in the λ-sync segment exchange
    has_intervals: bool = False   # needs μ-interval budget updates to progress
    #: The worker phase lowers to the fused ``tick_step`` kernel: the select
    #: is one of the kernel's modes and ``charge`` is the base no-op.
    kernel_tick: bool = False
    #: Which select mode of the tick_step kernel runs this scheduler.
    kernel_select_mode: str = "themis"
    #: ``interval_update`` moves state between server rows.
    cross_shard: bool = False
    params_cls: Type[params_.SchedulerParams] = params_.SchedulerParams

    # -- parameters ----------------------------------------------------------
    def params(self, cfg) -> params_.SchedulerParams:
        return self.params_cls.resolve(cfg)

    def mu_ticks(self, p) -> int:
        return getattr(p, "mu_ticks", params_.DEFAULT_MU_TICKS)

    def mu_s(self, p, dt: float) -> float:
        return self.mu_ticks(p) * dt

    # -- state ---------------------------------------------------------------
    def init_aux(self, n_servers: int, max_jobs: int, device="cpu",
                 lanes=()) -> AuxState:
        return baselines.init_aux(n_servers, max_jobs, device, lanes)

    def ctrl_overhead_s(self, p):
        return getattr(p, "ctrl_overhead_s", 0.0)

    # -- per-tick bookkeeping ------------------------------------------------
    def refill(self, cfg, p, aux: AuxState, dt_s) -> AuxState:
        return aux

    def interval_update(self, cfg, p, aux: AuxState, qcount) -> AuxState:
        return aux

    def pre_tick(self, cfg, p, aux: AuxState, qcount, t: int) -> AuxState:
        return aux

    # -- selection -----------------------------------------------------------
    def tick_shares(self, cfg, chain: Optional[PolicyChain],
                    view: TickView) -> torch.Tensor:
        return torch.zeros_like(view.seg)

    def draws(self, keys: torch.Tensor, n_servers: int):
        """Every worker's randomness of one tick from its keys
        ``[W, ..., 2]`` (``fold_in(sub, w)``); ``select`` gets entry
        ``[w]``.  None for a scheduler that draws nothing."""
        return None

    def select(self, cfg, p, shares, head_time, demand, aux: AuxState,
               req_bytes, rand) -> torch.Tensor:
        raise NotImplementedError

    def charge(self, cfg, p, aux: AuxState, j_sel, add_bytes) -> AuxState:
        """Debit the accounts for a pop of ``add_bytes[..., s]`` of job
        ``j_sel[..., s]`` on every server row ``s``."""
        return aux


class _UniformDraw:
    """Schedulers whose select draws ``uniform(key, (S,))``."""

    def draws(self, keys, n_servers):
        return prng.uniform(keys, (n_servers,))


class _IntervalScheduler(Scheduler):
    """Shared cadence of the μ-interval schedulers (GIFT, TBF, AdapTBF,
    plan): accrue one tick, then a μ update on the boundary."""

    has_intervals = True
    params_cls = params_._IntervalParams

    def pre_tick(self, cfg, p, aux: AuxState, qcount, t: int) -> AuxState:
        aux = self.refill(cfg, p, aux, cfg.dt)
        if t % self.mu_ticks(p) == 0:
            aux = self.interval_update(cfg, p, aux, qcount)
        return aux


_REGISTRY: Dict[str, Scheduler] = {}


def register(name: str) -> Callable[[Type[Scheduler]], Type[Scheduler]]:
    """Class decorator: instantiate and expose the scheduler under ``name``."""
    def deco(cls: Type[Scheduler]) -> Type[Scheduler]:
        cls.name = name
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_scheduler(name: str) -> Scheduler:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_schedulers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register("themis")
class ThemisScheduler(_UniformDraw, Scheduler):
    """Statistical tokens (paper §3): per-tick local policy chain + λ-synced
    Sinkhorn-balanced global segments, opportunity renormalisation,
    per-worker uniform draws through the ``token_select`` kernel."""

    uses_segments = True
    kernel_tick = True
    kernel_select_mode = "themis"
    params_cls = params_.ThemisParams

    def tick_shares(self, cfg, chain: PolicyChain, view: TickView) -> torch.Tensor:
        demand = view.qcount > 0
        local = local_segments(chain, view.known & view.live & demand)
        base = torch.where(view.synced[..., None, :], view.seg, local)
        has_mass = shares_have_mass(base, demand)[..., None]
        return torch.where(has_mass, base, local)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return select_job(shares, demand, rand)


@register("fifo")
class FifoScheduler(Scheduler):
    """Arrival-order across jobs (production default, paper §1)."""

    kernel_tick = True
    kernel_select_mode = "fifo"
    params_cls = params_.FifoParams

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return baselines.fifo_select(head_time, demand)


@register("gift")
class GiftScheduler(_UniformDraw, _IntervalScheduler):
    """BSIP equal-share with μ-interval budgets + throttle-and-reward
    coupons (paper §5.4)."""

    params_cls = params_.GiftParams

    def interval_update(self, cfg, p, aux, qcount):
        return baselines.gift_interval(
            aux, qcount, self.mu_s(p, cfg.dt), cfg.server_bw, p.coupon_frac)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return baselines.gift_select(aux, demand, rand)

    def charge(self, cfg, p, aux, j_sel, add_bytes):
        return baselines.gift_charge(aux, j_sel, add_bytes)


@register("tbf")
class TbfScheduler(_IntervalScheduler):
    """Per-job token bucket with HTC hard compensation and PSSB spare
    sharing (paper §5.4)."""

    params_cls = params_.TbfParams

    def draws(self, keys, n_servers):
        return torch.stack([prng.uniform(keys, (n_servers,)),
                            prng.uniform(prng.fold_in(keys, 1), (n_servers,))],
                           dim=1)

    def refill(self, cfg, p, aux, dt_s):
        rate = p.rate_eff(cfg)
        return baselines.tbf_refill(aux, rate, dt_s, rate * p.burst_s)

    def interval_update(self, cfg, p, aux, qcount):
        return baselines.tbf_interval(
            aux, self.mu_s(p, cfg.dt), cfg.server_bw, p.rate_eff(cfg),
            p.headroom)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return baselines.tbf_select(aux, demand, req_bytes, rand[0], rand[1])

    def charge(self, cfg, p, aux, j_sel, add_bytes):
        return baselines.tbf_charge(aux, j_sel, add_bytes)


@register("adaptbf")
class AdaptbfScheduler(_UniformDraw, _IntervalScheduler):
    """AdapTBF: token buckets that borrow unused tokens from peers each μ
    (waterfilling match, repayment decay), optionally pooled across
    servers (``donate > 0``)."""

    params_cls = params_.AdaptbfParams
    cross_shard = True

    def refill(self, cfg, p, aux, dt_s):
        rate = p.rate_eff(cfg)
        return baselines.adaptbf_refill(aux, rate, dt_s, rate * p.burst_s)

    def interval_update(self, cfg, p, aux, qcount):
        aux = baselines.adaptbf_interval(
            aux, qcount, self.mu_s(p, cfg.dt), cfg.server_bw, p.repay)
        return baselines.adaptbf_cross_donate(
            aux, qcount, self.mu_s(p, cfg.dt), cfg.server_bw, p.donate)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return baselines.adaptbf_select(aux, demand, req_bytes, rand)

    def charge(self, cfg, p, aux, j_sel, add_bytes):
        return baselines.adaptbf_charge(aux, j_sel, add_bytes)


@register("plan")
class PlanScheduler(_IntervalScheduler):
    """Plan-based lookahead: every μ an EFT-style plan from a qcount EMA,
    served smallest estimated remaining demand first, FIFO when the plan
    has no eligible entry."""

    params_cls = params_.PlanParams

    def interval_update(self, cfg, p, aux, qcount):
        return baselines.plan_interval(aux, qcount, p.ema_alpha)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, rand):
        return baselines.plan_select(aux, head_time, demand)

    def charge(self, cfg, p, aux, j_sel, add_bytes):
        return baselines.plan_charge(aux, j_sel, add_bytes)

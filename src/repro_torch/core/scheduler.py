"""Scheduler registry for the port: ``themis`` and ``fifo``.

The hooks and names follow the reference ``repro.core.scheduler``.  One
difference: ``tick_shares`` takes a :class:`~repro_torch.core.policy.PolicyChain`
(the policy compiled against the job table once) where the reference takes
the policy and the table.  The other registered schedulers of the reference
(gift, tbf, adaptbf, plan) are not ported yet; asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Type

import torch

from . import baselines, params as params_, prng
from .baselines import AuxState
from .global_sync import local_segments
from .policy import PolicyChain
from .tokens import select_job, shares_have_mass

#: Schedulers of the reference that this port does not carry yet.
NOT_PORTED = ("gift", "tbf", "adaptbf", "plan")


class TickView(NamedTuple):
    """Snapshot of the queue/segment state feeding a tick."""

    qcount: torch.Tensor   # i32[S, J]  queued requests per (server, job)
    known: torch.Tensor    # bool[S, J] job has ever issued I/O on the server
    seg: torch.Tensor      # f32[S, J]  λ-synced segment table
    synced: torch.Tensor   # bool[J]    job was included in the last λ-sync
    live: torch.Tensor     # bool[J]    job is inside its arrival window


class Scheduler:
    """Base scheduler: idles on select, carries no aux state of its own."""

    name: str = ""
    uses_segments: bool = False
    #: Which select mode of the tick_step kernel runs this scheduler's
    #: worker phase on the fused path.
    kernel_select_mode: str = "themis"
    params_cls: Type[params_.SchedulerParams] = params_.SchedulerParams

    def params(self, cfg) -> params_.SchedulerParams:
        return self.params_cls.resolve(cfg)

    def init_aux(self, n_servers: int, max_jobs: int, device="cpu") -> AuxState:
        return baselines.init_aux(n_servers, max_jobs, device)

    def ctrl_overhead_s(self, p):
        return getattr(p, "ctrl_overhead_s", 0.0)

    def pre_tick(self, cfg, p, aux: AuxState, qcount, t) -> AuxState:
        return aux

    def tick_shares(self, cfg, chain: PolicyChain, view: TickView) -> torch.Tensor:
        return torch.zeros_like(view.seg)

    def select(self, cfg, p, shares, head_time, demand, aux: AuxState,
               req_bytes, key) -> torch.Tensor:
        raise NotImplementedError

    def charge(self, cfg, p, aux: AuxState, srv_idx, j_sel,
               add_bytes) -> AuxState:
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
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"scheduler {name!r} is not ported to repro_torch yet; "
                f"ported: {sorted(_REGISTRY)}") from None
        raise ValueError(
            f"unknown scheduler {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


@register("themis")
class ThemisScheduler(Scheduler):
    """Statistical tokens (paper §3): per-tick local policy chain + λ-synced
    Sinkhorn-balanced global segments, opportunity renormalisation,
    per-worker uniform draws."""

    uses_segments = True
    kernel_select_mode = "themis"
    params_cls = params_.ThemisParams

    def tick_shares(self, cfg, chain: PolicyChain, view: TickView) -> torch.Tensor:
        demand = view.qcount > 0
        local = local_segments(chain, view.known & view.live[None, :] & demand)
        base = torch.where(view.synced[None, :], view.seg, local)
        has_mass = shares_have_mass(base, demand)[:, None]
        return torch.where(has_mass, base, local)

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, key):
        u = prng.uniform(key, (shares.shape[0],))
        return select_job(shares, demand, u)


@register("fifo")
class FifoScheduler(Scheduler):
    """Arrival-order across jobs (production default, paper §1)."""

    kernel_select_mode = "fifo"
    params_cls = params_.FifoParams

    def select(self, cfg, p, shares, head_time, demand, aux, req_bytes, key):
        return baselines.fifo_select(head_time, demand)

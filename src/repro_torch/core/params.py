"""Scheduler-owned parameter schemas, as plain frozen dataclasses.

The class names, fields, defaults and range checks are the reference's
(``repro.core.params``), so ``params_hash`` stamps the same hash for the
same schema and values.  A field holds a Python number when a caller builds
a schema, or a float32 tensor when the engine threads the numeric knobs
through its lanes (:func:`stack_params`, :func:`lane_params`); validation
runs only on Python numbers, as the reference skips traced values.
Structural fields (``mu_ticks``) stay Python ints: they set the engine's
cadence on the host, so one batched run holds one value of each.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import FrozenSet, List, Sequence

import torch

#: μ cadence every interval scheduler shares by default (ticks).
DEFAULT_MU_TICKS = 500

#: Structural fields: the same for every lane of a batched run.
STATIC_FIELDS: FrozenSet[str] = frozenset({"mu_ticks", "sa_steps",
                                           "sa_restarts"})


def _require(cond, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _abstract_values(p) -> bool:
    """True when a field holds a tensor (stacked grid points or lanes)."""
    return any(torch.is_tensor(getattr(p, f.name))
               for f in dataclasses.fields(p))


@dataclasses.dataclass(frozen=True)
class SchedulerParams:
    """Base schema: no knobs."""

    def __post_init__(self):
        if not _abstract_values(self):
            self._validate()

    def _validate(self) -> None:
        """Eager range checks on concrete values; subclasses extend."""

    @classmethod
    def numeric_fields(cls) -> List[str]:
        """Field names that may differ between the lanes of one run."""
        return [f.name for f in dataclasses.fields(cls)
                if f.name not in STATIC_FIELDS]

    @classmethod
    def resolve(cls, cfg) -> "SchedulerParams":
        """Explicit ``cfg.scheduler_params`` wins; else the schema defaults.
        The type check is exact, as in the reference."""
        p = getattr(cfg, "scheduler_params", None)
        if p is None:
            return cls()
        if type(p) is not cls:
            raise TypeError(
                f"scheduler_params is {type(p).__name__}, but the configured "
                f"scheduler expects exactly {cls.__name__}")
        return p

    def params_hash(self) -> str:
        """Stable short hash of (schema type, every field value)."""
        doc = {"schema": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            doc[f.name] = v.item() if hasattr(v, "item") else v
        blob = json.dumps(doc, sort_keys=True, default=repr).encode()
        return hashlib.sha256(blob).hexdigest()[:12]


def _check_grid(points: Sequence[SchedulerParams]) -> list:
    points = list(points)
    if not points:
        raise ValueError("stack_params needs at least one grid point")
    p0 = points[0]
    for i, p in enumerate(points):
        if type(p) is not type(p0):
            raise TypeError(
                f"grid point {i} is {type(p).__name__}, expected "
                f"{type(p0).__name__} — a sweep grid holds one schema")
        for name in STATIC_FIELDS:
            if hasattr(p0, name) and getattr(p, name) != getattr(p0, name):
                raise ValueError(
                    f"grid point {i} has {name}={getattr(p, name)} != "
                    f"{getattr(p0, name)}: structural fields are the same "
                    "for every lane of one run; sweep them as separate runs")
    return points


def stack_params(points: Sequence[SchedulerParams], device="cpu"
                 ) -> SchedulerParams:
    """Stack P grid points of one schema: every numeric field becomes a
    float32 tensor ``[P]``; structural fields must agree (they are kept)."""
    points = _check_grid(points)
    p0 = points[0]
    stacked = {n: torch.tensor([float(getattr(p, n)) for p in points],
                               dtype=torch.float32, device=device)
               for n in p0.numeric_fields()}
    return dataclasses.replace(p0, **stacked)


def lane_params(points: Sequence[SchedulerParams], repeat: int, device
                ) -> SchedulerParams:
    """The engine's per-lane view of P grid points, each repeated over
    ``repeat`` seeds (point-major): numeric fields as float32 tensors
    ``[P * repeat, 1, 1]`` that broadcast against ``[L, S, J]`` state."""
    stacked = stack_params(points, device)
    lanes = {n: getattr(stacked, n).repeat_interleave(repeat)[:, None, None]
             for n in stacked.numeric_fields()}
    return dataclasses.replace(stacked, **lanes)


@dataclasses.dataclass(frozen=True)
class ThemisParams(SchedulerParams):
    """Statistical tokens have no per-scheduler tunables."""


@dataclasses.dataclass(frozen=True)
class FifoParams(SchedulerParams):
    """Arrival order needs no knobs."""


@dataclasses.dataclass(frozen=True)
class _IntervalParams(SchedulerParams):
    """Shared μ cadence for every interval scheduler (structural)."""

    mu_ticks: int = DEFAULT_MU_TICKS

    def _validate(self):
        super()._validate()
        _require(self.mu_ticks > 0, f"mu_ticks must be > 0, got {self.mu_ticks}")


@dataclasses.dataclass(frozen=True)
class GiftParams(_IntervalParams):
    """GIFT (FAST'20): BSIP equal-share interval budgets + throttle-and-reward
    coupons; ``ctrl_overhead_s`` is the per-request control-path cost."""

    coupon_frac: float = 0.5
    ctrl_overhead_s: float = 5e-4

    def _validate(self):
        super()._validate()
        _require((0.0 <= self.coupon_frac) & (self.coupon_frac <= 1.0),
                 f"coupon_frac must be in [0, 1], got {self.coupon_frac}")
        _require(self.ctrl_overhead_s >= 0.0,
                 f"ctrl_overhead_s must be >= 0, got {self.ctrl_overhead_s}")


@dataclasses.dataclass(frozen=True)
class _BucketParams(_IntervalParams):
    """Shared token-bucket base of TBF and AdapTBF (the per-job ``rate``)."""

    rate: float = 0.0
    burst_s: float = 0.25
    ctrl_overhead_s: float = 5.5e-4

    def _validate(self):
        super()._validate()
        _require(self.rate >= 0.0, f"rate must be >= 0, got {self.rate}")
        _require(self.burst_s >= 0.0,
                 f"burst_s must be >= 0, got {self.burst_s}")
        _require(self.ctrl_overhead_s >= 0.0,
                 f"ctrl_overhead_s must be >= 0, got {self.ctrl_overhead_s}")

    def rate_eff(self, cfg):
        """Effective per-job rate (float32): configured, or an equal split
        of server bandwidth over job slots when left at 0."""
        rate = torch.as_tensor(self.rate, dtype=torch.float32)
        return torch.where(rate > 0, rate, cfg.server_bw / cfg.max_jobs)


@dataclasses.dataclass(frozen=True)
class TbfParams(_BucketParams):
    """TBF (SC'17): classful token buckets, HTC hard accounting and PSSB
    conservative spare sharing with a ``headroom`` factor."""

    headroom: float = 0.8

    def _validate(self):
        super()._validate()
        _require((0.0 <= self.headroom) & (self.headroom <= 1.0),
                 f"headroom must be in [0, 1], got {self.headroom}")


@dataclasses.dataclass(frozen=True)
class AdaptbfParams(_BucketParams):
    """AdapTBF (arXiv:2602.22409): TBF's buckets plus a per-μ borrow
    exchange; ``repay`` decays the borrowed ledger, ``donate`` pools a
    fraction of the remaining surplus across servers."""

    burst_s: float = 2.0
    ctrl_overhead_s: float = 1e-4
    repay: float = 0.1
    donate: float = 0.0

    def _validate(self):
        super()._validate()
        _require((0.0 <= self.repay) & (self.repay <= 1.0),
                 f"repay must be in [0, 1], got {self.repay}")
        _require((0.0 <= self.donate) & (self.donate <= 1.0),
                 f"donate must be in [0, 1], got {self.donate}")


@dataclasses.dataclass(frozen=True)
class PlanParams(_IntervalParams):
    """Plan-based lookahead (arXiv:2109.00082): per-μ EFT plan over a qcount
    EMA with history weight ``ema_alpha``."""

    ema_alpha: float = 0.2
    ctrl_overhead_s: float = 2e-4

    def _validate(self):
        super()._validate()
        _require((0.0 < self.ema_alpha) & (self.ema_alpha <= 1.0),
                 f"ema_alpha must be in (0, 1], got {self.ema_alpha}")
        _require(self.ctrl_overhead_s >= 0.0,
                 f"ctrl_overhead_s must be >= 0, got {self.ctrl_overhead_s}")


@dataclasses.dataclass(frozen=True)
class PlanOptParams(SchedulerParams):
    """Plan-*optimization* knobs of the batch plane
    (:func:`repro_torch.batch.plan.plan_schedule`): simulated annealing over
    job orderings inside a lookahead window.  ``sa_steps``/``sa_restarts``
    are structural (:data:`STATIC_FIELDS`: the annealer's length and its
    number of parallel streams); ``t0_s`` is the initial Metropolis
    temperature in seconds of mean wait; jobs submitted beyond
    ``lookahead_s`` keep their arrival order at the plan's tail."""

    sa_steps: int = 400
    sa_restarts: int = 2
    t0_s: float = 600.0
    cooling: float = 0.985
    lookahead_s: float = 1e9

    def _validate(self):
        super()._validate()
        _require(self.sa_steps >= 1,
                 f"sa_steps must be >= 1, got {self.sa_steps}")
        _require(self.sa_restarts >= 1,
                 f"sa_restarts must be >= 1, got {self.sa_restarts}")
        _require(self.t0_s > 0.0, f"t0_s must be > 0, got {self.t0_s}")
        _require((0.0 < self.cooling) & (self.cooling <= 1.0),
                 f"cooling must be in (0, 1], got {self.cooling}")
        _require(self.lookahead_s > 0.0,
                 f"lookahead_s must be > 0, got {self.lookahead_s}")

"""The schedulers the paper compares against, as plain tensor functions.

The port of ``repro.core.baselines``: FIFO, GIFT (BSIP interval budgets +
coupons), TBF (token buckets, HTC, PSSB spare sharing), AdapTBF (buckets +
a per-μ waterfilling borrow exchange) and plan-based lookahead.  The
modelling notes are the reference module's.  ``AuxState`` keeps the
reference's fields so an engine state converts leaf for leaf.

Every function takes any leading batch axes in front of ``[S, J]`` (the
engine's lanes of a batched run) and its numeric knobs as Python numbers
or float32 tensors that broadcast against ``[..., S, J]`` (the engine's
per-lane ``[L, 1, 1]``).  The draws take their uniforms, not a key: the
engine draws every worker's uniforms of a tick in one batch from the same
threefry stream (:meth:`repro_torch.core.scheduler.Scheduler.draws`).
Sums and prefix sums that decide a pick or a grant follow the reference's
order (:mod:`.ordered`).  A charge takes the popped job of every server row
(``j_sel[..., S]``) where the reference takes ``(arange(S), j_sel)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ordered import fma, ordered_cumsum, ordered_sum


class AuxState(NamedTuple):
    budget: torch.Tensor      # f32[..., S, J] GIFT per-interval byte budget
    coupons: torch.Tensor     # f32[..., S, J] GIFT carried reward
    served: torch.Tensor      # f32[..., S, J] bytes served this interval
    bucket: torch.Tensor      # f32[..., S, J] TBF/AdapTBF tokens
    spare: torch.Tensor       # f32[..., S]    TBF spare-bandwidth quota
    borrowed: torch.Tensor    # f32[..., S, J] AdapTBF outstanding borrowed tokens
    ema: torch.Tensor         # f32[..., S, J] plan: qcount-history EMA
    plan: torch.Tensor        # f32[..., S, J] plan: per-μ serving allowance


def init_aux(n_servers: int, max_jobs: int, device="cpu", lanes=()) -> AuxState:
    lanes = tuple(lanes)
    z = lambda *shape: torch.zeros(lanes + shape, dtype=torch.float32,
                                   device=device)
    return AuxState(budget=z(n_servers, max_jobs),
                    coupons=z(n_servers, max_jobs),
                    served=z(n_servers, max_jobs),
                    bucket=z(n_servers, max_jobs), spare=z(n_servers),
                    borrowed=z(n_servers, max_jobs),
                    ema=z(n_servers, max_jobs), plan=z(n_servers, max_jobs))


def _add_at(x, j_sel, v):
    """``x[..., r, j_sel[..., r]] += v[..., r]`` for every server row ``r``
    (the engine pops at most one job per row per worker), one scatter."""
    return x.scatter_add(-1, j_sel[..., None].to(torch.int64),
                         v[..., None].to(x.dtype))


# -- FIFO -------------------------------------------------------------------

def fifo_select(head_time: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """Earliest queued arrival across jobs, ties to the lowest job index;
    -1 when all queues are empty."""
    j = torch.argmin(head_time, dim=-1).to(torch.int32)
    return torch.where(demand.any(dim=-1), j, -1)


# -- GIFT -------------------------------------------------------------------

def _bsip_need(qcount, mu_s: float, server_bw: float):
    """The interval's bytes split over jobs in proportion to pending I/O."""
    pending = qcount.to(torch.float32)
    tot = torch.clamp_min(pending.sum(dim=-1, keepdim=True), 1.0)
    return server_bw * mu_s * pending / tot, pending


def gift_interval(aux: AuxState, qcount, mu_s: float, server_bw: float,
                  coupon_frac) -> AuxState:
    """One μ boundary: BSIP budgets, coupons redeemed, a fraction of the
    unserved budget banked."""
    fair, pending = _bsip_need(qcount, mu_s, server_bw)
    unserved = torch.clamp_min(aux.budget, 0.0)
    banked = coupon_frac * unserved * (pending > 0).to(torch.float32)
    return aux._replace(budget=fair + aux.coupons, coupons=banked,
                        served=torch.zeros_like(aux.served))


def gift_select(aux: AuxState, demand: torch.Tensor, u) -> torch.Tensor:
    """Pick among demanded jobs with budget left, weighted by budget; idle
    when every demanded job is out of budget (throttling)."""
    w = torch.where(demand & (aux.budget > 0), aux.budget, 0.0)
    return _weighted_pick(w, u)


def gift_charge(aux: AuxState, j_sel, add_bytes) -> AuxState:
    return aux._replace(budget=_add_at(aux.budget, j_sel, -add_bytes),
                        served=_add_at(aux.served, j_sel, add_bytes))


# -- TBF --------------------------------------------------------------------

def tbf_refill(aux: AuxState, rate, dt: float, burst) -> AuxState:
    return aux._replace(bucket=torch.minimum(aux.bucket + rate * dt,
                                             torch.as_tensor(burst)))


def tbf_interval(aux: AuxState, mu_s: float, server_bw: float, rate,
                 headroom) -> AuxState:
    """One μ boundary: PSSB spare estimate from the last interval's
    guaranteed-rate consumption, discounted by ``headroom``."""
    cap_bytes = server_bw * mu_s
    guaranteed = torch.minimum(aux.served, rate * mu_s).sum(dim=-1)
    if torch.is_tensor(headroom) and headroom.dim():
        headroom = headroom[..., 0]          # [..., 1, 1] -> against [..., S]
    spare = headroom * torch.clamp_min(cap_bytes - guaranteed, 0.0)
    return aux._replace(spare=spare, served=torch.zeros_like(aux.served))


def tbf_select(aux: AuxState, demand: torch.Tensor, req_bytes, u,
               u_spare) -> torch.Tensor:
    """Admit jobs whose bucket covers the request (weighted by depth); else
    lend from the spare quota uniformly over demanded jobs; else idle.
    ``u_spare`` are the uniforms of ``fold_in(key, 1)``."""
    covered = demand & (aux.bucket >= req_bytes[..., None, :])
    w_adm = torch.where(covered, torch.clamp_min(aux.bucket, 1.0), 0.0)
    any_adm = covered.any(dim=-1)
    spare_open = aux.spare > req_bytes.amax(dim=-1, keepdim=True)
    w_spare = torch.where(demand & spare_open[..., None], 1.0, 0.0)
    return torch.where(any_adm, _weighted_pick(w_adm, u),
                       _weighted_pick(w_spare, u_spare))


def tbf_charge(aux: AuxState, j_sel, add_bytes) -> AuxState:
    """Guaranteed tokens first; the rest draws on the spare quota."""
    col = j_sel[..., None].to(torch.int64)
    have = torch.clamp_min(aux.bucket.gather(-1, col)[..., 0], 0.0)
    from_bucket = torch.minimum(add_bytes, have)
    from_spare = add_bytes - from_bucket
    return aux._replace(
        bucket=_add_at(aux.bucket, j_sel, -from_bucket),
        spare=aux.spare + -from_spare,
        served=_add_at(aux.served, j_sel, add_bytes))


# -- AdapTBF ----------------------------------------------------------------

def adaptbf_refill(aux: AuxState, rate, dt: float, burst) -> AuxState:
    """Accrual like TBF that never claws back tokens lifted above the cap
    by a borrow grant."""
    refilled = torch.minimum(aux.bucket + rate * dt, torch.as_tensor(burst))
    return aux._replace(bucket=torch.maximum(aux.bucket, refilled))


def waterfill(deficit: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """Grants ``min(deficit, L)`` per row, the common level ``L`` chosen so
    the row's grants sum to ``min(pool, Σdeficit)``; ``deficit`` f32[..., J],
    ``pool`` f32[...]."""
    d = torch.clamp_min(deficit, 0.0)
    j_ = d.shape[-1]
    ds = torch.sort(d, dim=-1).values
    cs = ordered_cumsum(ds)
    steps = (j_ - 1 - torch.arange(j_, device=d.device)).to(d.dtype)
    used_at = cs + ds * steps
    pool = torch.clamp_min(torch.as_tensor(pool, dtype=d.dtype,
                                           device=d.device), 0.0)
    k = (used_at < pool[..., None]).sum(dim=-1)
    csk = torch.where(
        k > 0, cs.gather(-1, torch.clamp_min(k - 1, 0)[..., None])[..., 0],
        0.0)
    level = (pool - csk) / torch.clamp_min(j_ - k, 1).to(d.dtype)
    level = torch.where(k >= j_, torch.inf, torch.clamp_min(level, 0.0))
    return torch.minimum(d, level[..., None])


def adaptbf_interval(aux: AuxState, qcount, mu_s: float, server_bw: float,
                     repay_frac) -> AuxState:
    """One μ boundary of the per-server borrow exchange: repay a fraction
    of the debt into the pool, waterfill the pooled surplus over the
    deficits; token mass is conserved."""
    need, _ = _bsip_need(qcount, mu_s, server_bw)
    debt = torch.clamp_min(aux.borrowed, 0.0)
    repay = repay_frac * debt
    # XLA recomputes the repayment inside each fusion that subtracts it and
    # contracts bucket - repay_frac * debt into one multiply-add.
    kept = fma(-debt, repay_frac, aux.bucket)
    donatable = torch.clamp_min(kept - need, 0.0) + repay
    deficit = torch.clamp_min(need - kept, 0.0)
    pool = ordered_sum(donatable)
    grant = waterfill(deficit, pool)
    take_frac = ordered_sum(grant) / torch.clamp_min(pool, 1e-30)
    bucket = fma(-donatable, take_frac[..., None], aux.bucket) + grant
    # It also folds (repay_frac * debt) * take_frac into debt * (take_frac
    # * repay_frac), the two per-row scalars multiplied first.
    borrowed = fma(-debt, take_frac[..., None] * repay_frac,
                   aux.borrowed) + grant
    return aux._replace(bucket=bucket, borrowed=borrowed,
                        served=torch.zeros_like(aux.served))


def adaptbf_cross_donate(aux: AuxState, qcount, mu_s: float, server_bw: float,
                         donate_frac) -> AuxState:
    """Fleet-level match across servers after the per-server exchange: a
    fraction ``donate_frac`` of every bucket's surplus is pooled over all
    ``[S, J]`` and waterfilled over the global deficits.  At
    ``donate_frac == 0`` the aux passes through unchanged."""
    need, _ = _bsip_need(qcount, mu_s, server_bw)
    surplus = torch.clamp_min(aux.bucket - need, 0.0)
    deficit = torch.clamp_min(need - aux.bucket, 0.0)
    donatable = donate_frac * surplus
    flat = lambda x: x.reshape(x.shape[:-2] + (-1,))
    pool = ordered_sum(flat(donatable))
    grant = waterfill(flat(deficit), pool).reshape(deficit.shape)
    take_frac = ordered_sum(flat(grant)) / torch.clamp_min(pool, 1e-30)
    on = torch.as_tensor(donate_frac) > 0.0
    take = take_frac[..., None, None]
    return aux._replace(
        bucket=torch.where(on, fma(-donatable, take, aux.bucket) + grant,
                           aux.bucket),
        borrowed=torch.where(on, aux.borrowed + grant, aux.borrowed))


def adaptbf_select(aux: AuxState, demand: torch.Tensor, req_bytes,
                   u) -> torch.Tensor:
    """Admit jobs whose (possibly borrowed-into) bucket covers the request,
    weighted by bucket depth; idle otherwise."""
    covered = demand & (aux.bucket >= req_bytes[..., None, :])
    w = torch.where(covered, torch.clamp_min(aux.bucket, 1.0), 0.0)
    return _weighted_pick(w, u)


def adaptbf_charge(aux: AuxState, j_sel, add_bytes) -> AuxState:
    return aux._replace(bucket=_add_at(aux.bucket, j_sel, -add_bytes),
                        served=_add_at(aux.served, j_sel, add_bytes))


# -- plan-based -------------------------------------------------------------

def plan_interval(aux: AuxState, qcount, ema_alpha) -> AuxState:
    """One μ boundary: refresh the qcount EMA and rebuild the plan."""
    pending = qcount.to(torch.float32)
    ema = fma(ema_alpha, pending, (1.0 - ema_alpha) * aux.ema)
    return aux._replace(ema=ema, plan=ema, served=torch.zeros_like(aux.served))


def plan_select(aux: AuxState, head_time: torch.Tensor,
                demand: torch.Tensor) -> torch.Tensor:
    """Smallest estimated remaining demand among demanded jobs with
    allowance left; FIFO when the plan has no eligible entry."""
    eligible = demand & (aux.plan > 0.0)
    score = torch.where(eligible, aux.ema, torch.inf)
    j = torch.argmin(score, dim=-1).to(torch.int32)
    return torch.where(eligible.any(dim=-1), j, fifo_select(head_time, demand))


def plan_charge(aux: AuxState, j_sel, add_bytes) -> AuxState:
    """One unit of allowance per pop (``add_bytes > 0`` marks a pop)."""
    pop = (add_bytes > 0).to(aux.plan.dtype)
    return aux._replace(plan=_add_at(aux.plan, j_sel, -pop),
                        served=_add_at(aux.served, j_sel, add_bytes))


# -- shared -----------------------------------------------------------------

def _weighted_pick(w: torch.Tensor, u) -> torch.Tensor:
    """Weighted categorical per row of ``w`` f32[..., J] with uniforms
    ``u`` f32[...]; -1 for all-zero rows."""
    total = ordered_sum(w)
    x = u * torch.clamp_min(total, 1e-30)
    cdf = ordered_cumsum(w)
    idx = (cdf <= x[..., None]).sum(dim=-1)
    idx = torch.clamp(idx, 0, w.shape[-1] - 1)
    has = w.gather(-1, idx[..., None])[..., 0] > 0
    first = torch.argmax((w > 0).to(torch.int32), dim=-1)
    idx = torch.where(has, idx, first)
    return torch.where(total > 0, idx, -1).to(torch.int32)

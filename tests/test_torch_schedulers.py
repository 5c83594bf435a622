"""The port's four interval schedulers (gift, tbf, adaptbf, plan) against the
JAX reference, on the CPU.

* Schemas: the same fields, defaults, range checks and ``params_hash``.
* Allocation math (``core/baselines.py``) on random inputs: the μ-boundary
  updates, ``waterfill`` and ``adaptbf_cross_donate``, and the select rules
  from the same keys.  Sums and prefix sums follow the reference's order
  (``core/ordered.py``), so results are bit-equal; the one exception is
  AdapTBF's bucket update, where XLA contracts some products into fused
  multiply-adds the port does not reproduce: a bucket emptied by the
  exchange keeps a residual of a few bytes' fraction that differs in its
  last bits (held within 4 ulps of the row's largest bucket).
* Engine: one tick from the reference's state (a plain tick and a μ
  boundary), and a 400-tick lockstep run with every integer counter equal
  on every tick (a flipped pick would show as a counter difference), then
  ``Experiment.run`` against ``repro.api.Experiment``.
* The reference's AdapTBF borrow-exchange and plan FIFO-fallback
  properties, on the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as RefExperiment
from repro.core import baselines as ref_bl
from repro.core import engine as ref_engine
from repro.core import params as ref_params
from repro.core import scheduler as ref_sched
from repro.core.policy import Policy as RefPolicy
from repro_torch.api import Experiment
from repro_torch.core import baselines, convert, engine, params, prng
from repro_torch.core import scheduler as sched_mod
from repro_torch.core.policy import Policy

SCHEDULERS = ("gift", "tbf", "adaptbf", "plan")
SCHEMAS = ("ThemisParams", "FifoParams", "GiftParams", "TbfParams",
           "AdaptbfParams", "PlanParams")
JOBS = [
    dict(user=0, size=2, procs=40, req_mb=8, think_s=0.002),
    dict(user=1, size=1, procs=20, req_mb=4, start_s=0.05),
    dict(user=2, group=1, size=1, procs=10, req_mb=16, start_s=0.05,
         think_s=0.001),
    dict(user=1, size=3, procs=7, req_mb=2, servers=[1],
         phases=[dict(start_s=0.0, duration_s=0.1, arrival="interval",
                      interval_s=0.01),
                 dict(start_s=0.15, duration_s=0.2)]),
]
GEOM = dict(n_servers=2, max_jobs=8, n_workers=4, seed=3, sync_ticks=50)
MU = 50
N_BINS = 4
INT_LEAVES = ("qcount", "head", "wheel", "known", "issued", "completed",
              "idle_worker_ticks", "dropped", "key")
FLOAT_LEAVES = ("arr_time", "free_at", "bytes_bin")


def schema_name(scheduler):
    return {"gift": "GiftParams", "tbf": "TbfParams",
            "adaptbf": "AdaptbfParams", "plan": "PlanParams"}[scheduler]


def both_params(scheduler, **kw):
    name = schema_name(scheduler)
    return getattr(ref_params, name)(**kw), getattr(params, name)(**kw)


def configs(scheduler):
    rp, pp = both_params(scheduler, mu_ticks=MU)
    ref = ref_engine.EngineConfig(scheduler=scheduler, tick_impl="ref",
                                  scheduler_params=rp, **GEOM)
    port = engine.EngineConfig(scheduler=scheduler, device="cpu",
                               scheduler_params=pp, **GEOM)
    return ref, port


@functools.lru_cache(maxsize=None)
def ref_step(scheduler):
    cfg, _ = configs(scheduler)
    wl, table = ref_engine.make_workload(cfg, JOBS)
    tick = ref_engine.make_tick(cfg, wl, table, N_BINS)
    p = ref_engine.get_scheduler(scheduler).params(cfg)
    return wl, table, jax.jit(lambda s: tick(p, s, None)[0])


@functools.lru_cache(maxsize=None)
def ref_states(scheduler, n_ticks):
    """The reference's states after 0..n_ticks ticks (numpy leaves)."""
    cfg, _ = configs(scheduler)
    _, _, step = ref_step(scheduler)
    state = ref_engine.init_state(cfg, N_BINS)
    out = [jax.tree.map(np.asarray, state)]
    for _ in range(n_ticks):
        state = step(state)
        out.append(jax.tree.map(np.asarray, state))
    return out


def assert_aux_close(got, want, tag):
    for f in want._fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        scale = np.abs(b).max(axis=-1, keepdims=True) if b.ndim > 1 else \
            np.abs(b)
        ulp = np.spacing(np.maximum(scale, np.float32(1e-30)))
        assert (np.abs(a - b) <= 4 * ulp).all(), f"{tag}: aux.{f}"


# -- schemas ------------------------------------------------------------------

@pytest.mark.parametrize("name", SCHEMAS)
def test_params_hash_and_fields_match_reference(name):
    ref_cls, cls = getattr(ref_params, name), getattr(params, name)
    assert [f.name for f in dataclasses.fields(cls)] == \
        [f.name for f in dataclasses.fields(ref_cls)]
    assert cls().params_hash() == ref_cls().params_hash()
    assert cls.numeric_fields() == ref_cls.numeric_fields()
    if cls.numeric_fields():
        kw = {f: 0.25 for f in cls.numeric_fields()}
        if "mu_ticks" in [f.name for f in dataclasses.fields(cls)]:
            kw["mu_ticks"] = 77
        assert cls(**kw).params_hash() == ref_cls(**kw).params_hash()


@pytest.mark.parametrize("name,bad", [
    ("GiftParams", dict(coupon_frac=1.5)), ("GiftParams", dict(mu_ticks=0)),
    ("TbfParams", dict(headroom=-0.1)), ("TbfParams", dict(rate=-1.0)),
    ("AdaptbfParams", dict(repay=2.0)), ("AdaptbfParams", dict(donate=-1.0)),
    ("PlanParams", dict(ema_alpha=0.0))])
def test_params_validation_matches_reference(name, bad):
    with pytest.raises(ValueError):
        getattr(ref_params, name)(**bad)
    with pytest.raises(ValueError):
        getattr(params, name)(**bad)


def test_stack_params_refuses_mixed_cadence():
    with pytest.raises(ValueError, match="mu_ticks"):
        params.stack_params([params.GiftParams(mu_ticks=10),
                             params.GiftParams(mu_ticks=20)])
    with pytest.raises(TypeError):
        params.stack_params([params.GiftParams(), params.PlanParams()])
    st = params.stack_params([params.TbfParams(rate=1.0),
                              params.TbfParams(rate=2.0)])
    assert st.rate.tolist() == [1.0, 2.0] and st.mu_ticks == 500


def shipped_reference_schedulers() -> tuple:
    """The reference's registered schedulers defined by the reference
    package itself: a test file of the reference registers one more
    (``always-first``), which outlives that file in a worker process."""
    return tuple(name for name in ref_sched.available_schedulers()
                 if type(ref_sched.get_scheduler(name)).__module__
                 .startswith("repro.core."))


def test_registry_matches_reference():
    assert sched_mod.available_schedulers() == shipped_reference_schedulers()
    for name in shipped_reference_schedulers():
        ref, port = ref_sched.get_scheduler(name), sched_mod.get_scheduler(name)
        for flag in ("uses_segments", "has_intervals", "kernel_tick",
                     "cross_shard", "kernel_select_mode"):
            assert getattr(port, flag) == getattr(ref, flag), (name, flag)
        assert port.params_cls.__name__ == ref.params_cls.__name__
    with pytest.raises(ValueError, match="unknown scheduler"):
        sched_mod.get_scheduler("fiffo")
    for name in SCHEDULERS:
        cfg = engine.EngineConfig(scheduler=name, device="cpu")
        assert engine.resolve_tick_impl(cfg, sched_mod.get_scheduler(name)) \
            == "scan"


# -- allocation math ------------------------------------------------------------

S, J = 16, 8


def random_aux(rng):
    f = lambda scale, p=1.0: (rng.random((S, J)) * scale
                              * (rng.random((S, J)) < p)).astype(np.float32)
    return dict(budget=f(2e7) - 5e6, coupons=f(1e6, 0.5),
                served=f(1.2e7, 0.7), bucket=f(1.1e7), spare=
                (rng.random(S) * 3e7).astype(np.float32),
                borrowed=f(1e6, 0.5), ema=f(30.0), plan=f(20.0, 0.7))


def both_aux(a):
    return (ref_bl.AuxState(**{k: jnp.asarray(v) for k, v in a.items()}),
            baselines.AuxState(**{k: torch.from_numpy(v) for k, v in a.items()}))


def qcounts(rng):
    return (rng.integers(0, 30, (S, J)) * (rng.random((S, J)) < 0.6)
            ).astype(np.int32)


@pytest.mark.parametrize("seed", range(3))
def test_interval_updates_match_reference(seed):
    rng = np.random.default_rng(seed)
    ra, pa = both_aux(random_aux(rng))
    q = qcounts(rng)
    qj, qt = jnp.asarray(q), torch.from_numpy(q)
    cases = {
        "gift": (jax.jit(lambda a, q: ref_bl.gift_interval(a, q, 0.05, 22e9,
                                                           jnp.float32(0.5))),
                 lambda a, q: baselines.gift_interval(a, q, 0.05, 22e9,
                                                      torch.tensor(0.5))),
        "tbf": (jax.jit(lambda a, q: ref_bl.tbf_interval(
                    a, 0.05, 22e9, jnp.float32(2.75e9), jnp.float32(0.8))),
                lambda a, q: baselines.tbf_interval(
                    a, 0.05, 22e9, torch.tensor(2.75e9), torch.tensor(0.8))),
        "plan": (jax.jit(lambda a, q: ref_bl.plan_interval(a, q,
                                                           jnp.float32(0.2))),
                 lambda a, q: baselines.plan_interval(a, q, torch.tensor(0.2))),
        "adaptbf": (jax.jit(lambda a, q: ref_bl.adaptbf_interval(
                        a, q, 0.05, 22e9, jnp.float32(0.1))),
                    lambda a, q: baselines.adaptbf_interval(
                        a, q, 0.05, 22e9, torch.tensor(0.1))),
    }
    for name, (ref_fn, port_fn) in cases.items():
        want, got = ref_fn(ra, qj), port_fn(pa, qt)
        if name == "adaptbf":
            assert_aux_close(convert_aux(got), want, name)
            continue
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"{name}: {f}")


def convert_aux(aux):
    return baselines.AuxState(*(x.numpy() for x in aux))


@pytest.mark.parametrize("seed", range(4))
def test_waterfill_matches_reference(seed):
    rng = np.random.default_rng(10 + seed)
    n = (5, 8, 33, 200)[seed]
    deficit = (rng.random((12, n)) * 1e7 * (rng.random((12, n)) < 0.6)
               ).astype(np.float32)
    pool = (rng.random(12) * deficit.sum(axis=1) * 1.3).astype(np.float32)
    want = np.asarray(jax.jit(ref_bl.waterfill)(jnp.asarray(deficit),
                                                 jnp.asarray(pool)))
    got = baselines.waterfill(torch.from_numpy(deficit),
                              torch.from_numpy(pool)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(axis=1) <= np.minimum(pool, deficit.sum(axis=1)) * 1.0001
            ).all()


@pytest.mark.parametrize("donate", (0.0, 0.5))
def test_cross_donate_matches_reference(donate):
    rng = np.random.default_rng(21)
    ra, pa = both_aux(random_aux(rng))
    q = qcounts(rng)
    want = jax.jit(lambda a, q: ref_bl.adaptbf_cross_donate(
        a, q, 0.05, 22e9, jnp.float32(donate)))(ra, jnp.asarray(q))
    got = baselines.adaptbf_cross_donate(pa, torch.from_numpy(q), 0.05, 22e9,
                                         torch.tensor(donate))
    if donate == 0.0:      # passes through bitwise
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(ra, f)))
    assert_aux_close(convert_aux(got), want, f"donate={donate}")
    np.testing.assert_allclose(got.bucket.sum().item(),
                               float(np.asarray(ra.bucket).sum()), rtol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_selects_match_reference(seed):
    rng = np.random.default_rng(30 + seed)
    a = random_aux(rng)
    ra, pa = both_aux(a)
    demand = rng.random((S, J)) < 0.6
    demand[0] = False                          # an idle row
    head = rng.random((S, J)).astype(np.float32)
    req = (rng.integers(1, 5, J) * 2.5e6).astype(np.float32)
    key = ref_engine.prng_key(seed)
    kt = prng.PRNGKey(seed)
    u = prng.uniform(kt, (S,))
    u1 = prng.uniform(prng.fold_in(kt, 1), (S,))
    dj, dt = jnp.asarray(demand), torch.from_numpy(demand)
    pairs = {
        "gift": (ref_bl.gift_select(ra, dj, key),
                 baselines.gift_select(pa, dt, u)),
        "tbf": (ref_bl.tbf_select(ra, dj, jnp.asarray(req), key),
                baselines.tbf_select(pa, dt, torch.from_numpy(req), u, u1)),
        "adaptbf": (ref_bl.adaptbf_select(ra, dj, jnp.asarray(req), key),
                    baselines.adaptbf_select(pa, dt, torch.from_numpy(req), u)),
        "plan": (ref_bl.plan_select(ra, jnp.asarray(head), dj),
                 baselines.plan_select(pa, torch.from_numpy(head), dt)),
    }
    for name, (want, got) in pairs.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)


def test_weighted_pick_matches_reference_at_large_j():
    """J = 1024: the reference's blocked prefix sum, not an in-order one."""
    rng = np.random.default_rng(5)
    w = (rng.random((64, 1024)) * (rng.random((64, 1024)) < 0.7)
         ).astype(np.float32)
    key = ref_engine.prng_key(9)
    want = np.asarray(jax.jit(ref_bl._weighted_pick)(jnp.asarray(w), key))
    got = baselines._weighted_pick(torch.from_numpy(w),
                                   prng.uniform(prng.PRNGKey(9), (64,)))
    np.testing.assert_array_equal(got.numpy(), want)


# -- engine ---------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", SCHEDULERS)
@pytest.mark.parametrize("n_ticks", (137, 150))
def test_one_tick_parity_from_reference_state(scheduler, n_ticks):
    """Tick 150 is a μ boundary (μ = 50 ticks)."""
    states = ref_states(scheduler, 151)
    start, want = states[n_ticks], states[n_ticks + 1]
    _, cfg = configs(scheduler)
    wl, table, _ = ref_step(scheduler)
    np_tree = lambda x: jax.tree.map(np.asarray, x)
    tick = engine.make_tick(cfg, convert.workload_from_numpy(np_tree(wl)),
                            convert.table_from_numpy(np_tree(table)), N_BINS)
    got = convert.state_to_numpy(engine.map_state(tick(
        engine.get_scheduler(scheduler).params(cfg),
        engine.map_state(convert.state_from_numpy(start), lambda x: x[None])
    ), lambda x: x[0]))
    assert int(start.qcount.sum()) > 0
    for f in INT_LEAVES + FLOAT_LEAVES:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{scheduler}@{n_ticks}: {f}")
    assert_aux_close(got.aux, want.aux, f"{scheduler}@{n_ticks}")


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_lockstep_run_counter_exact(scheduler):
    """400 ticks (eight μ boundaries) stepped together: every integer leaf
    equal on every tick, so no pick flipped."""
    ticks = 400
    states = ref_states(scheduler, ticks)
    _, cfg = configs(scheduler)
    wl, table = engine.make_workload(cfg, JOBS)
    tick = engine.make_tick(cfg, wl, table, N_BINS)
    p = engine.get_scheduler(scheduler).params(cfg)
    st = engine.init_state(cfg, N_BINS)
    for t in range(ticks):
        st = tick(p, st)
        got = convert.state_to_numpy(engine.map_state(st, lambda x: x[0]))
        for f in INT_LEAVES:
            np.testing.assert_array_equal(
                getattr(got, f), getattr(states[t + 1], f),
                err_msg=f"{scheduler}: {f} differs at tick {t}")
    for f in FLOAT_LEAVES:
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(states[ticks], f), err_msg=f)
    assert_aux_close(got.aux, states[ticks].aux, scheduler)
    assert int(got.completed.sum()) > 1000


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_experiment_matches_reference(scheduler):
    rp, pp = both_params(scheduler, mu_ticks=100)
    kw = dict(policy="job-fair", scheduler=scheduler, n_servers=2,
              n_workers=4, seed=5)
    ref = RefExperiment(params=rp, **kw).add_jobs(JOBS).run(0.4)
    res = Experiment(params=pp, device="cpu", **kw).add_jobs(JOBS).run(0.4)
    for f in ("scheduler", "policy", "n_jobs", "dropped", "idle_worker_ticks",
              "ticks"):
        assert getattr(res, f) == getattr(ref, f), f
    assert res.params_hash() == ref.params_hash()
    assert res.counters() == ref.counters()
    np.testing.assert_array_equal(res.completed, ref.completed)
    np.testing.assert_array_equal(res.gbps, ref.gbps)
    assert res.cov_gbps(0) == ref.cov_gbps(0)
    np.testing.assert_array_equal(res.job_gbps(1), ref.job_gbps(1))


# -- the reference's scheduler properties ----------------------------------------

def _adaptbf(bucket, borrowed):
    sched = sched_mod.get_scheduler("adaptbf")
    aux = sched.init_aux(1, 4)._replace(
        bucket=torch.tensor([bucket], dtype=torch.float32),
        borrowed=torch.tensor([borrowed], dtype=torch.float32))
    cfg = engine.EngineConfig(n_servers=1, max_jobs=4, scheduler="adaptbf",
                              device="cpu")
    return sched, cfg, aux


def test_adaptbf_exchange_conserves_token_mass():
    sched, cfg, aux = _adaptbf([50.0, 0.0, 10.0, 200.0], [0.0, 0.0, 5.0, 0.0])
    q = torch.tensor([[4, 8, 0, 0]], dtype=torch.int32)
    out = sched.interval_update(cfg, sched.params(cfg), aux, q)
    assert float(out.bucket.sum()) == pytest.approx(float(aux.bucket.sum()),
                                                    rel=1e-5)


def test_adaptbf_debt_persists_until_tokens_leave():
    sched, cfg, aux = _adaptbf([100.0, 0.0, 0.0, 0.0], [40.0, 0.0, 0.0, 0.0])
    out = sched.interval_update(cfg, sched.params(cfg), aux,
                                torch.zeros((1, 4), dtype=torch.int32))
    assert float(out.bucket[0, 0]) == pytest.approx(100.0, rel=1e-5)
    assert float(out.borrowed[0, 0]) == pytest.approx(40.0, rel=1e-5)


def test_cold_plan_select_equals_fifo_select():
    rng = np.random.default_rng(0)
    aux = baselines.init_aux(2, 6)            # cold: ema == plan == 0
    for _ in range(25):
        head = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 6)).astype(np.float32))
        demand = torch.from_numpy(rng.random((2, 6)) < 0.5)
        assert torch.equal(baselines.plan_select(aux, head, demand),
                           baselines.fifo_select(head, demand))


def test_cold_plan_engine_run_is_fifo_bit_identical():
    jobs = [dict(user=0, size=1, procs=6, req_mb=10, start_s=0.05, end_s=0.3),
            dict(user=1, size=1, procs=3, req_mb=4, start_s=0.05, end_s=0.3)]
    plan = Experiment(scheduler="plan", device="cpu", n_workers=4,
                      params=params.PlanParams(mu_ticks=10 ** 6,
                                               ctrl_overhead_s=0.0)
                      ).add_jobs(jobs).run(0.3)
    fifo = Experiment(scheduler="fifo", device="cpu", n_workers=4
                      ).add_jobs(jobs).run(0.3)
    for key in ("gbps", "issued", "completed", "dropped"):
        np.testing.assert_array_equal(np.asarray(plan[key]),
                                      np.asarray(fifo[key]))

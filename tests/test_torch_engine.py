"""The port's engine against the JAX reference engine, on the CPU.

* One-tick parity: the reference runs N ticks, ``convert.state_from_numpy``
  carries its state to the port, and one tick runs on both sides.  Every
  leaf must be equal.  Covers themis and fifo, both worker paths, and
  a tick on which the λ-sync fires.
* FIFO full run: counter-exact (every leaf equal) over 300 ticks.
* Themis run: counter-exact (every leaf equal at every tick) over 2000
  ticks.
* ``Experiment(..., device="cpu").run()`` returns the reference's
  ``RunResult`` fields.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.api import Experiment as RefExperiment
from repro.core import engine as ref_engine
from repro.core.policy import Policy as RefPolicy
from repro_torch.api import Experiment
from repro_torch.core import convert, engine
from repro_torch.core.policy import Policy

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
N_BINS = 4
INT_LEAVES = ("qcount", "head", "wheel", "known", "synced", "issued",
              "completed", "idle_worker_ticks", "dropped", "key")
FLOAT_LEAVES = ("arr_time", "free_at", "seg", "bytes_bin")


def configs(scheduler, impl, policy="user-fair", **kw):
    geom = dict(GEOM, **kw)
    ref = ref_engine.EngineConfig(policy=RefPolicy.parse(policy),
                                  scheduler=scheduler, tick_impl="ref", **geom)
    port = engine.EngineConfig(policy=Policy.parse(policy),
                               scheduler=scheduler, tick_impl=impl,
                               device="cpu", **geom)
    return ref, port


@functools.lru_cache(maxsize=None)
def ref_tick_fn(scheduler):
    cfg, _ = configs(scheduler, "fused")
    wl, table = ref_engine.make_workload(cfg, JOBS)
    tick = ref_engine.make_tick(cfg, wl, table, N_BINS)
    p = ref_engine.get_scheduler(scheduler).params(cfg)
    step = jax.jit(lambda s: tick(p, s, None)[0])
    return wl, table, step


@functools.lru_cache(maxsize=None)
def ref_state_after(scheduler, n_ticks):
    cfg, _ = configs(scheduler, "fused")
    wl, table, step = ref_tick_fn(scheduler)
    state = ref_engine.init_state(cfg, N_BINS)
    for _ in range(n_ticks):
        state = step(state)
    return jax.tree.map(np.asarray, state)


def port_inputs(scheduler, impl):
    _, cfg = configs(scheduler, impl)
    wl, table, _ = ref_tick_fn(scheduler)
    np_tree = lambda x: jax.tree.map(np.asarray, x)
    twl = convert.workload_from_numpy(np_tree(wl))
    ttable = convert.table_from_numpy(np_tree(table))
    return cfg, twl, ttable


def assert_states_match(ref_np, port_state, tag):
    got = convert.state_to_numpy(port_state)
    assert int(got.t) == int(ref_np.t), tag
    for f in INT_LEAVES + FLOAT_LEAVES:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(
            getattr(ref_np, f)), err_msg=f"{tag}: {f}")


@pytest.mark.parametrize("impl", engine.TICK_IMPLS)
@pytest.mark.parametrize("scheduler", ("themis", "fifo"))
@pytest.mark.parametrize("n_ticks", (137, 149))
def test_one_tick_parity_from_reference_state(scheduler, impl, n_ticks):
    """Tick 149 -> 150 fires the λ-sync (sync_ticks = 50)."""
    start = ref_state_after(scheduler, n_ticks)
    want = ref_state_after(scheduler, n_ticks + 1)
    cfg, wl, table = port_inputs(scheduler, impl)
    tick = engine.make_tick(cfg, wl, table, N_BINS)
    state = engine.map_state(convert.state_from_numpy(start),
                             lambda x: x[None])
    assert int(state.qcount.sum()) > 0
    p = engine.get_scheduler(scheduler).params(cfg)
    got = engine.map_state(tick(p, state), lambda x: x[0])
    assert_states_match(want, got, f"{scheduler}/{impl}@{n_ticks}")


def test_state_round_trip():
    start = ref_state_after("fifo", 60)
    back = convert.state_to_numpy(convert.state_from_numpy(start))
    for f in start._fields:
        if f == "aux":
            continue
        a, b = np.asarray(getattr(start, f)), getattr(back, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("impl", engine.TICK_IMPLS)
def test_fifo_full_run_counter_exact(impl):
    ref_cfg, cfg = configs("fifo", impl)
    want = ref_engine.run(ref_cfg, *ref_engine.make_workload(ref_cfg, JOBS),
                          0.3)
    got = engine.run(cfg, *engine.make_workload(cfg, JOBS), 0.3)
    assert got["ticks"] == want["ticks"] == 300
    ref_np = jax.tree.map(np.asarray, want["state"])
    out = convert.state_to_numpy(got["state"])
    for f in INT_LEAVES + FLOAT_LEAVES:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref_np, f),
                                      err_msg=f)
    assert int(got["completed"].sum()) > 0


def test_themis_run_within_two_percent():
    """Step both engines in lockstep for 2000 ticks (40 λ-syncs): every
    leaf, ``seg`` and ``bytes_bin`` included, equals the reference's at
    every tick.  The draw and the λ-sync take the reference's order of sums
    (and its flushed subnormals), so no pick may flip."""
    ticks = 2000
    _, cfg = configs("themis", "fused", bin_ticks=1000)
    ref_cfg, _ = configs("themis", "fused", bin_ticks=1000)
    wl, table = ref_engine.make_workload(ref_cfg, JOBS)
    ref_tick = ref_engine.make_tick(ref_cfg, wl, table, 2)
    p = ref_engine.get_scheduler("themis").params(ref_cfg)
    step = jax.jit(lambda s: ref_tick(p, s, None)[0])
    rs = ref_engine.init_state(ref_cfg, 2)
    twl, ttable = engine.make_workload(cfg, JOBS)
    tick = engine.make_tick(cfg, twl, ttable, 2)
    ts = engine.init_state(cfg, 2)
    for t in range(ticks):
        rs = step(rs)
        ts = tick(p, ts)
        got = convert.state_to_numpy(engine.map_state(ts, lambda x: x[0]))
        for f in INT_LEAVES + FLOAT_LEAVES:
            np.testing.assert_array_equal(
                getattr(got, f), np.asarray(getattr(rs, f)),
                err_msg=f"tick {t}: {f}")
    assert np.asarray(rs.completed).sum() > 1000


@pytest.mark.parametrize("scheduler,policy", (("themis", "user-fair"),
                                              ("fifo", None)))
def test_experiment_matches_reference(scheduler, policy):
    kw = dict(policy=policy, scheduler=scheduler, n_servers=2, n_workers=4,
              seed=5)
    ref = RefExperiment(**kw).add_jobs(JOBS).run(0.4)
    res = Experiment(device="cpu", **kw).add_jobs(JOBS).run(0.4)
    for f in ("scheduler", "policy", "n_jobs", "seconds", "bin_s", "dropped",
              "idle_worker_ticks", "ticks"):
        assert getattr(res, f) == getattr(ref, f), f
    assert res.params_hash() == ref.params_hash()
    np.testing.assert_array_equal(res.issued, ref.issued)
    np.testing.assert_array_equal(res.completed, ref.completed)
    np.testing.assert_array_equal(res.gbps, ref.gbps)
    assert res.mean_gbps(0) == ref.mean_gbps(0)
    assert res.jain_fairness() == ref.jain_fairness()
    assert res["completed"] is res.completed
    assert res.slowdown(res, job=1) == 1.0
    assert isinstance(res.state, engine.EngineState)
    assert res.state.qcount.device == torch.device("cpu")

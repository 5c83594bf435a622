"""Seeds and parameter points as lanes of one tick loop, on the CPU.

* Every lane of ``run_batch`` (themis fused, fifo, and the scan schedulers)
  equals a sequential ``run()`` with that seed, state leaf for leaf.
* Every lane of a 3-point x 2-seed ``sweep`` equals ``run()`` with that
  point and seed; ``sweep`` and ``solo`` run for every scheduler.
* ``BatchRunResult`` and ``SweepResult`` give the reference's members and
  values (``repro.api``) on the same spec.
"""
import functools

import numpy as np
import pytest
import torch

from repro.api import Experiment as RefExperiment
from repro.core import params as ref_params
from repro_torch import api
from repro_torch.api import Experiment
from repro_torch.core import engine, params

JOBS = [dict(user=0, size=1, procs=30, req_mb=8, end_s=0.1),
        dict(user=1, size=1, procs=20, req_mb=4, start_s=0.025, end_s=0.075,
             think_s=0.001),
        dict(user=2, size=1, procs=6, req_mb=16, start_s=0.01,
             arrival="interval", interval_s=0.005)]
KW = dict(n_servers=2, n_workers=4, bin_ticks=25)
SEEDS = (0, 7, 2 ** 33 + 1)


def exp(scheduler, seed=0, point=None, cls=Experiment, **kw):
    extra = {} if cls is RefExperiment else dict(device="cpu")
    return cls(policy="user-fair", scheduler=scheduler, seed=seed,
               params=point, **KW, **extra, **kw).add_jobs(JOBS)


def assert_lane_equals(state, k, one, tag):
    lane = engine.map_state(state, lambda x: x[k])
    for f in engine.EngineState._fields:
        if f == "t":
            assert lane.t == one.t
        elif f == "aux":
            for a, b in zip(lane.aux, one.aux):
                assert torch.equal(a, b), f"{tag}: aux"
        else:
            assert torch.equal(getattr(lane, f), getattr(one, f)), f"{tag}: {f}"


@pytest.mark.parametrize("scheduler,impl", [
    ("themis", "fused"), ("themis", "scan"), ("fifo", "fused"),
    ("gift", "fused"), ("tbf", "fused"), ("adaptbf", "fused"),
    ("plan", "fused")])
def test_run_batch_lanes_equal_runs(scheduler, impl):
    point = None
    if scheduler in ("gift", "tbf", "adaptbf", "plan"):
        point = {"gift": params.GiftParams, "tbf": params.TbfParams,
                 "adaptbf": params.AdaptbfParams,
                 "plan": params.PlanParams}[scheduler](mu_ticks=20)
    batch = exp(scheduler, point=point, tick_impl=impl).run_batch(
        0.1, seeds=SEEDS)
    assert batch.gbps.shape[0] == len(SEEDS)
    assert batch.seeds.dtype == np.uint32
    for k, seed in enumerate(SEEDS):
        one = exp(scheduler, seed=seed, point=point, tick_impl=impl).run(0.1)
        assert_lane_equals(batch.state, k, one.state, f"{scheduler} lane {k}")
        np.testing.assert_array_equal(batch.gbps[k], one.gbps)
        assert batch.idle_worker_ticks[k] == one.idle_worker_ticks


def test_sweep_lanes_equal_runs():
    grid = {"rate": [0.0, 1e9, 3e9]}
    sw = exp("tbf", point=params.TbfParams(mu_ticks=20)).sweep(
        grid, 0.1, seeds=SEEDS[:2])
    assert sw.n_points == 3 and sw.n_seeds == 2
    assert sw.completed.shape[:2] == (3, 2)
    for i, point in enumerate(sw.points):
        assert point.rate == grid["rate"][i] and point.mu_ticks == 20
        for k, seed in enumerate(SEEDS[:2]):
            one = exp("tbf", seed=seed, point=point).run(0.1)
            np.testing.assert_array_equal(sw.completed[i, k], one.completed)
            np.testing.assert_array_equal(sw.gbps[i, k], one.gbps)
            assert sw.dropped[i, k] == one.dropped
            assert sw.idle_worker_ticks[i, k] == one.idle_worker_ticks


def test_sweep_refuses_mixed_cadence_and_unknown_fields(tmp_path):
    """The grid's refusals, also through a workspace (which records
    nothing for a refused grid)."""
    e = exp("gift")
    for ws in (None, tmp_path):
        with pytest.raises(ValueError, match="mu_ticks"):
            e.sweep([params.GiftParams(mu_ticks=10),
                     params.GiftParams(mu_ticks=20)], 0.01, seeds=(0,),
                    workspace=ws)
        with pytest.raises(ValueError, match="not numeric fields"):
            e.sweep({"mu_ticks": [10, 20]}, 0.01, seeds=(0,), workspace=ws)
        with pytest.raises(TypeError):
            e.sweep([params.PlanParams()], 0.01, seeds=(0,), workspace=ws)
    from repro_torch.workspace import WorkspaceStore
    assert len(WorkspaceStore(tmp_path)) == 0


@functools.lru_cache(maxsize=None)
def batches():
    ref = exp("themis", cls=RefExperiment).run_batch(0.1, seeds=SEEDS)
    port = exp("themis").run_batch(0.1, seeds=SEEDS)
    return ref, port


def test_batch_result_matches_reference():
    ref, port = batches()
    assert isinstance(port, api.BatchRunResult)
    assert port.n_seeds == ref.n_seeds
    np.testing.assert_array_equal(port.seeds, ref.seeds)
    np.testing.assert_array_equal(port["completed"], ref["completed"])
    np.testing.assert_array_equal(port.gbps, ref.gbps)
    np.testing.assert_array_equal(port.idle_worker_ticks, ref.idle_worker_ticks)
    assert port.counters() == ref.counters()
    fn = lambda r: r.jain_fairness(0.025, 0.075)
    assert port.mean_cov(fn) == ref.mean_cov(fn)
    assert port.seed_metric(lambda r: r.cov_gbps(0)) == \
        ref.seed_metric(lambda r: r.cov_gbps(0))
    one_p, one_r = port.seed_result(1), ref.seed_result(1)
    assert one_p.mean_gbps(1) == one_r.mean_gbps(1)
    assert len(port.per_seed()) == len(SEEDS)
    for name in ("job_gbps", "mean_gbps", "cov_gbps", "jain_fairness"):
        with pytest.raises(TypeError, match="per-run metric"):
            getattr(port, name)(0) if name == "job_gbps" else \
                getattr(port, name)()


def test_sweep_result_matches_reference():
    grid = {"ema_alpha": [0.2, 0.6]}
    ref = exp("plan", point=ref_params.PlanParams(mu_ticks=20),
              cls=RefExperiment).sweep(grid, 0.1, seeds=SEEDS[:2])
    port = exp("plan", point=params.PlanParams(mu_ticks=20)).sweep(
        grid, 0.1, seeds=SEEDS[:2])
    assert isinstance(port, api.SweepResult)
    np.testing.assert_array_equal(port.completed, ref.completed)
    np.testing.assert_array_equal(port.gbps, ref.gbps)
    solo_p = exp("plan", point=params.PlanParams(mu_ticks=20)).solo(0, 0.1)
    solo_r = exp("plan", point=ref_params.PlanParams(mu_ticks=20),
                 cls=RefExperiment).solo(0, 0.1)
    np.testing.assert_array_equal(solo_p.completed, solo_r.completed)
    assert port.summary(0.025, 0.075, solo=solo_p) == \
        ref.summary(0.025, 0.075, solo=solo_r)
    fn = lambda r: r.mean_gbps(None)
    assert port.argbest(fn) == ref.argbest(fn)
    for a, b in zip(port.slowdown(solo_p, 1), ref.slowdown(solo_r, 1)):
        np.testing.assert_array_equal(a, b)
    assert port.point_result(1).params == params.PlanParams(mu_ticks=20,
                                                            ema_alpha=0.6)


def test_resolved_params_and_arrivals_match_reference():
    for cls, p in ((RefExperiment, ref_params.GiftParams(coupon_frac=0.3)),
                   (Experiment, params.GiftParams(coupon_frac=0.3))):
        e = exp("gift", point=p, cls=cls)
        assert e.resolved_params() == p
        e.arrivals(job=1, arrival="poisson", rate_hz=200.0)
        assert e.jobs[1]["arrival"] == "poisson"
        with pytest.raises(IndexError):
            e.arrivals(job=7, think_s=0.1)
        before = [dict(j) for j in e.jobs]
        with pytest.raises(ValueError):
            e.arrivals(arrival="nonsense")
        assert e.jobs == before
    assert exp("fifo").resolved_params() == params.FifoParams()


def test_poisson_phases_match_reference():
    """A Poisson job beside closed ones, counter for counter."""
    def spec(cls):
        e = exp("fifo", cls=cls).arrivals(job=2, arrival="poisson",
                                          rate_hz=400.0)
        return e.run_batch(0.1, seeds=SEEDS[:2])
    ref, port = spec(RefExperiment), spec(Experiment)
    assert ref.issued[:, 2].sum() > 50
    np.testing.assert_array_equal(port.issued, ref.issued)
    np.testing.assert_array_equal(port.completed, ref.completed)
    np.testing.assert_array_equal(port.dropped, ref.dropped)


def grid_of(scheduler):
    """Two grid points of the scheduler's schema (μ = 20 ticks where it
    has one, so the short runs cross μ boundaries)."""
    from repro_torch.core.scheduler import get_scheduler
    cls = get_scheduler(scheduler).params_cls
    kw = {"mu_ticks": 20} if "mu_ticks" in cls.__dataclass_fields__ else {}
    return [cls(**kw), cls(**kw)]


@pytest.mark.parametrize("scheduler", ("themis", "fifo", "gift", "tbf",
                                       "adaptbf", "plan"))
def test_sweep_and_solo_run_for_every_scheduler(scheduler):
    points = grid_of(scheduler)
    sw = exp(scheduler, point=points[0]).sweep(points, 0.1, seeds=(0, 4))
    one = exp(scheduler, seed=4, point=points[1]).run(0.1)
    np.testing.assert_array_equal(sw.completed[1, 1], one.completed)
    np.testing.assert_array_equal(sw.gbps[0, 1], one.gbps)
    solo = exp(scheduler, point=points[0]).solo(1, 0.1)
    assert solo.n_jobs == 1 and solo.issued[0] > 0
    assert solo.slowdown(solo) == 1.0

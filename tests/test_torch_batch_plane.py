"""The port's batch plane (``repro_torch.batch``) against the reference's
(``repro.batch``) on the CPU: the queue presets and their hashes, the list
schedule for FCFS and any order on random queues, EASY and the wait
metrics, the annealer's plan bit for bit, the bridge's scenario and its
engine run, the cached campaigns, and the rows of ``bench/batch.py``.
"""
import pathlib

import numpy as np
import pytest
import torch

import repro.batch as ref_batch
from repro.batch import sim as ref_sim
from repro.workspace import WorkspaceStore as RefStore
from repro_torch import batch
from repro_torch.batch import sim
from repro_torch.bench import batch as bench_batch
from repro_torch.workspace import WorkspaceStore

REPO = pathlib.Path(__file__).resolve().parent.parent
PRESETS = ("bb-heavy", "longtail", "mixed")


def both_queues(name, n_jobs, seed):
    return (batch.queue_preset(name, n_jobs=n_jobs, seed=seed),
            ref_batch.queue_preset(name, n_jobs=n_jobs, seed=seed))


@pytest.mark.parametrize("seed", (0, 5, -1, 2 ** 33 + 5))
@pytest.mark.parametrize("name", PRESETS)
def test_presets_and_queue_hash_equal_reference(name, seed):
    for n_jobs in (1, 8, 24):
        port, ref = both_queues(name, n_jobs, seed)
        for col, arr in ref.arrays().items():
            got = port.arrays()[col]
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
        assert port.queue_hash() == ref.queue_hash()
    assert batch.queue_presets() == ref_batch.queue_presets()


def test_queue_validation_matches_reference():
    for mod in (batch, ref_batch):
        with pytest.raises(ValueError, match="walltime_s"):
            mod.BatchJob(submit_s=0.0, walltime_s=0.0, nodes=1, bb_bytes=0.0)
        with pytest.raises(ValueError, match="never be scheduled"):
            mod.make_queue([dict(submit_s=0.0, walltime_s=1.0, nodes=99,
                                 bb_bytes=0.0)])
        with pytest.raises(ValueError, match="unknown queue preset"):
            mod.queue_preset("nope")
    jobs = [dict(submit_s=1.0, walltime_s=5.0, nodes=2, bb_bytes=3e9)]
    cl = batch.ClusterSpec(n_nodes=4, n_servers=1, bb_per_server=8e9)
    ref_cl = ref_batch.ClusterSpec(n_nodes=4, n_servers=1, bb_per_server=8e9)
    assert batch.make_queue(jobs, cl).queue_hash() == \
        ref_batch.make_queue(jobs, ref_cl).queue_hash()


def random_queues(seed, n):
    """A random queue from a numpy seed, made in both packages: nodes up
    to the whole cluster, reservations up to the whole pool, bursts of
    arrivals."""
    rng = np.random.default_rng(seed)
    jobs = [dict(submit_s=float(s), walltime_s=float(w), nodes=int(k),
                 bb_bytes=float(b))
            for s, w, k, b in zip(
                np.cumsum(rng.exponential(50.0, n) * (rng.random(n) < 0.7)),
                rng.uniform(10.0, 900.0, n), rng.integers(1, 33, n),
                rng.uniform(0.0, 1.0, n) * 2 * 64 * 2 ** 30)]
    return batch.make_queue(jobs), ref_batch.make_queue(jobs)


@pytest.mark.parametrize("seed,n", [(0, 8), (1, 13), (2, 24), (3, 24),
                                    (4, 17), (5, 8)])
def test_schedule_order_equals_reference(seed, n):
    """FCFS (arrival order, no overtaking) and two random orders, one at a
    time and as a batch of orders: every start bit for bit."""
    port, ref = random_queues(seed, n)
    np.testing.assert_array_equal(sim.simulate_fcfs(port, device="cpu"),
                                  ref_sim.simulate_fcfs(ref))
    a = ref.arrays()
    rng = np.random.default_rng(100 + seed)
    orders = np.stack([rng.permutation(n) for _ in range(2)]).astype(np.int32)
    cols = sim.queue_columns(port, "cpu")
    got = sim.schedule_order(torch.from_numpy(orders), cols, 32,
                             port.cluster.bb_total)
    for k, order in enumerate(orders):
        want = np.asarray(ref_sim.schedule_order(
            order, a["submit"], a["wall"], a["nodes"], a["bb"], 32,
            ref.cluster.bb_total))
        assert got[k].numpy().tobytes() == want.tobytes(), k
        one = sim.schedule_order(torch.from_numpy(order), cols, 32,
                                 port.cluster.bb_total)
        assert one.numpy().tobytes() == want.tobytes()
        sim.validate_schedule(port, one.numpy().astype(np.float64))


@pytest.mark.parametrize("seed,n", [(0, 8), (2, 24), (6, 16)])
def test_easy_and_metrics_equal_reference(seed, n):
    port, ref = random_queues(seed, n)
    got, want = sim.simulate_easy(port), ref_sim.simulate_easy(ref)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    m_port, m_ref = sim.wait_metrics(port, got), ref_sim.wait_metrics(ref,
                                                                     want)
    assert m_port.keys() == m_ref.keys()
    for k in m_ref:
        assert m_port[k] == pytest.approx(m_ref[k], rel=1e-14), k
    with pytest.raises(AssertionError, match="before submit"):
        sim.validate_schedule(port, got - 1e4)


def test_validate_schedule_rejects_what_the_reference_rejects():
    jobs = [dict(submit_s=0.0, walltime_s=10.0, nodes=20, bb_bytes=9e10),
            dict(submit_s=1.0, walltime_s=10.0, nodes=20, bb_bytes=1e9),
            dict(submit_s=2.0, walltime_s=10.0, nodes=1, bb_bytes=9e10)]
    port, ref = batch.make_queue(jobs), ref_batch.make_queue(jobs)
    for start, what in (([0.0, 1.0, 20.0], "node capacity"),
                        ([0.0, 10.0, 2.0], "BB capacity"),
                        ([0.0, 10.0, np.inf], "non-finite")):
        for mod, q in ((sim, port), (ref_sim, ref)):
            with pytest.raises(AssertionError, match=what):
                mod.validate_schedule(q, np.asarray(start))
    sim.validate_schedule(port, [0.0, 10.0, 20.0])


PLAN_STEPS = 30


@pytest.mark.parametrize("lookahead_s", (1e9, 1500.0))
@pytest.mark.parametrize("name", PRESETS)
def test_plan_equals_reference(name, lookahead_s):
    """Order, start vector and cost bit for bit at 30 steps, 2 restarts,
    three seeds per preset, with the whole queue and a short lookahead."""
    port_p = batch.PlanOptParams(sa_steps=PLAN_STEPS, lookahead_s=lookahead_s)
    ref_p = ref_batch.PlanOptParams(sa_steps=PLAN_STEPS,
                                    lookahead_s=lookahead_s)
    assert port_p.params_hash() == ref_p.params_hash()
    for seed in (0, 1, 7):
        port, ref = both_queues(name, 16, seed)
        s, o, c = batch.plan_schedule(port, port_p, seed=seed, device="cpu")
        rs, ro, rc = ref_batch.plan_schedule(ref, ref_p, seed=seed)
        assert o.tolist() == ro.tolist(), seed
        assert s.tobytes() == rs.tobytes() and c == rc, seed
        sim.validate_schedule(port, s)


def test_plan_records_each_step():
    """``record`` gives every step's values without changing the plan, and
    each recorded step leads to the next step's recorded cost."""
    port, _ = both_queues("bb-heavy", 8, 0)
    p = batch.PlanOptParams(sa_steps=6, sa_restarts=3)
    from repro_torch.batch.plan import RECORD_FIELDS, anneal, plan_window
    order0 = torch.from_numpy(sim.arrival_order(port))
    cols = sim.queue_columns(port, "cpu")
    args = (order0, cols, 32, port.cluster.bb_total, p, 0,
            plan_window(port, p))
    best, cost, rec = anneal(*args, record=True)
    plain_best, plain_cost = anneal(*args)
    assert torch.equal(best, plain_best) and torch.equal(cost, plain_cost)
    assert set(rec) == set(RECORD_FIELDS)
    assert all(v.shape == (6, 3) for v in rec.values())
    assert rec["accept"].dtype == torch.bool
    assert float(cost) <= float(rec["cost"][0, 0])
    moved = torch.where(rec["accept"], rec["c_prop"], rec["cost"])
    assert torch.equal(moved[:-1], rec["cost"][1:])
    assert float(cost) == float(torch.minimum(
        rec["c_prop"].min(), rec["cost"][0].min()))
    with pytest.raises(TypeError, match="PlanOptParams"):
        batch.plan_schedule(port, batch.ClusterSpec(), device="cpu")


@pytest.fixture(scope="module")
def bridged():
    """The bb-heavy plan timeline (8 jobs) through both bridges."""
    port, ref = both_queues("bb-heavy", 8, 0)
    p, rp = (batch.PlanOptParams(sa_steps=20),
             ref_batch.PlanOptParams(sa_steps=20))
    bx = batch.BatchExperiment(port, params=p, device="cpu")
    rbx = ref_batch.BatchExperiment(ref, params=rp)
    return bx, bx.run("plan"), rbx, rbx.run("plan")


def test_bridge_scenario_equals_reference(bridged):
    bx, res, rbx, rres = bridged
    assert bx.to_scenario(res).to_json() == rbx.to_scenario(rres).to_json()
    tree, scale = batch.timeline_to_tree(bx.queue, res.start, horizon_s=3.0)
    rtree, rscale = ref_batch.timeline_to_tree(rbx.queue, rres.start,
                                               horizon_s=3.0)
    assert scale == rscale
    from repro.scenario import to_jobs as ref_to_jobs
    from repro_torch.scenario import to_jobs
    assert to_jobs(tree) == ref_to_jobs(rtree)


def test_bridge_runs_counter_exact_on_the_engine(bridged):
    """The admitted timeline on the port's engine against the reference's
    for 300 ticks (themis, job-fair, the cluster's 2 servers)."""
    bx, res, rbx, rres = bridged
    exp, horizon = bx.to_experiment(res, scheduler="themis", horizon_s=0.3)
    rexp, rhorizon = rbx.to_experiment(rres, scheduler="themis",
                                       horizon_s=0.3)
    assert exp.device == "cpu" and horizon == rhorizon == 0.3
    assert exp.jobs == rexp.jobs and exp.n_servers == rexp.n_servers == 2
    got, want = exp.run(horizon), rexp.run(rhorizon)
    assert got.ticks == want.ticks == 300
    for f in ("issued", "completed", "dropped", "idle_worker_ticks"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(got.gbps, np.asarray(want.gbps))


def test_campaign_cache_hits_are_bit_identical(tmp_path, bridged):
    """``sweep_seeds`` with a store: a second call computes nothing and
    returns the same start vectors; points the reference recorded are
    reused by the port (the keys are equal)."""
    bx, _, rbx, _ = bridged
    store = WorkspaceStore(tmp_path / "port")
    first = bx.sweep_seeds("plan", (0, 1), store=store)
    results, rep = batch.run_batch_campaign(bx, ("plan", "fcfs"), (0, 1),
                                            store=WorkspaceStore(
                                                tmp_path / "port"))
    assert (rep["reused"], rep["computed"]) == (2, 2)
    for k, seed in enumerate((0, 1)):
        hit = results[("plan", seed)]
        assert hit.start.tobytes() == first[k].start.tobytes()
        assert hit.order.tolist() == first[k].order.tolist()
        assert hit.metrics == first[k].metrics
    rbx.sweep_seeds("easy", (3,), store=RefStore(tmp_path / "ref"))
    _, rep = batch.run_batch_campaign(bx, ("easy",), (3,),
                                      store=WorkspaceStore(tmp_path / "ref"))
    assert (rep["reused"], rep["computed"]) == (1, 0)
    assert batch.batch_point_key(bx, "plan", 2, "c", bx.queue_hash()) \
        .key_hash == ref_batch.batch_point_key(
            rbx, "plan", 2, "c", rbx.queue_hash()).key_hash


def test_bench_rows_equal_reference(monkeypatch):
    """``bench/batch.py``'s rows at 8 jobs, 20 steps, one seed and a 0.1 s
    bridge equal the text of the reference's ``benchmarks/bench_batch.py``
    at the same settings."""
    for k, v in (("BENCH_BATCH_JOBS", "8"), ("BENCH_BATCH_STEPS", "20"),
                 ("BENCH_SEEDS", "1"), ("BENCH_SECONDS", "0.1")):
        monkeypatch.setenv(k, v)
    monkeypatch.syspath_prepend(str(REPO))
    from benchmarks import bench_batch as ref_bench
    want = {name: derived for name, _, derived in ref_bench.run_batch()}
    got = bench_batch.run_batch(0.1, (0,), n_jobs=8, sa_steps=20,
                                device="cpu")
    assert [r.name for r in got] == list(want)
    for r in got:
        assert r.derived == want[r.name], r.name
        assert r.means[0] == pytest.approx(float(r.derived.split()[0]
                                                 .rstrip("x")), abs=0.06)


def test_batch_reference_file_is_complete():
    """``batch_reference.json`` (what ``chip_smoke.py``'s batch_plane phase
    holds the card to) has every row at the bench's full settings."""
    doc = bench_batch.load_reference()
    assert doc["seconds"] == bench_batch.BENCH_SECONDS
    assert doc["seeds"] == list(bench_batch.BENCH_SEEDS)
    assert (doc["n_jobs"], doc["sa_steps"]) == (bench_batch.BENCH_JOBS,
                                                bench_batch.BENCH_STEPS)
    assert doc["jax"] and "--batch" in doc["command"]
    names = [f"batch_{p.replace('-', '')}_{pol}_{kind}"
             for p in bench_batch.PRESETS for pol in bench_batch.POLICIES
             for kind in ("meanwait_s", "p95wait_s")]
    names += [f"batch_{p.replace('-', '')}_plan_vs_{b}"
              for p in bench_batch.PRESETS for b in ("fcfs", "easy")]
    assert sorted(doc["rows"]) == sorted(names + ["batch_bridge_themis_gbps"])
    for name, row in doc["rows"].items():
        assert float(row["derived"].split()[0].rstrip("x")) == row["value"], \
            name

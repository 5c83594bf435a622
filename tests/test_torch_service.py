"""The port's burst-buffer service against the reference's, on the same
requests: the file system's placement and bytes, the drain's completion
order for every scheduler, scenario replay, the cross-plane ON/OFF shares
and ``Experiment.serve``'s configuration."""
import numpy as np
import pytest

import repro.api as ref_api
from repro.bb import service as ref_bb
from repro.fs import store as ref_fs
from repro_torch import api
from repro_torch.bb import service as bb
from repro_torch.fs import store as fs

SCHEDULERS = ("themis", "fifo", "gift", "tbf", "adaptbf", "plan")


# -- the file system -------------------------------------------------------------

@pytest.mark.parametrize("n_servers", (1, 2, 3, 8, 16))
def test_ring_places_every_path_as_the_reference(n_servers):
    want, got = ref_fs.ConsistentHash(n_servers), fs.ConsistentHash(n_servers)
    paths = [f"/job{i % 7}/rank{i}/ckpt_{i * 31 % 1000}.h5" for i in range(1000)]
    assert [got.server_of(p) for p in paths] == \
        [want.server_of(p) for p in paths]
    assert [got.server_of(p, replica=2) for p in paths[:100]] == \
        [want.server_of(p, replica=2) for p in paths[:100]]
    assert [got.stripe_servers(p, 3) for p in paths[:100]] == \
        [want.stripe_servers(p, 3) for p in paths[:100]]


def test_file_system_matches_reference():
    out = []
    for mod in (ref_fs, fs):
        f = mod.FileSystem(4, default_stripes=3, stripe_size=1000)
        f.create("/d", is_dir=True)
        f.create("/d/a")
        f.create("/d/b", n_stripes=2)
        data = bytes(range(256)) * 30
        f.write("/d/a", 0, data)
        f.write("/d/a", 2500, b"xyz" * 700)
        f.write("/d/b", 10, b"q" * 3333)
        plan = list(f.stripe_plan("/d/a", 400, 4321))
        reads = (f.read("/d/a", 0, 9000), f.read("/d/a", 999, 1234),
                 f.read("/d/b", 0, 3343))
        meta = {p: (m.size, m.is_dir, m.n_stripes, m.servers)
                for p, m in f.meta.items()}
        listing = f.listdir("/d")
        f.unlink("/d/b")
        out.append((plan, reads, meta, listing, sorted(f.meta),
                    [(s.bytes_written, s.bytes_read) for s in f.stores]))
    assert out[1] == out[0]


# -- the drain ------------------------------------------------------------------

def _drive(mod, sched, policy, **kw):
    """Two servers, three jobs (sizes 1, 2, 4): files created, an
    interleaved burst of writes of three sizes, then reads and metadata
    ops, drained twice."""
    cluster = mod.BBCluster(n_servers=2, policy=policy, scheduler=sched,
                            n_workers=2, max_jobs=8, seed=3, **kw)
    clients = [mod.BBClient(cluster, mod.JobMeta(job_id=i + 1, user=i % 2,
                                                 size=1 + i * (i + 1) // 2),
                            autodrain=False) for i in range(3)]
    for i, c in enumerate(clients):
        c.open(f"/f{i}", "w")
        c.mkdir(f"/dir{i}")
    first = cluster.drain()
    for k in range(8):
        for i, c in enumerate(clients):
            c._req("write", f"/f{i}", offset=k * 64 * (i + 1),
                   data=bytes([65 + i]) * (64 * (i + 1)))
    second = cluster.drain()
    reads = [c._req("read", f"/f{i}", offset=0, size=128)
             for i, c in enumerate(clients)]
    clients[0].stat("/f1")
    clients[1].readdir("/")
    third = cluster.drain()
    order = [[(r.job.job_id, r.op, r.done_at, r.seqno) for r in done]
             for done in (first, second, third)]
    return order, [r.result for r in reads], cluster.clock


@pytest.mark.parametrize("policy", ("size-fair", "job-fair"))
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_drain_order_matches_reference(sched, policy):
    want = _drive(ref_bb, sched, policy)
    got = _drive(bb, sched, policy, device="cpu")
    assert got == want


def test_autodrain_client_reads_back_and_sharding_refused():
    cluster = bb.BBCluster(n_servers=2, policy="job-fair", device="cpu")
    c = bb.BBClient(cluster, bb.JobMeta(job_id=1))
    with c.open("/x", "w") as f:
        f.write(b"hello " * 100)
    f = c.open("/x")
    assert f.read(12) == b"hello hello "
    f.seek(-6, 2)
    assert f.read() == b"hello "
    bb.BBCluster(tick_impl="auto", device="cpu")     # accepted, selects nothing
    with pytest.raises(ValueError, match="sharding needs .* 2 ranks"):
        bb.BBCluster(shard_servers=2, device="cpu")


def test_phase_at_matches_reference():
    phases = [dict(start_s=0.0, end_s=1.0, req_mb=1.0),
              dict(start_s=1.5, end_s=2.0, req_mb=2.0)]
    for t in (0.0, 0.99, 1.0, 1.2, 1.5, 1.999, 2.0):
        assert bb.phase_at(phases, t) == ref_bb.phase_at(phases, t)


# -- scenario replay ---------------------------------------------------------------

def _onoff(mod, sched="themis", **kw):
    return (mod.Experiment(policy="job-fair", scheduler=sched, n_workers=4,
                           **kw)
            .add_job(user=0, procs=8, req_mb=10, end_s=2.0)
            .add_job(user=1, procs=8, req_mb=10)
            .phase(start_s=0.0, end_s=1.0))


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_replay_matches_reference(sched):
    kw = dict(round_s=0.25, reqs_per_round=6)
    want = _onoff(ref_api, sched).serve(autodrain=False).replay(2.0, **kw)
    got = _onoff(api, sched, device="cpu").serve(autodrain=False).replay(
        2.0, **kw)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.order == want.order
    assert got.n_rounds == want.n_rounds
    assert list(got.rounds_between(0.3, 1.6)) == \
        list(want.rounds_between(0.3, 1.6))
    assert got.window_share(0, 0.25, 1.0) == want.window_share(0, 0.25, 1.0)
    assert got.window_share(1, 0.0, 2.0, k=3) == \
        want.window_share(1, 0.0, 2.0, k=3)


class TestCrossPlaneOnOff:
    """The reference's ``tests/test_scenario.py::TestCrossPlaneOnOff`` on
    the port: the same ON/OFF scenario gives the same share split on the
    engine and on the service's replay, within the reference's bounds."""

    def test_shares_agree_in_both_windows(self):
        res = _onoff(api, device="cpu").run(2.0)
        g0 = res.mean_gbps(0, 0.2, 0.9)
        g1 = res.mean_gbps(1, 0.2, 0.9)
        eng_busy = g0 / (g0 + g1)
        off0 = res.mean_gbps(0, 1.3, 1.9)
        eng_idle = off0 / max(off0 + res.mean_gbps(1, 1.3, 1.9), 1e-9)
        rr = _onoff(api, device="cpu").serve(autodrain=False).replay(
            2.0, round_s=0.125, reqs_per_round=24)
        bb_busy = rr.window_share(0, 0.125, 1.0)
        bb_idle = rr.window_share(0, 1.25, 2.0)
        assert eng_busy == pytest.approx(0.5, abs=0.1)
        assert bb_busy == pytest.approx(eng_busy, abs=0.15)
        assert eng_idle == pytest.approx(1.0, abs=0.05)
        assert bb_idle == pytest.approx(eng_idle, abs=0.05)


# -- Experiment.serve ----------------------------------------------------------------

def _two_jobs(mod, sched, **kw):
    jobs = dict(size=1, procs=8, req_mb=10, end_s=2)
    return (mod.Experiment(policy="job-fair", scheduler=sched, n_workers=4,
                           **kw)
            .add_job(user=0, **jobs).add_job(user=1, **jobs))


def test_serve_honors_engine_kw():
    want = _two_jobs(ref_api, "gift", dt=2e-4, sync_ticks=100)
    exp = _two_jobs(api, "gift", dt=2e-4, sync_ticks=100, device="cpu")
    svc, ref_svc = exp.serve(), want.serve()
    assert svc.cluster.cfg.dt == ref_svc.cluster.cfg.dt == 2e-4
    assert svc.cluster.cfg.sync_ticks == ref_svc.cluster.cfg.sync_ticks
    assert svc.cluster.lam_s == ref_svc.cluster.lam_s
    assert exp.serve(lam_s=0.25).cluster.lam_s == 0.25
    assert svc.cluster.cfg.device == "cpu"
    sobj = exp.sched
    svc_cfg, eng_cfg = svc.cluster.cfg, exp.engine_config()
    assert (sobj.mu_s(sobj.params(svc_cfg), svc_cfg.dt)
            == sobj.mu_s(sobj.params(eng_cfg), eng_cfg.dt))
    unsynced = _two_jobs(api, "themis", sync_ticks=0, device="cpu").serve()
    assert unsynced.cluster.lam_s == _two_jobs(
        ref_api, "themis", sync_ticks=0).serve().cluster.lam_s


@pytest.mark.parametrize("sched", SCHEDULERS)
def test_serve_clients_and_default_policy(sched):
    exp = api.Experiment(scheduler=sched, n_workers=2, device="cpu")
    exp.add_job(user=0, procs=4, req_mb=10, end_s=0.5)
    exp.add_job(user=1, group=2, size=3, priority=2.0)
    want = ref_api.Experiment(scheduler=sched, n_workers=2)
    want.add_job(user=0, procs=4, req_mb=10, end_s=0.5)
    want.add_job(user=1, group=2, size=3, priority=2.0)
    svc, ref_svc = exp.serve(autodrain=False), want.serve(autodrain=False)
    assert svc.cluster.policy.name == ref_svc.cluster.policy.name
    assert [vars(c.job) for c in svc.clients] == \
        [vars(c.job) for c in ref_svc.clients]
    assert svc.client(1).job.priority == 2.0
    assert svc.cluster.cfg.max_jobs == ref_svc.cluster.cfg.max_jobs
    assert svc.jobs == ref_svc.jobs
    a, b = svc.client(0), svc.client(1)
    a.open("/a", "w")
    b.open("/b", "w")
    svc.drain()
    for i in range(10):
        a._req("write", "/a", offset=i * 8, data=b"x" * 8)
        b._req("write", "/b", offset=i * 8, data=b"y" * 8)
    assert len(svc.drain()) == 20

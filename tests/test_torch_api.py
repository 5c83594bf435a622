"""The port's facade against the reference's, and what it still refuses.

Every public member of the reference's ``RunResult``, ``BatchRunResult``,
``SweepResult`` and ``Experiment`` exists on the port's classes; those not
ported raise ``NotImplementedError`` naming themselves and the
``ROADMAP.md`` item that ports them, never ``AttributeError``."""
import json

import numpy as np
import pytest

import repro.api as ref_api
from repro_torch import api

#: (class, member, arguments) of each member the port refuses.
REFUSED = [("Experiment", "batch", ())]


def _spec(mod, **kw):
    return (mod.Experiment(policy="job-fair", scheduler="fifo", n_workers=2,
                           **kw)
            .add_job(user=0, procs=4, req_mb=5, end_s=0.6)
            .add_job(user=1, procs=4, req_mb=2))


#: (class, member, call) of each member this slice ported: ``call(spec)``
#: on an Experiment of the reference and of the port gives the same result.
PORTED = [
    ("Experiment", "phase", lambda e: e.phase(start_s=0.0, end_s=0.2)
     .phase(start_s=0.3, duration_s=0.1, req_mb=1.0).jobs),
    ("Experiment", "bursts",
     lambda e: e.bursts(period_s=0.2, duty=0.25, n=3).jobs),
    ("Experiment", "ramp", lambda e: e.ramp(
        start_s=0.1, duration_s=0.4, steps=3, req_mb=(1.0, 4.0)).jobs),
    ("Experiment", "scenario",
     lambda e: e.bursts(period_s=0.3, duty=0.5, n=2).scenario("s").to_json()),
    ("Experiment", "to_json", lambda e: e.to_json("t")),
    ("Experiment", "from_scenario", lambda e: type(e).from_scenario(
        e.to_json("f"), policy="job-fair").jobs),
    ("Experiment", "serve", lambda e: [
        (c.job.job_id, c.job.user, e.serve(lam_s=0.1).cluster.lam_s)
        for c in e.serve().clients]),
]


def run_result():
    return api.RunResult(scheduler="fifo", params=None, policy=None, n_jobs=1,
                         seconds=1.0, gbps=np.zeros((1, 2), np.float32),
                         bin_s=0.5, issued=np.zeros(1, np.int32),
                         completed=np.zeros(1, np.int32), dropped=0,
                         idle_worker_ticks=0, ticks=10)


def test_port_has_every_reference_member():
    for cls in ("RunResult", "BatchRunResult", "SweepResult", "Experiment"):
        ref = {n for n in dir(getattr(ref_api, cls)) if not n.startswith("_")}
        port = {n for n in dir(getattr(api, cls)) if not n.startswith("_")}
        assert ref <= port, sorted(ref - port)


@pytest.mark.parametrize("cls,member,args", REFUSED,
                         ids=[f"{c}.{m}" for c, m, _ in REFUSED])
def test_unported_members_refuse(cls, member, args):
    obj = (run_result() if cls == "RunResult"
           else api.Experiment(scheduler="fifo", device="cpu")
           .add_job(user=0))
    with pytest.raises(NotImplementedError, match=member):
        getattr(obj, member)(*args)


@pytest.mark.parametrize("cls,member,call", PORTED,
                         ids=[f"{c}.{m}" for c, m, _ in PORTED])
def test_ported_members_match_reference(cls, member, call):
    want = call(_spec(ref_api))
    got = call(_spec(api, device="cpu"))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_workspace_runs_refuse():
    exp = api.Experiment(scheduler="fifo", device="cpu").add_job(user=0)
    with pytest.raises(NotImplementedError, match="item 8"):
        exp.solo(0, 0.01, workspace="ws")
    with pytest.raises(NotImplementedError, match="item 8"):
        exp.sweep({}, 0.01, workspace="ws")


def test_run_result_metrics_match_reference():
    """``job_gbps``, ``cov_gbps`` and ``counters`` on the same bins."""
    gbps = np.asarray([[1.0, 3.0, 2.0, 0.0], [0.5, 0.5, 1.5, 2.5]],
                      np.float32)
    kw = dict(scheduler="fifo", policy=None, n_jobs=2, seconds=2.0,
              gbps=gbps, bin_s=0.5, issued=np.ones(2, np.int32),
              completed=np.ones(2, np.int32), dropped=3,
              idle_worker_ticks=4, ticks=2000)
    from repro.core.params import FifoParams as RefFifo
    from repro_torch.core.params import FifoParams
    ref = ref_api.RunResult(params=RefFifo(), **kw)
    port = api.RunResult(params=FifoParams(), **kw)
    np.testing.assert_array_equal(port.job_gbps(1), ref.job_gbps(1))
    for job in (None, 0, 1):
        assert port.cov_gbps(job, 0.5, 2.0) == ref.cov_gbps(job, 0.5, 2.0)
    assert port.counters() == ref.counters()

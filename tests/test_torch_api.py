"""The port's facade refuses what it has not ported yet.

Every public member of the reference's ``RunResult``, ``BatchRunResult``,
``SweepResult`` and ``Experiment`` exists on the port's classes; those not
ported raise ``NotImplementedError`` naming themselves and the
``ROADMAP.md`` item that ports them, never ``AttributeError``."""
import numpy as np
import pytest

import repro.api as ref_api
from repro_torch import api

#: (class, member, arguments) of each member the port refuses.
REFUSED = [
    ("Experiment", "phase", ()), ("Experiment", "bursts", ()),
    ("Experiment", "ramp", ()),
    ("Experiment", "scenario", ()), ("Experiment", "to_json", ()),
    ("Experiment", "from_scenario", ("{}",)), ("Experiment", "batch", ()),
    ("Experiment", "serve", ()),
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

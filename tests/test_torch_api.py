"""The port's facade refuses what it has not ported yet.

Every public member of the reference's ``RunResult`` and ``Experiment``
exists on the port's classes; those not ported raise ``NotImplementedError``
naming themselves and the ``ROADMAP.md`` item that ports them, never
``AttributeError``."""
import numpy as np
import pytest

import repro.api as ref_api
from repro_torch import api

#: (class, member, arguments) of each member the port refuses.
REFUSED = [
    ("RunResult", "job_gbps", (0,)), ("RunResult", "cov_gbps", ()),
    ("RunResult", "counters", ()),
    ("Experiment", "phase", ()), ("Experiment", "bursts", ()),
    ("Experiment", "ramp", ()), ("Experiment", "arrivals", ()),
    ("Experiment", "scenario", ()), ("Experiment", "to_json", ()),
    ("Experiment", "from_scenario", ("{}",)), ("Experiment", "batch", ()),
    ("Experiment", "resolved_params", ()), ("Experiment", "solo", (0, 1.0)),
    ("Experiment", "run_batch", (1.0,)), ("Experiment", "sweep", ({}, 1.0)),
    ("Experiment", "serve", ()),
]


def run_result():
    return api.RunResult(scheduler="fifo", params=None, policy=None, n_jobs=1,
                         seconds=1.0, gbps=np.zeros((1, 2), np.float32),
                         bin_s=0.5, issued=np.zeros(1, np.int32),
                         completed=np.zeros(1, np.int32), dropped=0,
                         idle_worker_ticks=0, ticks=10)


def test_port_has_every_reference_member():
    for cls in ("RunResult", "Experiment"):
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

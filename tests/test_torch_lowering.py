"""The port's own copies of scenario lowering and the metrics plane against
the reference's: the same job lists lower to the same arrays bit for bit,
the same malformed specs are refused with the same exception types, and
the metrics agree exactly on the same result."""
import numpy as np
import pytest

from repro.core import metrics as ref_metrics
from repro.scenario import lowering as ref_lowering
from repro_torch.core import metrics
from repro_torch.scenario import lowering

ARRAYS = ("phase_start", "phase_end", "phase_req", "phase_think",
          "arrival_mode", "arrival_every", "arrival_rate", "procs",
          "overhead_s")

JOB_LISTS = {
    "flat": [dict(user=0, size=2, procs=40, req_mb=8, think_s=0.002),
             dict(user=1, group=2, size=1, priority=2.5, start_s=0.05,
                  end_s=0.3, overhead_us=12.0)],
    "phased": [dict(user=1, size=3, procs=7, req_mb=2, servers=[1, 3],
                    phases=[dict(start_s=0.0, duration_s=0.1,
                                 arrival="interval", interval_s=0.01),
                            dict(start_s=0.1, end_s=0.25, req_mb=4),
                            dict(start_s=0.3, duration_s=0.2,
                                 arrival="poisson", rate_hz=50.0)])],
    "fleet": [dict(user=i % 8, size=1 + i % 4, procs=2 + i % 6,
                   req_mb=1 + i % 4, start_s=0.002 * (i % 50),
                   think_s=0.004 + 0.001 * (i % 5)) for i in range(40)],
}


@pytest.mark.parametrize("dt", (1e-3, 2e-4))
@pytest.mark.parametrize("name", sorted(JOB_LISTS))
def test_lower_matches_reference(name, dt):
    jobs = JOB_LISTS[name]
    kw = dict(dt=dt, n_servers=4, max_jobs=48, ring_cap=64)
    want = ref_lowering.lower(jobs, **kw)
    got = lowering.lower(jobs, **kw)
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.attrs == want.attrs
    assert got.phases == want.phases


@pytest.mark.parametrize("spec", [
    dict(req_md=8),                                       # typo'd key
    dict(phases=[dict(start_s=0.0)]),                     # no end
    dict(phases=[dict(start_s=0.2, end_s=0.1)]),          # empty window
    dict(phases=[dict(start_s=0.0, end_s=0.2),
                 dict(start_s=0.1, end_s=0.3)]),          # overlap
    dict(arrival="interval"),                             # no interval_s
    dict(arrival="bursty"),                               # unknown mode
    dict(procs=100),                                      # > ring_cap
])
def test_lower_refuses_what_the_reference_refuses(spec):
    kw = dict(n_servers=1, ring_cap=64)
    with pytest.raises((TypeError, ValueError)) as want:
        ref_lowering.lower([spec], **kw)
    with pytest.raises(want.type):
        lowering.lower([spec], **kw)


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    result = {"gbps": rng.random((3, 40)).astype(np.float32) * 5,
              "bin_s": 0.1, "completed": np.array([120, 40, 0], np.int32)}
    result["gbps"][2, 10:] = 0.0
    targets = [0.5, 0.3, 0.2]
    for fn, args in (("median_gbps", (1, 0.5, 3.0)),
                     ("std_gbps", (0, 0.0, 4.0)),
                     ("total_gbps", (0.2, 3.7)),
                     ("share_trace", ([0, 1, 2], 0.3, 2.9)),
                     ("time_to_fairness", ([0, 1, 2], targets, 0.4)),
                     ("completion_time", (0, 60)),
                     ("completion_time", (2, 1))):
        np.testing.assert_array_equal(
            getattr(metrics, fn)(result, *args),
            getattr(ref_metrics, fn)(result, *args), err_msg=fn)
    for values in ([], [0.0, 0.0], [1.0, 2.0, 3.5]):
        assert metrics.jain_index(values) == ref_metrics.jain_index(values)
    assert metrics.mean_cov([1.0, 3.0]) == ref_metrics.mean_cov([1.0, 3.0])

"""The port's fleet rows (``repro_torch.bench.fleet``) against the
reference's ``benchmarks/bench_fleet.py``, at ``BENCH_FLEET_SERVERS=16
BENCH_FLEET_JOBS=64 BENCH_FLEET_SECONDS=0.02`` on 1, 2 and 4 gloo CPU
ranks: the row names follow the reference's schema
(``benchmarks/run.py`` ``ROW_SCHEMAS["fleet"]``), ``fleet_gbps_x1``'s text
equals the reference's, x1's integer counters equal the reference's x1 run,
and every rung's counters equal x1's.
"""
import concurrent.futures
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest

from repro_torch.bench import fleet

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = {"BENCH_FLEET_SERVERS": "16", "BENCH_FLEET_JOBS": "64",
         "BENCH_FLEET_SECONDS": "0.02"}


COUNTERS = ("issued", "completed", "dropped", "idle_worker_ticks")


def reference_fleet() -> tuple:
    """The reference's rows at the same knobs (one JAX device here: its
    x1 rung and its truncated-ladder row), and its x1 run's result."""
    from benchmarks import bench_fleet
    runs = []
    simulate = bench_fleet.simulate

    def recording(*args, **kw):
        out = simulate(*args, **kw)
        runs.append(out[0])
        return out

    bench_fleet.simulate = recording
    try:
        return bench_fleet.run_fleet(), runs[0]
    finally:
        bench_fleet.simulate = simulate


@pytest.fixture(scope="module")
def rows():
    saved = {k: os.environ.get(k) for k in SMALL}
    os.environ.update(SMALL)
    sys.path.insert(0, str(REPO))
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ref = pool.submit(reference_fleet)
            results = {}
            got = fleet.run_fleet(device="cpu", results=results)
            return got, results, ref.result()
    finally:
        sys.path.remove(str(REPO))
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def schema_patterns() -> list:
    from benchmarks.run import ROW_SCHEMAS
    return [re.compile(re.escape(p).replace(r"\{k\}", r"\d+") + "$")
            for p in ROW_SCHEMAS["fleet"]]


def test_row_names_follow_the_reference_schema(rows):
    got, _, _ = rows
    assert [r.name for r in got] == [
        "fleet_run_us_per_tick_x1", "fleet_gbps_x1",
        "fleet_run_us_per_tick_x2", "fleet_x2_vs_x1",
        "fleet_run_us_per_tick_x4", "fleet_x4_vs_x1"]
    pats = schema_patterns()
    for r in got:
        assert any(p.match(r.name) for p in pats), r.name


def test_gbps_text_equals_the_reference(rows):
    got, _, (ref, _) = rows
    want = {name: derived for name, _, derived in ref}
    mine = {r.name: r.derived for r in got}
    assert mine["fleet_gbps_x1"] == want["fleet_gbps_x1"]


def test_x1_counters_equal_the_reference(rows):
    """x1 runs the port's job list and geometry (``fleet_jobs``,
    ``ENGINE_KW``); the reference's x1 run, on the same knobs, must give
    the same integer counters."""
    _, results, (_, ref) = rows
    for f in COUNTERS:
        np.testing.assert_array_equal(results[1][f],
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert results[1]["completed"].sum() > 0


@pytest.mark.parametrize("k", [2, 4])
def test_every_rung_equals_x1(rows, k):
    _, results, _ = rows
    one, rung = results[1], results[k]
    for f in COUNTERS:
        np.testing.assert_array_equal(rung[f], one[f], err_msg=f)
    assert one["completed"].sum() > 0
    assert len(rung["ranks"]) == k
    # One gather per tick on every rank, plus three at the end of the run.
    for r in rung["ranks"]:
        assert r["collectives_per_tick"] == (rung["ticks"] + 3) / rung["ticks"]
    assert rung["spawn_s"] >= rung["wall_s"]


def test_ladder_skips_rungs_that_do_not_divide():
    assert fleet.MAX_RANKS == 4
    assert fleet.ladder(128) == [1, 2, 4]
    assert fleet.ladder(12) == [1, 2, 4]
    assert fleet.ladder(6) == [1, 2]
    assert fleet.ladder(3) == [1]
    assert fleet.ladder(1) == [1]


def test_one_rung_ladder_says_so(monkeypatch):
    for k, v in (("BENCH_FLEET_SERVERS", "1"), ("BENCH_FLEET_JOBS", "4"),
                 ("BENCH_FLEET_SECONDS", "0.002")):
        monkeypatch.setenv(k, v)
    got = fleet.run_fleet(device="cpu")
    assert [r.name for r in got] == ["fleet_run_us_per_tick_x1",
                                     "fleet_gbps_x1", "fleet_ladder_truncated"]


def test_reference_file_holds_the_card_phase_rows():
    """``fleet_reference.json`` (what ``chip_smoke.py``'s fleet phase holds
    ``fleet_gbps_x1`` and x1's counters to) was recorded at the full
    geometry and 0.02 s on four devices."""
    doc = json.loads(fleet.REFERENCE_FILE.read_text())
    assert doc["seconds"] == 0.02 and doc["devices"] == 4
    pats = schema_patterns()
    assert all(any(p.match(n) for p in pats) for n in doc["rows"])
    assert doc["rows"]["fleet_gbps_x1"]["derived"].endswith(
        "GB/s aggregate (S=128 J=1024)")
    assert {"fleet_x2_vs_x1", "fleet_x4_vs_x1"} <= set(doc["rows"])
    x1 = doc["x1"]
    assert set(x1) == set(COUNTERS)
    assert len(x1["issued"]) == len(x1["completed"]) == 1024
    assert sum(x1["completed"]) > 0

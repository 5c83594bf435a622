"""The port's Fig. 8 and Fig. 12 rows (``repro_torch.bench``) against the
reference's (``benchmarks/bench_policies.py``, ``bench_comparison.py``) at
0.3 simulated seconds and 2 seeds, on the CPU.

The reference's numbers are taken as ``tools/record_figure_reference.py``
takes them for ``fig_reference.json``: from the ``mean_cov`` calls of its
own row functions.  On the CPU the port's engine equals the reference's
until a pick flips (none at this size), so every row's means and CoVs
agree to float64 rounding of the same per-seed values.

The reference's Fig. 8d table runs every scheduler in the reference's
registry, which a test file of the reference extends (``always-first`` in
``tests/test_scheduler.py``) and which outlives that file in a worker
process; the rows are recorded with the registry pinned to the port's six
schedulers.
"""
import contextlib
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SECONDS, SEEDS = 0.3, (0, 1)


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "record_figure_reference", REPO / "tools" / "record_figure_reference.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@contextlib.contextmanager
def pinned_reference_registry():
    """The reference's scheduler registry restricted to the names the
    port's registry holds (the six shipped schedulers), restored exactly
    afterwards."""
    from repro.core import scheduler as ref_sched
    from repro_torch.core.scheduler import available_schedulers
    saved = dict(ref_sched._REGISTRY)
    ref_sched._REGISTRY.clear()
    ref_sched._REGISTRY.update({n: saved[n] for n in available_schedulers()})
    try:
        yield
    finally:
        ref_sched._REGISTRY.clear()
        ref_sched._REGISTRY.update(saved)


def reference_rows(row_fns) -> dict:
    """``{name: {"derived", "means", "covs"}}`` of the reference's row
    functions ``[(module name in benchmarks, function name)]`` at
    ``SECONDS`` x ``SEEDS``, with the reference's registry pinned."""
    saved = {k: os.environ.get(k) for k in ("BENCH_SECONDS", "BENCH_SEEDS")}
    os.environ["BENCH_SECONDS"] = str(SECONDS)
    os.environ["BENCH_SEEDS"] = str(len(SEEDS))
    sys.path.insert(0, str(REPO))
    try:
        tool = load_tool()
        out = {}
        with pinned_reference_registry():
            for mod_name, fn_name in row_fns:
                mod = importlib.import_module(f"benchmarks.{mod_name}")
                out.update(tool.assign(*tool.record(getattr(mod, fn_name),
                                                    mod)))
        return out
    finally:
        sys.path.remove(str(REPO))
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def rows():
    ref = reference_rows([("bench_policies", "run_fig8"),
                          ("bench_comparison", "run_fig12")])
    from repro_torch.bench import comparison, policies
    port = policies.run_fig8(SECONDS, SEEDS, device="cpu") + \
        comparison.run_fig12(SECONDS, SEEDS, device="cpu")
    return ref, {r.name: r for r in port}


def test_same_rows(rows):
    ref, port = rows
    assert list(port) == list(ref)
    assert any(n.startswith("fig8d_") for n in port)
    assert len([n for n in port if n.startswith("fig12_")]) == 6 * 4 + 5 * 2


def test_rows_ignore_schedulers_registered_by_other_tests(monkeypatch):
    """A scheduler another test file leaves in the reference's registry
    adds no Fig. 8d row, and the registry is restored exactly."""
    from repro.core import scheduler as ref_sched
    from repro_torch.core.scheduler import available_schedulers

    class Dummy(ref_sched.Scheduler):
        pass

    before = dict(ref_sched._REGISTRY)
    monkeypatch.setitem(ref_sched._REGISTRY, "zz-dummy", Dummy())
    after_register = list(ref_sched._REGISTRY.items())
    # The table's row names without its runs: ``sweep`` yields one fake
    # batch per variant, whose metrics ``mean_cov`` reads as (1, 0).
    monkeypatch.syspath_prepend(str(REPO))
    bench_policies = importlib.import_module("benchmarks.bench_policies")
    monkeypatch.setattr(bench_policies, "sweep",
                        lambda variants, seconds, seeds: {
                            s: (None, None, 1.0) for s in variants})
    monkeypatch.setattr(bench_policies, "seed_metric",
                        lambda batch, fn: [1.0])
    ref = reference_rows([("bench_policies", "run_scheduler_table")])
    assert list(ref_sched._REGISTRY.items()) == after_register
    names = [f"fig8d_{s}_{kind}" for s in available_schedulers()
             for kind in ("equal_jobs_ratio", "sustained_gbps")]
    assert list(ref) == names
    assert "zz-dummy" not in before


@pytest.mark.parametrize("prefix", ("fig8a", "fig8b", "fig8c", "fig8d",
                                    "fig12"))
def test_rows_equal_reference(rows, prefix):
    ref, port = rows
    names = [n for n in port if n.startswith(prefix + "_")]
    assert names
    for name in names:
        got, want = port[name], ref[name]
        np.testing.assert_allclose(got.means, want["means"], rtol=1e-6,
                                   atol=1e-9, err_msg=name)
        np.testing.assert_allclose(got.covs, want["covs"], rtol=1e-6,
                                   atol=1e-9, err_msg=name)
        if not name.endswith("_std_mbps"):
            assert got.derived.split(" (")[0] == \
                want["derived"].split(" (")[0], name


def test_reference_file_is_complete():
    """``fig_reference.json`` (what ``chip_smoke.py``'s figures phase holds
    the card to) carries every gated row with its statistics."""
    doc = json.loads((REPO / "src" / "repro_torch" / "bench"
                      / "fig_reference.json").read_text())
    assert doc["seconds"] == 1.0 and doc["seeds"] == list(range(8))
    assert doc["jax"] and "record_figure_reference.py" in doc["command"]
    for name, row in doc["rows"].items():
        assert len(row["means"]) >= 1, name
        if "_vs_" not in name or name.startswith("fig8c"):
            assert len(row["covs"]) == len(row["means"]), name

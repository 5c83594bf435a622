"""The port's Fig. 8 and Fig. 12 rows (``repro_torch.bench``) against the
reference's (``benchmarks/bench_policies.py``, ``bench_comparison.py``) at
0.3 simulated seconds and 2 seeds, on the CPU.

The reference's numbers are taken as ``tools/record_figure_reference.py``
takes them for ``fig_reference.json``: from the ``mean_cov`` calls of its
own row functions.  On the CPU the port's engine equals the reference's
until a pick flips (none at this size), so every row's means and CoVs
agree to float64 rounding of the same per-seed values.
"""
import importlib.util
import json
import pathlib

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


@pytest.fixture(scope="module")
def rows():
    import os
    import sys
    saved = {k: os.environ.get(k) for k in ("BENCH_SECONDS", "BENCH_SEEDS")}
    os.environ["BENCH_SECONDS"] = str(SECONDS)
    os.environ["BENCH_SEEDS"] = str(len(SEEDS))
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks import bench_comparison, bench_policies
        tool = load_tool()
        ref = {**tool.assign(*tool.record(bench_policies.run_fig8,
                                          bench_policies)),
               **tool.assign(*tool.record(bench_comparison.run_fig12,
                                          bench_comparison))}
    finally:
        sys.path.remove(str(REPO))
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    from repro_torch.bench import comparison, policies
    port = policies.run_fig8(SECONDS, SEEDS, device="cpu") + \
        comparison.run_fig12(SECONDS, SEEDS, device="cpu")
    return ref, {r.name: r for r in port}


def test_same_rows(rows):
    ref, port = rows
    assert list(port) == list(ref)
    assert any(n.startswith("fig8d_") for n in port)
    assert len([n for n in port if n.startswith("fig12_")]) == 6 * 4 + 5 * 2


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
    assert doc["seconds"] == 2.0 and doc["seeds"] == list(range(8))
    assert doc["jax"] and "record_figure_reference.py" in doc["command"]
    for name, row in doc["rows"].items():
        assert len(row["means"]) >= 1, name
        if "_vs_" not in name or name.startswith("fig8c"):
            assert len(row["covs"]) == len(row["means"]), name

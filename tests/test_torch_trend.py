"""The port's copy of the trend tool (``repro_torch.bench.trend``) against
the reference's ``benchmarks/trend.py``.

Every case of the reference's ``tests/test_trend.py`` runs again with the
port's module in its place, and a sequence of ingests (a first artifact, a
second that regresses, one that passes the gate, a ``--no-gate`` ingest
and one from a workspace store) gives the same tables, gate verdicts,
exit codes and history files, byte for byte, with either module.
"""
import contextlib
import importlib.util
import inspect
import io
import json
import pathlib

import pytest

from benchmarks import trend as ref_trend
from repro_torch.bench import trend as port_trend

REPO = pathlib.Path(__file__).resolve().parent.parent


def _reference_cases():
    spec = importlib.util.spec_from_file_location(
        "reference_trend_cases", REPO / "tests" / "test_trend.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cases = []
    for cls in (mod.TestExtraction, mod.TestGate, mod.TestCli):
        for name, fn in inspect.getmembers(cls, inspect.isfunction):
            if name.startswith("test_"):
                cases.append((cls, name))
    return mod, cases


CASES_MOD, CASES = _reference_cases()


@pytest.mark.parametrize("cls,name", CASES,
                         ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_reference_case_on_the_port(cls, name, monkeypatch, tmp_path,
                                    capsys):
    monkeypatch.setattr(CASES_MOD, "trend", port_trend)
    method = getattr(cls(), name)
    kw = {p: {"tmp_path": tmp_path, "capsys": capsys}[p]
          for p in inspect.signature(method).parameters}
    method(**kw)


def _ingest_sequence(module, root: pathlib.Path) -> list:
    """Run the trend CLI of ``module`` over a fixed sequence of ingests in
    ``root``; -> [(exit code, stdout, stderr, history bytes)] per step."""
    art = CASES_MOD.artifact
    root.mkdir(parents=True)
    hist = root / "BENCH_TREND.json"
    steps = [
        ([art(22.0)], ["--label", "one"]),
        ([art(21.5, sched="gift", phash="0123456789ab")], ["--label", "two"]),
        ([art(5.0)], ["--label", "three"]),
        ([art(21.0), art(20.0, seconds="full")], ["--label", "four"]),
        ([art(1.0)], ["--label", "five", "--no-gate"]),
        ([art(30.0)], ["--label", "six", "--gate", "5"]),
    ]
    out = []
    for k, (docs, flags) in enumerate(steps):
        paths = []
        for i, doc in enumerate(docs):
            p = root / f"BENCH_{k}_{i}.json"
            p.write_text(json.dumps(doc))
            paths.append(str(p))
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = module.main(paths + ["--history", str(hist)] + flags)
        se_text = se.getvalue().replace(str(root), "<root>")
        out.append((rc, so.getvalue(), se_text, hist.read_bytes()))
    return out


def test_same_tables_verdicts_and_histories(tmp_path):
    theirs = _ingest_sequence(ref_trend, tmp_path / "reference")
    ours = _ingest_sequence(port_trend, tmp_path / "port")
    assert [s[0] for s in ours] == [0, 0, 1, 0, 0, 0]
    for k, (a, b) in enumerate(zip(ours, theirs)):
        assert a[0] == b[0], f"step {k}: exit code"
        assert a[1] == b[1], f"step {k}: table"
        assert a[2] == b[2], f"step {k}: messages"
        assert a[3] == b[3], f"step {k}: history file"


def test_workspace_ingest_matches_the_reference(tmp_path):
    """Rows recorded by ``repro_torch.bench.run --workspace``'s recorder
    ingest through either trend module to the same points."""
    from repro_torch.bench import run
    doc = CASES_MOD.artifact(22.0)
    ws = tmp_path / "ws"
    assert run.record_to_workspace(str(ws), doc["sections"]) == 3
    ours = port_trend.workspace_points(str(ws), "x")
    theirs = ref_trend.workspace_points(str(ws), "x")
    assert ours == theirs and len(ours) == 3
    assert {p["params_hash"] for p in ours} == {"abc123def456"}

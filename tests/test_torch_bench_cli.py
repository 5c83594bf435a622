"""The port's benchmark harness, ``python -m repro_torch.bench.run``, on
the CPU: the reference's eleven sections and row schemas (``--list``), the
``--json`` document with each section's ``runs`` block (written
atomically), ``--workspace`` records, and the refusal of an unknown
section."""
import json
import os

import pytest

from benchmarks import run as ref_run
from repro_torch.bench import composite, run
from repro_torch.workspace import WorkspaceStore


@pytest.fixture(autouse=True)
def short_timing(monkeypatch):
    monkeypatch.setenv("BENCH_KERN_ITERS", "1")


def test_list_prints_the_reference_sections_and_schemas(capsys):
    assert list(run.SECTIONS) == list(ref_run.SECTIONS)
    assert run.ROW_SCHEMAS == ref_run.ROW_SCHEMAS
    assert run.main(["--list"]) == 0
    out = capsys.readouterr().out.splitlines()
    heads = [line.split(":")[0] for line in out if not line.startswith(" ")]
    assert heads == list(ref_run.SECTIONS) and len(heads) == 11
    for name, patterns in ref_run.ROW_SCHEMAS.items():
        block = out[out.index(next(l for l in out
                                   if l.startswith(name + ":"))) + 1:]
        assert [l.strip() for l in block[:len(patterns)]] == patterns


def test_json_document_with_rows_runs_and_env(tmp_path, monkeypatch,
                                              capsys):
    """kern and micro as the CLI runs them, plus fig9 at a small depth so
    that a section's ``runs`` block holds its simulations."""
    monkeypatch.setitem(run.SECTIONS, "fig9", lambda device: (
        composite.run_fig9_11(device=device, scale=1 / 400)))
    path = tmp_path / "BENCH_cli.json"
    assert run.main(["kern", "micro", "fig9", "--json", str(path),
                     "--device", "cpu"]) == 0
    csv = capsys.readouterr().out.splitlines()
    assert csv[0] == "name,us_per_call,derived"
    doc = json.loads(path.read_text())
    assert os.listdir(tmp_path) == ["BENCH_cli.json"]     # no temp file left
    assert list(doc["sections"]) == ["kern", "micro", "fig9"]
    assert doc["env"]["BENCH_KERN_ITERS"] == "1" and "torch" in doc["env"]
    kern = doc["sections"]["kern"]
    assert [r["name"] for r in kern["rows"]][:4] == [
        "kern_tick_ref_j16", "kern_tick_fused_j16", "kern_tick_speedup_j16",
        "kern_tick_budget_us_j16"]
    assert kern["runs"] == [] and doc["sections"]["micro"]["runs"] == []
    runs = doc["sections"]["fig9"]["runs"]
    assert [r["scheduler"] for r in runs] == ["themis", "themis"]
    assert [r["policy"] for r in runs] == ["user-then-size-fair",
                                           "group-user-size-fair"]
    assert all(len(r["issued"]) == 8 and r["seconds"] == 0.1 for r in runs)
    assert len(csv) == 1 + sum(len(s["rows"])
                               for s in doc["sections"].values())


def test_workspace_records_every_row(tmp_path):
    ws = tmp_path / "ws"
    assert run.main(["micro", "--workspace", str(ws), "--device", "cpu"]) == 0
    names = sorted(r.key.name for r in
                   WorkspaceStore(str(ws)).query(section="bench"))
    assert names == ["micro/micro_policy_chain_3level_32slots",
                     "micro/micro_token_select_8srv_x8workers"]


def test_unknown_section_is_refused():
    with pytest.raises(SystemExit, match="unknown section"):
        run.main(["bogus", "--device", "cpu"])

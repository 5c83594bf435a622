"""The port's workspace (``repro_torch.workspace``) against the reference's
(``repro.workspace``): the same hashes, keys and bytes on disk for the same
inputs, directories read across the two packages, the buffer's discard and
conflict rules, a sweep interrupted and resumed through ``max_chunks``, and
the cached ``solo``, all on the CPU.
"""
import os

import numpy as np
import pytest

import repro.workspace as ref_ws
from repro.api import Experiment as RefExperiment
from repro_torch import workspace as ws
from repro_torch.api import Experiment
from repro_torch.core.params import AdaptbfParams

JOBS = [dict(user=0, size=1, procs=6, req_mb=10, end_s=0.05),
        dict(user=1, size=1, procs=6, req_mb=10, end_s=0.05)]
GRID = {"repay": [0.1, 0.5], "burst_s": [0.5, 1.0]}
SECONDS, SEEDS = 0.05, (0, 1)


def make(mod, **kw):
    exp_cls = Experiment if mod == "port" else RefExperiment
    return exp_cls(policy="job-fair", scheduler="adaptbf", n_workers=2,
                   **kw).add_jobs([dict(j) for j in JOBS])


def payload():
    rng = np.random.default_rng(3)
    return {"gbps": (rng.standard_normal((3, 5)) * 1e-7).astype(np.float32),
            "issued": rng.integers(0, 2 ** 31 - 1, (4,), dtype=np.int32),
            "nested": {"v": [np.float64(np.pi), np.float32(-0.0), "x", None]},
            "seeds": [0, 1]}


def key(i=0, **kw):
    return ws.RunKey(section="run", name=f"k{i}", scheduler="themis",
                     params_hash="p", scenario_hash="s",
                     env=ws.env_fingerprint(), **kw)


def tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def write_store(mod, root):
    """One loose record and a two-record journal through ``mod``."""
    store = mod.WorkspaceStore(root)
    rk = lambda i: mod.RunKey(**key(i).to_dict())   # noqa: E731
    store.put(mod.RunRecord(key=rk(0), payload=payload()))
    with store.buffered("camp") as buf:
        for i in (1, 2):
            buf.put(mod.RunRecord(key=rk(i), payload={"i": i, **payload()}))
    return store


def test_hashes_and_codec_equal_reference(monkeypatch):
    monkeypatch.setenv("BENCH_SECONDS", "2")
    monkeypatch.setenv("BENCH_ZETA", "7")
    assert ws.env_fingerprint() == ref_ws.env_fingerprint()
    doc = {"b": [1, 2.5, None], "a": {"z": "q"}}
    assert ws.canonical_json(doc) == ref_ws.canonical_json(doc)
    assert ws.content_hash(doc) == ref_ws.content_hash(doc)
    enc = ws.encode_payload(payload())
    assert ws.canonical_json(enc) == ref_ws.canonical_json(
        ref_ws.encode_payload(payload()))
    back = ws.decode_payload(enc)
    assert back["gbps"].tobytes() == payload()["gbps"].tobytes()
    assert back["gbps"].dtype == np.float32
    assert key(5).key_hash == ref_ws.RunKey(**key(5).to_dict()).key_hash


def test_store_bytes_equal_reference(tmp_path):
    write_store(ws, tmp_path / "port")
    write_store(ref_ws, tmp_path / "ref")
    port, ref = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "ref")
    assert sorted(port) == sorted(ref) and len(port) == 3
    assert port == ref


@pytest.mark.parametrize("writer,reader", [(ref_ws, ws), (ws, ref_ws)],
                         ids=["ref-to-port", "port-to-ref"])
def test_directory_reads_across_packages(tmp_path, writer, reader):
    write_store(writer, tmp_path)
    store = reader.WorkspaceStore(tmp_path)
    assert len(store) == 3 and store.campaigns() == {"camp": 2}
    rec = store.get(reader.RunKey(**key(2).to_dict()))
    assert rec.payload["i"] == 2
    assert rec.payload["gbps"].tobytes() == payload()["gbps"].tobytes()


def test_buffer_discards_on_exception_and_detects_conflicts(tmp_path):
    store = ws.WorkspaceStore(tmp_path)
    with pytest.raises(ZeroDivisionError):
        with store.buffered("c") as buf:
            buf.put(ws.RunRecord(key=key(1), payload={"v": 1}))
            assert buf.get(key(1)) is not None        # read-your-writes
            1 / 0
    assert key(1) not in store and store.io_writes == 0
    with pytest.raises(RuntimeError, match="outside its context"):
        ws.WriteBuffer(store, "c").put(ws.RunRecord(key=key(1), payload={}))
    with pytest.raises(ws.WorkspaceConflictError):
        with store.buffered("c") as buf:
            buf.put(ws.RunRecord(key=key(2), payload={"v": 2}))
            other = ws.WorkspaceStore(tmp_path)
            other.journal_append("c", [ws.RunRecord(key=key(3),
                                                    payload={"v": 3})])
    assert key(2) not in ws.WorkspaceStore(tmp_path)


def test_torn_journal_tail_is_skipped(tmp_path, capsys):
    store = write_store(ws, tmp_path)
    path = store.journal_path("camp")
    path.write_text(path.read_text() + '{"key": {"section": "ru')
    again = ws.WorkspaceStore(tmp_path)
    assert len(again) == 3
    assert "torn final line" in capsys.readouterr().err
    assert again.gc() == {"tmp_removed": 0, "journal_lines_dropped": 0}


def test_spec_hash_and_keys_equal_reference():
    port, ref = make("port", device="cpu"), make("ref")
    sh = ws.spec_hash(port, SECONDS, SEEDS)
    assert sh == ref_ws.spec_hash(ref, SECONDS, SEEDS)
    from repro.workspace.campaign import point_key as ref_point_key
    from repro_torch.workspace.campaign import point_key
    for p_port, p_ref in zip(port._expand_grid(GRID), ref._expand_grid(GRID)):
        assert point_key("c", port, p_port, sh).key_hash == \
            ref_point_key("c", ref, p_ref, sh).key_hash
    # The device is not part of the key: a CPU record serves the card.
    assert ws.spec_hash(make("port", device="cuda"), SECONDS, SEEDS) == sh
    assert ws.spec_hash(port, SECONDS, (0,)) != sh


def test_sweep_interrupt_resume_and_reuse(tmp_path):
    """chunk=2, max_chunks=1 stops after 2 of 4 points; the resume computes
    exactly the other 2; a third run reuses all 4; the merge equals the
    plain sweep bit for bit."""
    plain = make("port", device="cpu").sweep(GRID, SECONDS, seeds=SEEDS)
    store = ws.WorkspaceStore(tmp_path)
    with pytest.raises(ws.CampaignInterrupted) as stop:
        ws.run_sweep(make("port", device="cpu"), GRID, SECONDS, seeds=SEEDS,
                     store=store, campaign="doc", chunk=2, max_chunks=1)
    assert (stop.value.report["computed"], stop.value.report["reused"]) == \
        (2, 0)
    seen = []
    res, rep = ws.run_sweep(make("port", device="cpu"), GRID, SECONDS,
                            seeds=SEEDS, store=ws.WorkspaceStore(tmp_path),
                            campaign="doc", chunk=2,
                            progress=lambda i, n: seen.append((i, n)))
    assert (rep["reused"], rep["computed"], rep["io_writes"]) == (2, 2, 1)
    assert seen == [(0, 1)]
    again, rep = ws.run_sweep(make("port", device="cpu"), GRID, SECONDS,
                              seeds=SEEDS, store=ws.WorkspaceStore(tmp_path),
                              campaign="doc")
    assert (rep["reused"], rep["computed"]) == (4, 0)
    for out in (res, again):
        for f in ("gbps", "issued", "completed", "dropped",
                  "idle_worker_ticks"):
            np.testing.assert_array_equal(getattr(out, f),
                                          getattr(plain, f), err_msg=f)
        assert [p.params_hash() for p in out.points] == \
            [p.params_hash() for p in plain.points]
    assert isinstance(again.points[0], AdaptbfParams)


def test_reference_campaign_is_reused_by_the_port(tmp_path):
    """Points the reference recorded are the port's: the port reuses all of
    them, computing nothing, and reads back the reference's arrays."""
    ref_res, _ = ref_ws.run_sweep(make("ref"), GRID, SECONDS, seeds=SEEDS,
                                  store=ref_ws.WorkspaceStore(tmp_path),
                                  campaign="x")
    got, rep = ws.run_sweep(make("port", device="cpu"), GRID, SECONDS,
                            seeds=SEEDS, store=ws.WorkspaceStore(tmp_path),
                            campaign="x")
    assert (rep["reused"], rep["computed"]) == (4, 0)
    np.testing.assert_array_equal(got.gbps, np.asarray(ref_res.gbps))
    np.testing.assert_array_equal(got.completed,
                                  np.asarray(ref_res.completed))


def test_solo_workspace_cache_hit(tmp_path, monkeypatch):
    exp = (Experiment(policy="job-fair", scheduler="themis", n_workers=2,
                      device="cpu")
           .add_jobs([dict(j) for j in JOBS]))
    first = exp.solo(1, SECONDS, workspace=str(tmp_path), name="base")
    runs = []
    inner = Experiment.run
    monkeypatch.setattr(Experiment, "run",
                        lambda self, s: runs.append(s) or inner(self, s))
    hit = exp.solo(1, SECONDS, workspace=ws.WorkspaceStore(tmp_path),
                   name="base")
    assert runs == []
    for f in ("gbps", "issued", "completed", "dropped", "idle_worker_ticks",
              "ticks", "bin_s"):
        np.testing.assert_array_equal(getattr(hit, f), getattr(first, f))
    assert hit.params_hash() == first.params_hash() and hit.state is None
    exp.solo(1, SECONDS * 2, workspace=str(tmp_path), name="base")
    assert runs == [SECONDS * 2]          # another horizon: another key

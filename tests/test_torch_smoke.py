"""The checks of ``chip_smoke.py`` that run without a card, on the CPU.

The lockstep harness of its ``card_vs_cpu`` phase, the way it names the
pick that made a card tick differ from the CPU's, the bytes and (q, k)
pairs its kernel bounds count, its greedy-token check, and its serving
phases rehearsed at the reduced config.  The phases themselves run on the
card (``python3 chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
import importlib.util
from pathlib import Path

import pytest
import torch

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.mark.parametrize("impl", ("fused", "scan"))
@pytest.mark.parametrize("scheduler", ("fifo", "themis"))
def test_lockstep_cpu_against_cpu_never_differs(scheduler, impl):
    from repro_torch.core import engine, tokens
    saved = engine.tick_step, tokens.token_select
    a, b = smoke.lockstep(scheduler, impl, "cpu", 80)
    assert a.t == b.t == 80 and int(b.completed.sum()) > 0
    assert smoke.int_leaves_equal(a, b) is None
    assert (engine.tick_step, tokens.token_select) == saved   # unpatched


def test_lockstep_takes_a_phased_preset():
    """``make=`` steps any Experiment: a phased preset, CPU against CPU."""
    from repro_torch.api import Experiment
    from repro_torch.scenario import PRESET_SECONDS, Scenario, preset, scale
    tree = scale(preset("bursty-interferer").tree, time=0.1 / PRESET_SECONDS)

    def make(dev):
        return Experiment.from_scenario(
            Scenario(tree=tree), policy="job-fair", scheduler="themis",
            n_workers=2, device=dev)

    a, b = smoke.lockstep("themis", "fused", "cpu", 100, make=make)
    assert a.t == b.t == 100
    assert int(b.completed[:, 1].sum()) > 0
    assert smoke.int_leaves_equal(a, b) is None


def draw_call(shares, qcount, u, picks):
    return ("token_select", [shares, qcount, u],
            [torch.tensor(picks, dtype=torch.int32)], "themis")


def test_explain_divergence_names_the_edge_band_pick():
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    u = torch.tensor([[0.5]])
    cpu = draw_call(torch.tensor([[0.5, 0.5]]), qcount, u, [[1]])
    card = draw_call(torch.tensor([[0.5, 0.5000001]]), qcount, u, [[0]])
    agree = draw_call(torch.tensor([[0.5, 0.5]]), qcount, u, [[1]])
    why = smoke.explain_divergence([agree, card], [agree, cpu])
    assert why.startswith("token_select themis: row 0, draw 0: got 0")


def test_explain_divergence_refuses_other_faults():
    qcount = torch.tensor([[1, 1]], dtype=torch.int32)
    shares = torch.tensor([[0.5, 0.5]])
    cpu = draw_call(shares, qcount, torch.tensor([[0.1]]), [[0]])
    with pytest.raises(AssertionError, match="outside the edge band"):
        smoke.explain_divergence(
            [draw_call(shares, qcount, torch.tensor([[0.1]]), [[1]])], [cpu])
    with pytest.raises(AssertionError, match="inputs differ"):
        smoke.explain_divergence(
            [draw_call(shares, qcount, torch.tensor([[0.2]]), [[0]])], [cpu])
    with pytest.raises(AssertionError, match="shares differ"):
        smoke.explain_divergence(
            [draw_call(torch.tensor([[0.6, 0.4]]), qcount,
                       torch.tensor([[0.1]]), [[0]])], [cpu])
    with pytest.raises(AssertionError, match="every kernel call agreed"):
        smoke.explain_divergence([cpu], [cpu])


def test_needed_bytes_count_only_what_each_mode_reads():
    s, j, w = 2, 4, 3
    qcount = torch.tensor([[0, 2, 1, 0], [5, 0, 0, 0]], dtype=torch.int32)
    u = torch.zeros(s, w)
    out = s * w * 6 + s * j * 8
    # themis: qcount, the shares of the 3 demanded slots, free and u.
    assert smoke.needed_bytes("tick_step", qcount, u) \
        == s * j * 4 + 3 * 4 + s * w * 5 + out
    # fifo: qcount, free and the stamps min(pops + 1, qcount) per slot.
    pops = torch.tensor([[0, 2, 0, 0], [1, 0, 0, 0]], dtype=torch.int32)
    assert smoke.needed_bytes("tick_step", qcount, u, mode="fifo", pops=pops) \
        == s * j * 4 + (2 + 1 + 2) * 4 + s * w + out
    assert smoke.needed_bytes("token_select", qcount, u) \
        == s * j * 4 + 3 * 4 + 2 * s * w * 4



@pytest.mark.parametrize("sq,sk,causal,window,q_offset", [
    (50, 50, True, 0, 0), (50, 50, True, 16, 0), (20, 70, True, 8, 50),
    (20, 30, False, 0, 0), (30, 30, False, 5, 0), (10, 40, True, 0, 45)])
def test_live_pairs_counts_the_mask(sq, sk, causal, window, q_offset):
    rel = (torch.arange(sq)[:, None] + q_offset) - torch.arange(sk)[None, :]
    ok = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        ok &= rel >= 0
    if window:
        ok &= rel < window
    assert smoke.live_pairs(sq, sk, causal, window, q_offset) == int(ok.sum())


def test_check_argmax_excuses_only_close_calls():
    want = torch.tensor([[[3.0, 2.99, 0.0]], [[5.0, 1.0, 0.0]]])
    close = torch.tensor([[[2.99, 3.0, 0.0]], [[5.0, 1.0, 0.0]]])
    assert smoke.check_argmax("t", want, close, 3, atol=0.01) == 1
    far = torch.tensor([[[3.0, 2.99, 0.0]], [[1.0, 5.0, 0.0]]])
    with pytest.raises(AssertionError, match="greedy tokens differ"):
        smoke.check_argmax("t", want, far, 3, atol=0.01)


def test_serve_phases_rehearse_on_the_cpu(monkeypatch):
    """The serving phases at the reduced config on the CPU: the plain flash
    version (no launch), the same admissions as the CPU engine, and the
    card-vs-CPU comparison run against itself."""
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps=1: (fn(), 1.0)[1])
    _, launches, layer0, metrics = smoke.phase_serve(
        "cpu", reduced=True, seq=600, steps=8)
    assert launches == {"flash_attention": 0, "mamba2_ssd": 0, "wkv6": 0,
                        "step_decay": 0}
    assert set(layer0) == {"flash_attention"}
    assert layer0["flash_attention"]["args"][0].shape == (2, 600, 8, 16)
    assert metrics["prefill_vs_decode_max_abs"] < 1e-4
    draws, rps = smoke.phase_serve_engine("cpu", reduced=True)
    assert draws == 0 and rps > 0
    record = smoke.phase_flash(
        "cpu", layer0["flash_attention"],
        cases=[(1, 70, 70, 8, 2, 80, 16, True, 0, 0),
               (1, 36, 100, 4, 2, 18, 32, True, 64, 2)])
    assert record["max_abs_err"] == 0.0 and record["bound_by"] == "operations"
    smoke.phase_serve_card_vs_cpu("cpu", reduced=True, seq=600, steps=2)


@pytest.mark.parametrize("arch,kernel", [("zamba2-2.7b", "mamba2_ssd"),
                                         ("rwkv6-7b", "wkv6")])
def test_recurrent_serve_phases_rehearse_on_the_cpu(monkeypatch, arch,
                                                    kernel):
    """serve_zamba2 / serve_rwkv6 at the reduced config on the CPU (the
    plain scans, no launch; 600 tokens, not a multiple of either chunk),
    the scan phase on the inputs they recorded with a short case list, and
    zamba2's ServeEngine against its CPU self and its step_decay phase."""
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps=1: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "MAMBA2_CASES", smoke.MAMBA2_CASES[:1]
                        + smoke.MAMBA2_CASES[-1:])
    monkeypatch.setattr(smoke, "WKV6_CASES", smoke.WKV6_CASES[:1])
    _, launches, layer0, metrics = smoke.phase_serve(
        "cpu", arch, tag=f"serve_{arch}", reduced=True, seq=600, steps=8)
    assert launches == {"flash_attention": 0, "mamba2_ssd": 0, "wkv6": 0,
                        "step_decay": 0}
    assert kernel in layer0
    assert ("flash_attention" in layer0) == (arch == "zamba2-2.7b")
    assert ("step_and_decay" in layer0) == (arch == "zamba2-2.7b")
    assert metrics["prefill_vs_decode_max_abs"] < 1e-4
    if arch == "zamba2-2.7b":
        draws, _ = smoke.phase_serve_engine("cpu", arch=arch, reduced=True)
        assert draws == 0
    record = smoke.phase_scan("cpu", kernel, layer0[kernel])
    assert record["max_abs_err"] == 0.0 and record["library_ms"] is None
    assert record["bound_by"] == "operations"
    if arch == "zamba2-2.7b":
        record = smoke.phase_step_decay("cpu", layer0["step_and_decay"])
        assert record["max_abs_err"] == 0.0 and record["library_ms"] is None
        assert record["bound_by"] == "bytes"


def test_scan_bounds_and_counts():
    """Per-prefill launches from the pattern; the scans' work counts at the
    serving shapes and the pipe that bounds each."""
    from repro_torch.configs.base import get_config
    assert smoke.launches_per_prefill(get_config("zamba2-2.7b")) == {
        "flash_attention": 9, "mamba2_ssd": 54, "wkv6": 0}
    assert smoke.launches_per_prefill(get_config("rwkv6-7b")) == {
        "flash_attention": 0, "mamba2_ssd": 0, "wkv6": 32}
    assert smoke.launches_per_prefill(get_config("h2o-danube-1.8b")) == {
        "flash_attention": 24, "mamba2_ssd": 0, "wkv6": 0}
    # attn_moe's attention, MLA's folded heads past 512 tokens, musicgen's
    # attn; a cross block none (dense over the vision tokens).
    for arch, n in (("qwen3-moe-30b-a3b", 48), ("mixtral-8x7b", 32),
                    ("minicpm3-4b", 62), ("llama-3.2-vision-11b", 32),
                    ("musicgen-medium", 48), ("gemma3-4b", 34)):
        assert smoke.launches_per_prefill(get_config(arch)) == {
            "flash_attention": n, "mamba2_ssd": 0, "wkv6": 0}, arch
    cfg = get_config("minicpm3-4b")
    assert smoke.launches_per_prefill(cfg, 512)["flash_attention"] == 0
    assert smoke.launches_per_prefill(cfg, 513)["flash_attention"] == 62
    cfg = get_config("llama-3.2-vision-11b")
    assert smoke.launches_per_prefill(cfg, 512)["flash_attention"] == 0
    assert smoke.launches_per_prefill(cfg, 513)["flash_attention"] == 32
    x = torch.empty(2, 6144, 80, 64, device="meta")
    b = torch.empty(2, 6144, 64, dtype=torch.bfloat16, device="meta")
    nbytes, ops, exps = smoke.mamba2_work(x, b, 128)
    assert nbytes == 2 * x.numel() * 4 + 2 * 6144 * 80 * 4 \
        + 2 * 2 * 6144 * 64 * 2 + 2 * 80 * 64 * 64 * 4
    assert smoke.pipe_bound(nbytes, ops, exps)[1:] == ("operations", "FMA")
    r = torch.empty(2, 6016, 64, 64, dtype=torch.bfloat16, device="meta")
    nbytes, ops, exps = smoke.wkv6_work(r, 64)
    assert exps == 2 * 94 * 64 * (64 * 63 // 2 * 64 + 2 * 64 * 64 + 64)
    assert smoke.pipe_bound(nbytes, ops, exps)[1:] == ("operations", "SFU")
    # danube's flash shape: 1.04 G exponentials on the SFUs (0.248 ms) stay
    # under the tensor cores' 0.335 ms.
    pairs = smoke.live_pairs(6000, 6000, True, 4096, 0) * 2 * 32
    bound, by, pipe = smoke.pipe_bound(154e6, 4 * 80 * pairs, pairs,
                                       smoke.BF16_OPS_PER_S, "tensor cores")
    assert (by, pipe) == ("operations", "tensor cores")
    assert bound == pytest.approx(0.335, abs=1e-3)
    assert pairs / smoke.SFU_OPS_PER_S * 1e3 == pytest.approx(0.248, abs=1e-3)
    assert smoke.prefix_tol(torch.tensor([-1.0, -3.0])) == 2e-5
    assert smoke.prefix_tol(torch.tensor([-2000.0])) == \
        pytest.approx(4 * 2000 * 2.0 ** -24)


def test_wkv6_bwd_work_and_train_counts():
    """The WKV backward's work at rwkv6's training layer 0 (0.94 GB, 32.6
    GFLOP on the FMA pipes, 1.12 G exponentials: the FMA pipes bound it)
    and the launches scan_train_launches expects of rwkv6 cut to
    train_rwkv6's 10 layers under remat "block" for 3 steps: 2 wkv6 and 1
    wkv6_bwd a layer a step, each backward pass once; none of the SSD's."""
    import dataclasses
    from repro_torch.configs.base import get_config
    r = torch.empty(2, 4096, 64, 64, dtype=torch.bfloat16, device="meta")
    nbytes, ops, exps = smoke.wkv6_bwd_work(r, 64)
    n = r.numel()
    assert nbytes == 6 * n * 2 + 3 * n * 4 + 2 * 2 * 64 * 64 * 64 * 4 \
        + 2 * 64 * 64 * 64 * 64 * 4 + 64 * 64 * 4
    assert exps == 2 * 64 * 64 * (2016 * 64 + 2 * 64 * 64 + 64)
    assert ops == 32581353472
    bound, by, pipe = smoke.pipe_bound(nbytes, ops, exps)
    assert (by, pipe) == ("operations", "FMA")
    assert bound == pytest.approx(0.4863, abs=1e-4)
    cfg = dataclasses.replace(get_config("rwkv6-7b"), **smoke.RWKV6_TRAIN_CUT)
    want = smoke.scan_train_launches(cfg, steps=3)
    assert {k: v for k, v in want.items() if v} == {
        "wkv6": 60, "wkv6_bwd": 30, "wkv6_bwd chunk_dstate": 30,
        "wkv6_bwd state_pass_bwd": 30, "wkv6_bwd chunk_bwd": 30,
        "wkv6_bwd sum_du": 30}
    smoke.zero_scan_counts()
    assert set(smoke.scan_counts()) == set(want)
    assert not any(smoke.scan_counts().values())


def test_rwkv6_train_phases_rehearse_on_the_cpu(monkeypatch):
    """train_rwkv6 at the reduced config cut to 2 layers on the CPU (the
    plain scans, no launch; the cut reaches the config launch.train
    builds), its layer-0 backward inputs captured, and the wkv6_bwd phase
    on them with two cases (the plain version against itself)."""
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps=1: (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _, _, layer0, metrics = smoke.phase_train(
        "cpu", arch="rwkv6-7b", full=False, tag="train_rwkv6",
        cut=dict(n_layers=2, pattern=((2, ("rwkv",)),)), seq=128, batch=2,
        steps=2)
    assert metrics["layers"] == 2 and set(layer0) == {"wkv6_bwd"}
    assert layer0["wkv6_bwd"]["args"][0].shape == (2, 128, 4, 32)
    record = smoke.phase_wkv6_bwd("cpu", layer0["wkv6_bwd"],
                                  cases=[smoke.WKV6_BWD_CASES[1],
                                         smoke.WKV6_BWD_CASES[-1]])
    assert record["max_abs_err"] == 0.0 and record["library_ms"] is None
    assert set(record["pass_ms"]) == {"chunk_dstate", "state_pass_bwd",
                                      "chunk_bwd + sum_du"}


def test_block_phases_rehearse_on_the_cpu(monkeypatch):
    """serve_blocks and blocks_card_vs_cpu at the reduced width on the CPU
    (no launch; 600 tokens, past block_q and MLA's 512): every arch of
    SERVE_BLOCKS served, both MoE dispatches on layer 0's input, flash at
    the three timed shapes, and the card-vs-CPU comparison against
    itself."""
    monkeypatch.setattr(smoke, "time_ms", lambda fn, reps=1: (fn(), 1.0)[1])
    flash, metrics, shapes = smoke.phase_serve_blocks(
        "cpu", reduced=True, seq=600, steps=8)
    assert flash == 0 and set(metrics) == set(smoke.SERVE_BLOCKS)
    assert set(shapes) == set(smoke.FLASH_SHAPES)
    assert all(r["max_abs_err"] == 0.0 for r in shapes.values())
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        assert set(metrics[arch]["dispatch_ms"]) == {"dense_onehot",
                                                     "ragged_sort"}
    assert metrics["qwen3-moe-30b-a3b"]["dropped_layer0"] > 0
    assert all(m["prefill_vs_decode_max_abs"] < 1e-4
               for m in metrics.values())
    assert all(v == 0.0 for v in smoke.phase_blocks_card_vs_cpu(
        "cpu", reduced=True, seq=600, steps=2).values())


def test_moe_excused_names_drops_and_flips():
    """A row is excused where the prefill of the prompt plus k tokens keeps
    one of its prompt tokens otherwise than the prompt's prefill, drops an
    assignment of a generated token, or routes one otherwise than its
    decode step; the other rows are held.  A flip before any such event in
    its row is excused only at a near tie (top-k margin under twice the
    router-score gap, the gap within the tolerance), else it raises; a flip
    after one is its consequence."""
    import dataclasses
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                              moe_capacity_factor=0.5)
    # 2 rows, top-2 of 4 experts, every token to experts 0 and 1, capacity
    # max(T / 4, 32) = 32 for the prompt's prefill (2 x 20 tokens) and the
    # prefill + 1 (2 x 21): row 1 keeps 12 prompt tokens in the first, 11
    # and not its generated token in the second.
    def routing(rows, scores):
        z = torch.tensor([scores] * rows)
        return torch.topk(z, 2).indices.to(torch.int32), z

    plain = [2.0, 1.0, 0.0, -1.0]
    base = [routing(40, plain)] * 2
    pf = [routing(42, plain), routing(42, plain)]
    dec = [[routing(2, plain)] * 2]
    why = smoke.moe_excused(cfg, base, pf, dec, 2, 0.01)
    assert list(why) == [1]
    assert "1 prompt token(s) kept otherwise" in why[1][0]
    assert "generated token 0 lost 2" in why[1][0]
    assert smoke.dropped(cfg, pf) == 2 * 2 * (42 - 32)
    # Row 0's generated token (stream row 20) at layer 0: a near tie of
    # experts 0 and 3 at a margin of 0.001 and a gap of 0.001.
    tie = [1.0, 2.0, -1.0, 0.999]
    dec = [[routing(2, tie), routing(2, plain)]]
    idx, z = routing(42, plain)
    idx[20], z[20] = torch.tensor([1, 3]), torch.tensor([0.9995, 2, -1, 1])
    why = smoke.moe_excused(cfg, base, [(idx, z), pf[1]], dec, 2, 0.01)
    assert sorted(why) == [0, 1]
    assert "generated token 0 routed to [1, 3], its decode step to [0, 1]" \
        in why[0][0]
    # The same flip beyond the tolerance, or with equal scores, raises.
    for got in ([-1.0, 2.0, -1.0, 1.5], tie):
        z[20] = torch.tensor(got)
        with pytest.raises(AssertionError, match="not a near tie"):
            smoke.moe_excused(cfg, base, [(idx, z), pf[1]], dec, 2, 0.01)
    # A wide flip at layer 1 follows row 1's capacity event at layer 0,
    # but nothing in row 0.
    dec = [[routing(2, plain)] * 2]
    idx, z = routing(42, plain)
    idx[41], z[41] = torch.tensor([2, 3]), torch.tensor([-1.0, 0, 2, 1])
    why = smoke.moe_excused(cfg, base, [pf[0], (idx, z)], dec, 2, 0.01)
    assert "layer 1: " in why[1][1] and "routed to [2, 3]" in why[1][1]
    idx, z = routing(42, plain)
    idx[20], z[20] = torch.tensor([2, 3]), torch.tensor([-1.0, 0, 2, 1])
    with pytest.raises(AssertionError, match="row 0 layer 1"):
        smoke.moe_excused(cfg, base, [pf[0], (idx, z)], dec, 2, 0.01)


def test_held_rows_and_dropless():
    """A check that holds no row raises unless told not to; ``dropless``
    makes an MoE prefill's capacity its token count."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.moe import _capacity
    assert smoke.held_rows("t", "p", {0: ["x"]}, 2, "c") == [1]
    with pytest.raises(AssertionError, match="compares nothing"):
        smoke.held_rows("t", "p", {0: ["x"], 1: ["y"]}, 2, "c")
    assert smoke.held_rows("t", "p", {0: ["x"]}, 1, "c", require=False) == []
    for arch in ("qwen3-moe-30b-a3b", "mixtral-8x7b"):
        for reduced in (False, True):
            cfg = smoke.dropless(get_config(arch, reduced=reduced))
            assert all(_capacity(cfg, t) == t for t in (1, 33, 1101, 12016))
    cfg = get_config("minicpm3-4b")
    assert smoke.dropless(cfg) is cfg


def test_drift_probe_rehearses_on_the_cpu(monkeypatch, capsys):
    """tools/profile_torch_drift.py at the reduced zamba2 config on the CPU
    (float32 there, so every gap is float32 rounding and bf16 equals
    float32)."""
    root = Path(__file__).resolve().parent.parent
    monkeypatch.syspath_prepend(str(root))         # the tool imports chip_smoke
    spec = importlib.util.spec_from_file_location(
        "profile_torch_drift", root / "tools" / "profile_torch_drift.py")
    drift = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drift)
    monkeypatch.setattr(drift, "SEQ", 200)
    drift.probe("zamba2-2.7b", device="cpu", reduced=True)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["zamba2-2.7b k=1",
                                                 "zamba2-2.7b k=8"]
    assert all("prefill max 0 RMS 0" in ln for ln in lines)


def test_probe_edits_still_apply():
    """tools/probe_kernel_builds.py undoes design choices of the kernel
    sources by text edits: each must still find its text, once."""
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "probe_kernel_builds", root / "tools" / "probe_kernel_builds.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    for kernel, edits in probe.EDITS.items():
        builds = probe.sources(kernel, None)
        assert set(builds) == {"checkout", *edits}
        assert all(builds[name] != builds["checkout"] for name in edits)


@pytest.mark.parametrize("name", ("rows", "sections"))
def test_plane_process_refuses_without_a_card(tmp_path, name):
    """``chip_smoke.py --plane NAME OUT`` exits 2 and writes nothing where
    no CUDA card is visible."""
    import os
    import subprocess
    import sys
    out = tmp_path / "plane.json"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run([sys.executable, smoke.__file__, smoke.PLANE_FLAG,
                           name, str(out)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 2, done.stderr
    assert not out.exists()


def test_join_plane_reads_the_result_or_raises(tmp_path, capsys):
    """join_plane prints a plane process's lines and returns its launches
    and seconds; a non-zero exit raises."""
    import json
    import subprocess
    import sys
    (tmp_path / "sections.log").write_text("[fig7] a line\n")
    doc = {"launches": {"token_select": 3}, "seconds": {"fig7": 1.5}}
    (tmp_path / "sections.json").write_text(json.dumps(doc))
    ok = subprocess.Popen([sys.executable, "-c", "pass"])
    assert smoke.join_plane(ok, tmp_path, "sections") == (doc["launches"],
                                                          doc["seconds"])
    assert capsys.readouterr().out == "[fig7] a line\n"
    bad = subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    with pytest.raises(AssertionError, match="sections process exited 3"):
        smoke.join_plane(bad, tmp_path, "sections")


def test_stop_plane_ends_the_process_tree():
    """stop_plane kills a plane process and the processes it started (the
    gloo ranks of the shard and fleet phases)."""
    import subprocess
    import sys
    import time
    parent = subprocess.Popen([sys.executable, "-c", (
        "import subprocess, sys, time\n"
        "subprocess.Popen([sys.executable, '-c', 'import time; "
        "time.sleep(120)'])\n"
        "time.sleep(120)")])
    deadline = time.monotonic() + 60
    while not smoke.descendants(parent.pid):
        assert time.monotonic() < deadline, "the child never started"
        time.sleep(0.05)
    (child,) = smoke.descendants(parent.pid)
    smoke.stop_plane(parent)
    assert parent.returncode is not None
    deadline = time.monotonic() + 30
    while True:
        try:
            state = Path(f"/proc/{child}/stat").read_text().split()[2]
        except FileNotFoundError:
            break
        if state == "Z":        # killed, waiting for init to reap it
            break
        assert time.monotonic() < deadline, "the child outlived stop_plane"
        time.sleep(0.05)

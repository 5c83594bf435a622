"""The paper's remaining benchmark sections on the port against the JAX
package, on the CPU.

* fig7, fig9 (Figs. 9-11), fig13 and fig14 at the tests' depth
  (``paper_reference.json``'s ``test`` block, recorded by
  ``tools/record_figure_reference.py --paper``): every row's text and
  every run's attribution and integer counters equal the reference's,
  every variant run; one section is re-recorded live to tie the file to
  the reference, and the tool's scaled loops make the reference's own
  calls at scale 1 (a recorder in place of ``simulate``, nothing
  simulated).
* Row names of all six sections equal the reference's.
* kern: the inputs (``core/prng.py``'s normal, randint, uniform), the scan
  worker phase and the fused tick equal ``benchmarks/bench_tick.py``'s; the
  roofline at the v5e's constants equals the reference's dict.
* micro: the draw's inputs, the draws and the chain's shares equal
  ``benchmarks/bench_kernels.py``'s.
* calibrate: rows and chosen points equal ``benchmarks/calibrate.py``'s at
  0.1 s x 2 seeds, and a workspace campaign stopped by ``--max-chunks``
  resumes to the same tables.
"""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bench import (apps, calibrate, common, composite, kernels,
                               lambda_sync, scaling, tick)

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = common.load_paper_reference()
SECTIONS = {"fig7": scaling.run_fig7, "fig9": composite.run_fig9_11,
            "fig13": apps.run_fig13, "fig14": lambda_sync.run_fig14}
COUNTERS = ("scheduler", "params_hash", "dropped", "idle_worker_ticks",
            "issued", "completed")


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "record_figure_reference",
        REPO / "tools" / "record_figure_reference.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def port_section(name, scale):
    common.drain_run_log()
    rows = SECTIONS[name](device="cpu", scale=scale)
    return rows, common.drain_run_log()


@pytest.mark.parametrize("name", sorted(SECTIONS))
def test_rows_and_runs_equal_the_reference(name):
    want = REF["test"][name]
    rows, runs = port_section(name, want["scale"])
    assert [(r.name, r.derived) for r in rows] == list(want["rows"].items())
    assert [r.name for r in rows] == REF["names"][name]
    assert len(runs) == len(want["runs"])
    for got, exp in zip(runs, want["runs"]):
        assert {f: got[f] for f in COUNTERS} == {f: exp[f] for f in COUNTERS}
        assert got["seconds"] == pytest.approx(exp["seconds"])
    assert sum(sum(r["completed"]) for r in runs) > 0


def test_kern_and_micro_row_names_equal_the_reference():
    """(The four paper sections' names are held above, in order.)"""
    assert [r.name for r in tick.run_kern(device="cpu", iters=1)] \
        == REF["names"]["kern"]
    assert [r.name for r in kernels.run_micro(device="cpu", iters=1)] \
        == REF["names"]["micro"]


def test_live_reference_section_equals_the_file():
    """The cheapest section recorded again from the reference, now: the
    file is the reference's, not a stale copy."""
    tool = load_tool()
    want = REF["test"]["fig9"]
    live = json.loads(json.dumps(tool.paper_section("fig9", want["scale"])))
    assert live == want


def test_scaled_loops_make_the_reference_calls():
    """At scale 1 the tool's loops call ``simulate`` exactly as the
    reference's run_fig7 / run_fig9_11 / run_fig13 / run_fig14 do (a
    recorder stands in; nothing is simulated), and print the same text."""
    from benchmarks import (bench_apps, bench_composite, bench_lambda,
                            bench_scaling)
    tool = load_tool()

    def recorder(calls):
        def sim(*args, **kw):
            calls.append((args, kw))
            n = len(args[1])
            fake = {"gbps": np.full((n, 40), 1.5), "bin_s": 0.1,
                    "completed": np.arange(1, n + 1)}
            return fake, None
        return sim

    cases = ((bench_scaling, "run_fig7", tool.fig7_rows),
             (bench_composite, "run_fig9_11", tool.fig9_rows),
             (bench_apps, "run_fig13", tool.fig13_rows),
             (bench_lambda, "run_fig14", tool.fig14_rows))
    mp = pytest.MonkeyPatch()
    try:
        for module, fn_name, loop in cases:
            theirs, ours = [], []
            mp.setattr(module, "simulate", recorder(theirs))
            want = getattr(module, fn_name)()
            got = loop(recorder(ours), 1.0)
            assert ours == theirs and len(ours) > 1, fn_name
            assert [(n, d) for n, _, d in got] \
                == [(n, d) for n, _, d in want], fn_name
    finally:
        mp.undo()


# -- kern ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_kern():
    from benchmarks import bench_tick
    from repro.kernels.tick_step import tick_step
    fused = jax.jit(lambda *a: tick_step(*a, mode="themis", impl="auto"))
    return bench_tick, fused


@pytest.mark.parametrize("j", (16, 256))
def test_kern_scan_and_fused_equal_the_reference(ref_kern, j):
    bench_tick, fused = ref_kern
    args = bench_tick._inputs(j)
    ours = tick.inputs(j, "cpu")
    for a, b in zip(args, ours):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    want = bench_tick._scan_phase(*args)
    got = tick.scan_phase(*ours)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = fused(*args)
    sel, q, pops = tick.fused_phase(*ours)
    for a, b in zip((sel, q, pops), (want[0], want[3], want[4])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(sel.numpy().T, got[0].numpy())


def test_roofline_at_v5e_constants_equals_the_reference():
    from repro.roofline.analysis import tick_step_roofline as ref
    from repro_torch.roofline.analysis import HBM_BW, tick_step_roofline
    for s, j, w in ((8, 16, 8), (8, 1024, 8), (128, 1024, 4)):
        assert tick_step_roofline(s, j, w, hbm_bw=819e9,
                                  peak_flops=197e12) == ref(s, j, w)
    h100 = tick_step_roofline(8, 1024, 8)
    assert h100["memory_s"] == h100["bytes"] / HBM_BW
    assert h100["budget_us"] < ref(8, 1024, 8)["budget_us"]


# -- micro --------------------------------------------------------------------

def test_micro_draws_and_chain_equal_the_reference():
    from repro.core.job_table import make_table
    from repro.core.policy import Policy, compute_job_shares_from_table
    from repro.kernels.token_select.ref import token_select_ref
    from repro_torch.core.policy import Policy as TPolicy
    from repro_torch.core.policy import \
        compute_job_shares_from_table as t_shares
    from repro_torch.kernels.token_select.ops import token_select
    shares = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (8, 32)))
    qcount = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 4)
    u = jax.random.uniform(jax.random.PRNGKey(2), (8, 8))
    ours = kernels.draw_inputs("cpu")
    for a, b in zip((shares, qcount, u), ours):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        token_select(*ours).numpy(),
        np.asarray(jax.jit(token_select_ref)(shares, qcount, u)))
    table = make_table([{"user": i % 4, "group": i % 2, "size": 1 + i}
                        for i in range(16)], max_jobs=32)
    want = jax.jit(lambda: compute_job_shares_from_table(
        Policy.parse("group-user-size-fair"), table))()
    got = t_shares(TPolicy.parse("group-user-size-fair"),
                   kernels.chain_table("cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- calibrate ----------------------------------------------------------------

def test_calibration_tables_equal_the_reference():
    want = REF["test"]["calibrate"]
    for name, fn in calibrate.SECTIONS.items():
        rows, report = fn(want["seconds"], tuple(want["seeds"]),
                          device="cpu")
        assert {r.name: r.derived for r in rows} == want[name]["rows"], name
        assert report["chosen"] == want[name]["chosen"], name
        assert report["params_hash"] == want[name]["params_hash"], name


def test_calibration_campaign_stops_and_resumes(tmp_path, monkeypatch,
                                                capsys):
    """``--max-chunks 1`` stops the AdapTBF campaign after one chunk (exit
    3); the same command without it reuses those points, computes the rest
    and prints the tables of a plain sweep."""
    monkeypatch.setenv("BENCH_SECONDS", "0.1")
    monkeypatch.setenv("BENCH_SEEDS", "2")
    ws, out = str(tmp_path / "ws"), tmp_path / "calib.json"
    base = ["adaptbf", "--workspace", ws, "--chunk", "8", "--device", "cpu"]
    assert calibrate.main(base + ["--max-chunks", "1"]) == 3
    assert "INTERRUPTED" in capsys.readouterr().err
    assert calibrate.main(base + ["--json", str(out)]) == 0
    err = capsys.readouterr().err
    assert "8 reused, 12 computed" in err
    report = json.loads(out.read_text())["reports"]["adaptbf"]
    assert report["chosen"] == REF["test"]["calibrate"]["adaptbf"]["chosen"]
    assert calibrate.main(base) == 0
    assert "20 reused, 0 computed" in capsys.readouterr().err
    assert calibrate.main(["adaptbf", "--check", "--device", "cpu"]) == 2


def test_normal_and_erfinv_equal_jax():
    """jax.random.normal (through XLA's erf_inv expansion) bit for bit over
    32k draws, and randint over a shape."""
    from repro_torch.core import prng
    for seed in (0, 7):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                            (16, 1024)))
        got = prng.normal(prng.PRNGKey(seed), (16, 1024)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            prng.randint(prng.PRNGKey(seed), -3, 9, (16, 33)).numpy(),
            np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                          (16, 33), -3, 9)))
    x = np.array([-1.0, 1.0, 0.0, 0.999999], np.float32)
    np.testing.assert_array_equal(prng.erfinv_f32(torch.as_tensor(x)).numpy(),
                                  np.asarray(jax.lax.erf_inv(x)))

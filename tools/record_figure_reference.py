"""Record the JAX reference's Fig. 8 and Fig. 12 rows (and, with
``--scen`` or ``--batch``, its scenario or batch-plane rows) for the port to
be held to.

Runs the reference's own row functions (``benchmarks/bench_policies.py``
``run_fig8`` with its 8d table, ``benchmarks/bench_comparison.py``
``run_fig12``) at a reduced duration and seed count, and writes
``src/repro_torch/bench/fig_reference.json``: per row the seed means and
coefficients of variation behind its ``derived`` text, plus jax's version
and the command.  The numbers are taken where the reference computes them:
each row function's ``mean_cov`` calls are recorded in order and assigned
to the rows they feed.  The port reads the file as data and never imports
this tool.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_figure_reference.py \\
        --seconds 2 --seeds 8

``--scen`` runs the reference's ``benchmarks/bench_scenarios.py``
``run_scen`` instead (one seed per run, ``--seconds`` as its
``BENCH_SECONDS``) and writes ``src/repro_torch/bench/scen_reference.json``:
per row its ``derived`` text and the number it leads with.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_figure_reference.py \\
        --scen --seconds 1.6

``--batch`` runs the reference's ``benchmarks/bench_batch.py``
``run_batch`` (24 jobs, 300 annealing steps, seeds ``range(4)``: its own
defaults; ``--seconds`` caps the bridge run as its ``BENCH_SECONDS``) and
writes ``src/repro_torch/bench/batch_reference.json``: per row its
``derived`` text and the number it leads with.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_figure_reference.py \\
        --batch --seconds 2

``--fleet`` runs the reference's ``benchmarks/bench_fleet.py``
``run_fleet`` at its full geometry (S = 128, J = 1024, W = 4) for
``--seconds`` (``BENCH_FLEET_SECONDS``) in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu`` (its x1, x2 and x4 rungs), and writes
``src/repro_torch/bench/fleet_reference.json``: per row its ``derived``
text and ``us_per_call``, and under ``x1`` the x1 run's integer counters
(``issued``, ``completed``, ``dropped``, ``idle_worker_ticks``).

    PYTHONPATH=src python tools/record_figure_reference.py --fleet \\
        --seconds 0.02

``--paper`` records the rows of the six sections the port added last:
fig7, fig9 (Figs. 9-11), fig13 and fig14 at two depths (:data:`CARD_SCALE`
and :data:`TEST_SCALE` times the reference's durations, each section's
own factor), the calibration tables (at :data:`CALIB_CARD_SECONDS` and
:data:`CALIB_TEST_SECONDS` x 2 seeds), and the kern and micro rows
(names; their numbers are host timings), into
``src/repro_torch/bench/paper_reference.json``: per row its ``derived``
text and per simulation its scheduler, params hash and integer counters.
The reference's fig7/9/13/14 hard-code their depth, so the tool runs their
loops (:func:`fig7_rows` and the others, pinned call for call to the
reference's at scale 1 by ``tests/test_torch_paper.py``) with the
reference's own ``benchmarks.common.simulate``, ``repro.core.metrics``
and module constants, every duration multiplied by the scale.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/record_figure_reference.py \\
        --paper
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "src" / "repro_torch" / "bench" / "fig_reference.json"
SCEN_OUT = OUT.with_name("scen_reference.json")
BATCH_OUT = OUT.with_name("batch_reference.json")
FLEET_OUT = OUT.with_name("fleet_reference.json")
PAPER_OUT = OUT.with_name("paper_reference.json")

#: Depth of each section on the card and in the CPU tests, as a factor of
#: the reference's durations (fig7 6 s, fig9 40 s, fig13 30 + 60 + 60 s,
#: fig14 20 s).
CARD_SCALE = {"fig7": 1 / 25, "fig9": 1 / 80, "fig13": 1 / 20,
              "fig14": 1 / 20}
TEST_SCALE = {"fig7": 1 / 600, "fig9": 1 / 400, "fig13": 1 / 1000,
              "fig14": 1 / 200}
#: Calibration depth (seconds; 2 seeds) on the card and in the tests.
CALIB_CARD_SECONDS = 0.3
CALIB_TEST_SECONDS = 0.1
CALIB_SEEDS = (0, 1)

#: Run in the subprocess of ``--fleet``: the reference's rows and its x1
#: run's integer counters as JSON.
FLEET_CHILD = """
import json, jax, numpy as np
from benchmarks import bench_fleet
runs, simulate = [], bench_fleet.simulate
def recording(*args, **kw):
    out = simulate(*args, **kw)
    runs.append(out[0])
    return out
bench_fleet.simulate = recording
rows = bench_fleet.run_fleet()
x1 = {f: np.asarray(getattr(runs[0], f)).tolist() for f in
      ("issued", "completed", "dropped", "idle_worker_ticks")}
print(json.dumps({"jax": jax.__version__, "devices": jax.device_count(),
                  "rows": rows, "x1": x1}))
"""


def stats_per_row(name: str) -> int:
    """How many ``mean_cov`` results feed a row (in call order)."""
    if "_vs_" in name and name.startswith("fig12_themis_vs_"):
        return 0
    return 2 if name == "fig8c_user_fair_userA_vs_userB" else 1


def record(fn, module) -> list[tuple]:
    """Run ``fn`` with ``module.mean_cov`` recording; -> (rows, stats)."""
    log = []
    inner = module.mean_cov

    def recording(values):
        out = inner(values)
        log.append(out)
        return out

    module.mean_cov = recording
    try:
        rows = fn()
    finally:
        module.mean_cov = inner
    return rows, log


def assign(rows, log) -> dict:
    out, i = {}, 0
    for name, us, derived in rows:
        n = stats_per_row(name)
        stats = log[i:i + n]
        i += n
        scale = 1e3 if name.endswith("_job2_std_mbps") else 1.0
        entry = {"derived": derived,
                 "means": [float(m) * scale for m, _ in stats],
                 "covs": [float(c) for _, c in stats]}
        if n == 0:     # a ratio of two rows, as run_fig12 computes it
            other = name[len("fig12_themis_vs_"):].rsplit("_", 1)[0]
            variation = other.endswith("_variation")
            other = other.removesuffix("_variation")
            kind = "job2_std_mbps" if variation else "sustained_gbps"
            th = out[f"fig12_themis_{kind}"]["means"][0]
            ot = out[f"fig12_{other}_{kind}"]["means"][0]
            entry["means"] = [(1 - th / max(ot, 1e-9)) * 100 if variation
                              else (th / max(ot, 1e-12) - 1) * 100]
        out[name] = entry
    if i != len(log):
        raise RuntimeError(f"{len(log) - i} mean_cov results left unassigned")
    return out


def record_text_rows(fn, flag: str, seconds: float, out: Path,
                     **extra) -> int:
    """Run a reference row function and write each row's ``derived`` text
    and the number it leads with."""
    import jax

    t0 = time.time()
    rows = fn()
    doc = {
        "seconds": seconds,
        **extra,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "command": ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
                    f"tools/record_figure_reference.py {flag} --seconds "
                    f"{seconds:g}"),
        "wall_s": round(time.time() - t0, 1),
        "rows": {name: {"derived": derived,
                        "value": float(derived.split()[0].rstrip("x"))}
                 for name, _, derived in rows},
    }
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {len(doc['rows'])} rows to {out} in {doc['wall_s']} s")
    return 0


def record_fleet(seconds: float, out: Path) -> int:
    """The reference's fleet rows from a subprocess with four forced host
    devices (``XLA_FLAGS`` must be set before jax is imported)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_FLEET_SECONDS=str(seconds),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO)]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for knob in ("BENCH_FLEET_SERVERS", "BENCH_FLEET_JOBS",
                 "BENCH_FLEET_WORKERS"):
        env.pop(knob, None)             # the reference's own geometry
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", FLEET_CHILD], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          check=True)
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    doc = {
        "seconds": seconds,
        "jax": child["jax"],
        "backend": "cpu",
        "devices": child["devices"],
        "command": ("PYTHONPATH=src python tools/record_figure_reference.py "
                    f"--fleet --seconds {seconds:g}"),
        "wall_s": round(time.time() - t0, 1),
        "rows": {name: {"derived": derived, "us_per_call": us}
                 for name, us, derived in child["rows"]},
        "x1": child["x1"],
    }
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {len(doc['rows'])} rows to {out} in {doc['wall_s']} s")
    return 0


# -- the paper's sections at a depth ----------------------------------------
#
# The loops of benchmarks/bench_scaling.py, bench_composite.py,
# bench_apps.py and bench_lambda.py with every simulated duration times
# ``scale``; ``sim`` is the reference's ``benchmarks.common.simulate`` (or a
# recorder).  At scale 1 each makes the reference's calls exactly.

def fig7_rows(sim, scale: float) -> list[tuple]:
    from repro.core import metrics
    rows = []
    for n in [1, 2, 8, 32, 128]:
        jobs = [dict(user=0, size=n, procs=8 * n, req_mb=1, end_s=6 * scale)]
        for sched, pol in [("fifo", "job-fair"), ("themis", "job-fair")]:
            res, cfg = sim(
                sched, jobs, 6 * scale, policy=pol, n_servers=n,
                server_bw=11.7e9, dt=2e-4, wheel=2048, ring_cap=64,
                fabric_exponent=0.08, bin_ticks=500)
            agg = metrics.total_gbps(res, 2 * scale, 5.5 * scale)
            rows.append((f"fig7_{sched}_{n}srv_gbps", "", f"{agg:.1f}"))
    rows.append(("fig7_paper_reference", "0",
                 "paper: 11.7 @1, 77.1 @8 (82%), 1017 @128 (68%)"))
    return rows


def fig9_rows(sim, scale: float) -> list[tuple]:
    from repro.core import metrics
    rows = []
    end, w0, w1 = 40 * scale, 10 * scale, 35 * scale
    jobs = [dict(user=0, size=1, procs=56, req_mb=10, end_s=end),
            dict(user=0, size=2, procs=112, req_mb=10, end_s=end),
            dict(user=1, size=4, procs=112, req_mb=10, end_s=end),
            dict(user=1, size=6, procs=112, req_mb=10, end_s=end)]
    res, _ = sim("themis", jobs, end, policy="user-then-size-fair")
    g = [metrics.median_gbps(res, j, w0, w1) for j in range(4)]
    rows.append(("fig9_user_split_gbps", "",
                 f"u1={g[0]+g[1]:.1f} u2={g[2]+g[3]:.1f} (paper 10.1/9.9)"))
    rows.append(("fig9_within_user_ratios", "",
                 f"{g[1]/max(g[0],1e-9):.2f}~2.0 {g[3]/max(g[2],1e-9):.2f}~1.5"))
    jobs = [
        dict(group=0, user=0, size=2, procs=56, req_mb=10, end_s=end),
        dict(group=0, user=0, size=2, procs=56, req_mb=10, end_s=end),
        dict(group=1, user=1, size=2, procs=56, req_mb=10, end_s=end),
        dict(group=1, user=1, size=3, procs=84, req_mb=10, end_s=end),
        dict(group=1, user=1, size=2, procs=56, req_mb=10, end_s=end),
        dict(group=1, user=2, size=2, procs=56, req_mb=10, end_s=end),
        dict(group=1, user=3, size=1, procs=56, req_mb=10, end_s=end),
        dict(group=1, user=3, size=1, procs=56, req_mb=10, end_s=end),
    ]
    res, _ = sim("themis", jobs, end, policy="group-user-size-fair")
    g = [metrics.median_gbps(res, j, w0, w1) for j in range(8)]
    grp0, grp1 = g[0] + g[1], sum(g[2:])
    rows.append(("fig10_group_split_gbps", "",
                 f"{grp0:.1f}/{grp1:.1f} (paper 9.5/11.2)"))
    rows.append(("fig10_user1_jobs_ratio", "",
                 f"{g[2]:.2f}:{g[3]:.2f}:{g[4]:.2f} ~ 2:3:2"))
    rows.append(("fig10_total_gbps", "", f"{sum(g):.1f} (paper 20.7)"))
    return rows


def fig13_rows(sim, scale: float) -> list[tuple]:
    import numpy as np
    from benchmarks.bench_apps import APPS, BG
    from repro.core import metrics
    rows = []
    bg = dict(BG, end_s=BG["end_s"] * scale)
    for name, app in APPS.items():
        excl, _ = sim("themis", [dict(user=0, end_s=25 * scale, **app)],
                      30 * scale, policy="size-fair")
        n_req = int(excl["completed"][0])
        spec = dict(user=0, start_s=0, end_s=60 * scale, **app)
        fifo, _ = sim("fifo", [spec, bg], 60 * scale)
        fair, _ = sim("themis", [spec, bg], 60 * scale, policy="size-fair")
        t_excl = metrics.completion_time(excl, 0, n_req)
        t_fifo = metrics.completion_time(fifo, 0, n_req)
        t_fair = metrics.completion_time(fair, 0, n_req)
        sd_fifo = (t_fifo / t_excl - 1) * 100
        sd_fair = (t_fair / t_excl - 1) * 100
        if np.isfinite(sd_fifo):
            reduction = (1 - max(sd_fair, 0) / max(sd_fifo, 1e-9)) * 100
            red_s = f"{reduction:.1f}"
        else:
            red_s = ">99" if sd_fair < 1.4 else f"bounded by {sd_fair:.1f}%"
        rows.append((f"fig13_{name}_fifo_slowdown_pct", "",
                     f"{sd_fifo:.1f}" if np.isfinite(sd_fifo) else ">140"))
        rows.append((f"fig13_{name}_sizefair_slowdown_pct", "",
                     f"{sd_fair:.1f}"))
        rows.append((f"fig13_{name}_interference_reduction_pct", "",
                     f"{red_s} (paper range 59.1-99.8)"))
    return rows


def fig14_rows(sim, scale: float) -> list[tuple]:
    import numpy as np
    from benchmarks.bench_lambda import JOBS
    from repro.core import metrics
    jobs = [dict(j, end_s=j["end_s"] * scale) for j in JOBS]
    seconds, b0 = 20 * scale, int(round(40 * scale))
    rows = []
    for lam_ms in [10, 50, 200, 500]:
        res, _ = sim("themis", jobs, seconds, policy="size-fair",
                     n_servers=2, sync_ticks=lam_ms, bin_ticks=50)
        tf = metrics.time_to_fairness(res, [0, 1, 2], [0.5, 0.25, 0.25],
                                      tol=0.06)
        tr = metrics.share_trace(res, [0, 1, 2])
        var = float(np.std(tr[0, b0:]))
        intervals = tf / (lam_ms / 1000.0)
        rows.append((f"fig14_lam{lam_ms}ms_t_fair_s", "",
                     f"{tf:.2f} ({intervals:.1f} intervals; paper <=2 for >=50ms)"))
        rows.append((f"fig14_lam{lam_ms}ms_share_std", "", f"{var:.3f}"))
    res, _ = sim("themis", jobs, seconds, policy="size-fair", n_servers=2,
                 sync_ticks=0, bin_ticks=50)
    tr = metrics.share_trace(res, [0, 1, 2])
    rows.append(("fig14_nosync_job1_share", "0",
                 f"{float(tr[0, b0:].mean()):.3f} (local-unfair 0.667)"))
    return rows


PAPER_LOOPS = {"fig7": fig7_rows, "fig9": fig9_rows, "fig13": fig13_rows,
               "fig14": fig14_rows}


def counters(res) -> dict:
    """A run's attribution and integer counters, as the port's
    ``bench.common.RUN_LOG`` holds them."""
    import numpy as np
    return dict(res.counters(),
                issued=np.asarray(res.issued).tolist(),
                completed=np.asarray(res.completed).tolist())


def paper_section(name: str, scale: float) -> dict:
    """One section's rows and runs at ``scale``, on the reference."""
    from benchmarks.common import simulate
    runs = []

    def sim(*args, **kw):
        res, cfg = simulate(*args, **kw)
        runs.append(dict(counters(res), seconds=float(args[2])))
        return res, cfg

    rows = PAPER_LOOPS[name](sim, scale)
    return {"scale": scale,
            "rows": {n: derived for n, _, derived in rows}, "runs": runs}


def calib_tables(seconds: float) -> dict:
    """The reference's calibration rows and chosen points at ``seconds`` x
    :data:`CALIB_SEEDS`."""
    from benchmarks import calibrate
    out = {"seconds": seconds, "seeds": list(CALIB_SEEDS)}
    for name, fn in calibrate.SECTIONS.items():
        rows, report = fn(seconds, CALIB_SEEDS)
        out[name] = {"rows": {n: derived for n, _, derived in rows},
                     "chosen": report["chosen"],
                     "params_hash": report["params_hash"]}
    return out


def record_paper(card: dict, test: dict, calib_card: float,
                 calib_test: float, out: Path) -> int:
    import jax
    from benchmarks.bench_kernels import run_micro
    from benchmarks.bench_tick import run_kern

    t0 = time.time()
    doc = {"jax": jax.__version__, "backend": jax.default_backend(),
           "command": ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
                       "tools/record_figure_reference.py --paper"),
           "scales": {"card": card, "test": test},
           "card": {n: paper_section(n, card[n]) for n in PAPER_LOOPS},
           "test": {n: paper_section(n, test[n]) for n in PAPER_LOOPS}}
    doc["card"]["calibrate"] = calib_tables(calib_card)
    doc["test"]["calibrate"] = calib_tables(calib_test)
    os.environ["BENCH_KERN_ITERS"] = "2"
    doc["names"] = {
        "kern": [r[0] for r in run_kern()],
        "micro": [r[0] for r in run_micro()],
        **{n: list(doc["test"][n]["rows"]) for n in PAPER_LOOPS}}
    doc["wall_s"] = round(time.time() - t0, 1)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {out} in {doc['wall_s']} s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--scen", action="store_true",
                    help="record the scenario rows instead")
    ap.add_argument("--batch", action="store_true",
                    help="record the batch plane's rows instead")
    ap.add_argument("--fleet", action="store_true",
                    help="record the fleet rows instead")
    ap.add_argument("--paper", action="store_true",
                    help="record the fig7/9/13/14, calibration, kern and "
                         "micro rows instead")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    os.environ["BENCH_SECONDS"] = str(args.seconds)
    os.environ["BENCH_SEEDS"] = str(args.seeds)
    sys.path.insert(0, str(REPO))
    if args.fleet:
        return record_fleet(args.seconds, args.out or FLEET_OUT)
    if args.paper:
        for knob in ("BENCH_SECONDS", "BENCH_SEEDS", "BENCH_KERN_ITERS"):
            os.environ.pop(knob, None)
        return record_paper(CARD_SCALE, TEST_SCALE, CALIB_CARD_SECONDS,
                            CALIB_TEST_SECONDS, args.out or PAPER_OUT)
    if args.scen:
        from benchmarks import bench_scenarios
        return record_text_rows(bench_scenarios.run_scen, "--scen",
                                args.seconds, args.out or SCEN_OUT)
    if args.batch:
        from benchmarks import bench_batch
        for knob in ("BENCH_SEEDS", "BENCH_BATCH_JOBS", "BENCH_BATCH_STEPS"):
            os.environ.pop(knob, None)      # the reference's own defaults
        return record_text_rows(
            bench_batch.run_batch, "--batch", args.seconds,
            args.out or BATCH_OUT, seeds=list(range(4)),
            n_jobs=bench_batch._n_jobs(),
            sa_steps=bench_batch._params().sa_steps)
    args.out = args.out or OUT
    import jax
    from benchmarks import bench_comparison, bench_policies

    t0 = time.time()
    rows8, log8 = record(bench_policies.run_fig8, bench_policies)
    rows12, log12 = record(bench_comparison.run_fig12, bench_comparison)
    doc = {
        "seconds": args.seconds,
        "seeds": list(range(args.seeds)),
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "command": ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
                    f"tools/record_figure_reference.py --seconds "
                    f"{args.seconds:g} --seeds {args.seeds}"),
        "wall_s": round(time.time() - t0, 1),
        "rows": {**assign(rows8, log8), **assign(rows12, log12)},
    }
    args.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {len(doc['rows'])} rows to {args.out} in {doc['wall_s']} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    os.environ["BENCH_SECONDS"] = str(args.seconds)
    os.environ["BENCH_SEEDS"] = str(args.seeds)
    sys.path.insert(0, str(REPO))
    if args.fleet:
        return record_fleet(args.seconds, args.out or FLEET_OUT)
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

"""Record the JAX reference's Fig. 8 and Fig. 12 rows (and, with
``--scen``, its scenario rows) for the port to be held to.

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
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "src" / "repro_torch" / "bench" / "fig_reference.json"
SCEN_OUT = OUT.with_name("scen_reference.json")


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


def record_scen(seconds: float, out: Path) -> int:
    import jax
    from benchmarks import bench_scenarios

    t0 = time.time()
    rows = bench_scenarios.run_scen()
    doc = {
        "seconds": seconds,
        "jax": jax.__version__,
        "backend": jax.default_backend(),
        "command": ("JAX_PLATFORMS=cpu PYTHONPATH=src python "
                    f"tools/record_figure_reference.py --scen --seconds "
                    f"{seconds:g}"),
        "wall_s": round(time.time() - t0, 1),
        "rows": {name: {"derived": derived,
                        "value": float(derived.split()[0].rstrip("x"))}
                 for name, _, derived in rows},
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
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    os.environ["BENCH_SECONDS"] = str(args.seconds)
    os.environ["BENCH_SEEDS"] = str(args.seeds)
    sys.path.insert(0, str(REPO))
    if args.scen:
        return record_scen(args.seconds, args.out or SCEN_OUT)
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

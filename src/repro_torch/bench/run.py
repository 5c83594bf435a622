"""Benchmark harness of the port: one section per paper table or figure.

Prints ``name,us_per_call,derived`` CSV; ``--json PATH`` also writes the
rows as a JSON document (written atomically, temp-then-rename) whose
sections each carry a ``runs`` block: one entry per simulation with the
scheduler, the scheduler-params hash, the ``dropped`` /
``idle_worker_ticks`` counters and the per-job ``issued`` / ``completed``
counts, so a trend point is attributable to the configuration that made
it (``python -m repro_torch.bench.trend``).  ``--workspace DIR`` also
records every row as a ``bench`` record in a
:mod:`repro_torch.workspace` store.  Sections run on the card; ``--device
cpu`` runs the plain versions on the host.

    PYTHONPATH=src python -m repro_torch.bench.run            # all
    PYTHONPATH=src python -m repro_torch.bench.run fig7 fig14
    PYTHONPATH=src python -m repro_torch.bench.run kern --json BENCH_kern.json
    PYTHONPATH=src python -m repro_torch.bench.run --list     # sections + rows
"""
from __future__ import annotations

import argparse
import sys

from .apps import run_fig13
from .batch import run_batch
from .common import bench_env, drain_run_log, emit
from .comparison import run_fig12
from .composite import run_fig9_11
from .fleet import run_fleet
from .kernels import run_micro
from .lambda_sync import run_fig14
from .policies import run_fig8
from .scaling import run_fig7
from .scenarios import run_scen
from .tick import run_kern

SECTIONS = {
    "batch": run_batch,
    "fig7": run_fig7,
    "fig8": run_fig8,
    "fig9": run_fig9_11,
    "fig12": run_fig12,
    "fig13": run_fig13,
    "fig14": run_fig14,
    "fleet": run_fleet,
    "kern": run_kern,
    "micro": run_micro,
    "scen": run_scen,
}

#: ``--list`` schema: section -> row-name patterns it emits (the
#: reference's).  ``{...}`` marks the ladder / variant axis; the trend
#: gate's direction comes from the row name (``trend.direction``).
ROW_SCHEMAS = {
    "batch": ["batch_{preset}_{policy}_meanwait_s",
              "batch_{preset}_{policy}_p95wait_s",
              "batch_{preset}_plan_vs_{baseline}",
              "batch_bridge_{sched}_gbps"],
    "fig7": ["fig7_{sched}_{n}srv_gbps", "fig7_paper_reference"],
    "fig8": ["fig8_{policy}_{job}_gbps", "fig8_{policy}_jain"],
    "fig9": ["fig9_{policy}_{phase}_gbps", "fig11_{policy}_drain_s"],
    "fig12": ["fig12_{sched}_{metric}", "fig12_{sched}_vs_paper"],
    "fig13": ["fig13_{app}_{sched}_s"],
    "fig14": ["fig14_lambda{n}_{metric}"],
    "fleet": ["fleet_run_us_per_tick_x{k}", "fleet_x{k}_vs_x1",
              "fleet_gbps_x1"],
    "kern": ["kern_tick_ref_j{J}", "kern_tick_fused_j{J}",
             "kern_tick_speedup_j{J}", "kern_tick_budget_us_j{J}"],
    "micro": ["micro_{op}_us"],
    "scen": ["scen_{name}_{metric}"],
}


def list_sections() -> None:
    """Print every section, its one-line purpose, and the rows it emits."""
    for name, fn in SECTIONS.items():
        doc = (sys.modules[fn.__module__].__doc__ or "").strip()
        headline = doc.splitlines()[0] if doc else ""
        print(f"{name}: {headline}")
        for pattern in ROW_SCHEMAS.get(name, []):
            print(f"    {pattern}")


def record_to_workspace(root: str, all_rows: dict) -> int:
    """One ``bench`` record per row, flushed as one buffered journal append,
    keyed as the trend keys its points (the row's scheduler / params_hash
    attribution plus the env fingerprint)."""
    from ..workspace import RunKey, RunRecord, WorkspaceStore, env_fingerprint
    from .trend import _attribute, parse_value

    store = WorkspaceStore(root)
    env = env_fingerprint()
    n = 0
    with store.buffered("bench") as buf:
        for section, sec in all_rows.items():
            for row in sec["rows"]:
                run = _attribute(row["name"], sec["runs"])
                key = RunKey(
                    section="bench", name=f"{section}/{row['name']}",
                    scheduler=run.get("scheduler") or "",
                    params_hash=run.get("params_hash") or "",
                    scenario_hash="", env=env)
                buf.put(RunRecord(key=key, payload={
                    "value": parse_value(row["derived"]),
                    "us_per_call": parse_value(row["us_per_call"]),
                    "derived": row["derived"],
                    "dropped": run.get("dropped"),
                    "idle_worker_ticks": run.get("idle_worker_ticks")}))
                n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.bench.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("sections", nargs="*",
                    help=f"sections to run (default: all of {list(SECTIONS)})")
    ap.add_argument("--list", action="store_true",
                    help="print the sections and the rows each emits")
    ap.add_argument("--json", dest="json_path", metavar="PATH",
                    help="also write the rows and runs as a JSON document")
    ap.add_argument("--workspace", metavar="DIR",
                    help="also record every row in this workspace store")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.list:
        list_sections()
        return 0
    all_rows: dict[str, dict] = {}
    print("name,us_per_call,derived")
    for name in args.sections or list(SECTIONS):
        key = next((k for k in SECTIONS if name.startswith(k)), None)
        if key is None:
            raise SystemExit(f"unknown section {name}; have {list(SECTIONS)}")
        drain_run_log()   # anything stray belongs to no section
        rows = SECTIONS[key](device=args.device)
        emit(rows)
        all_rows[key] = {
            "rows": [{"name": r.name, "us_per_call": r.us_per_call,
                      "derived": r.derived} for r in rows],
            "runs": drain_run_log(),
        }
    if args.json_path:
        from ..workspace import atomic_write_json
        atomic_write_json(args.json_path,
                          {"sections": all_rows,
                           "env": bench_env(args.device)})
        print(f"# wrote {args.json_path}", file=sys.stderr)
    if args.workspace:
        n = record_to_workspace(args.workspace, all_rows)
        print(f"# recorded {n} rows -> workspace {args.workspace}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

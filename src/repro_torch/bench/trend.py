"""Tracked perf trend over per-commit ``BENCH_*.json`` artifacts (the
port's own copy of the reference's ``benchmarks/trend.py``; pure Python).

``repro_torch.bench.run --json`` artifacts carry, per section, the measurement rows
*and* a ``runs`` attribution block (scheduler, ``params_hash``, dropped /
idle counters).  This tool ingests any number of those artifacts into a
rolling ``BENCH_TREND.json`` history, prints the trend table, and gates on
regressions — so the per-commit bench smoke stops being a pile of orphaned
artifacts and becomes a tracked trajectory.

Every trend point is keyed on ``(section, row, params_hash, env)``:

  * ``params_hash`` ties the number to the exact scheduler configuration
    that produced it — a deliberate recalibration changes the hash and
    starts a *new* trend line instead of tripping the gate;
  * ``env`` (the artifact's ``BENCH_SECONDS``/``BENCH_SEEDS`` shrink) keeps
    CI smoke points from being compared against full-length local runs.

The gate compares the newest label against the latest *earlier* label per
key: higher-is-better rows (``*gbps*``, ``*jain*``) fail on a drop beyond
``--gate`` percent, lower-is-better rows (``*std*``) on a rise.  Derived
comparison rows (``*_vs_*``) are tracked but never gated — they are ratios
of gated quantities.  ``--history`` is only written when the gate passes,
so a regressing commit never becomes the next run's baseline.

    python -m repro_torch.bench.trend BENCH_fig12.json BENCH_fig8.json \
        --history BENCH_TREND.json --label $GITHUB_SHA --gate 30

``--workspace DIR`` ingests straight from a :mod:`repro_torch.workspace`
store (the ``bench`` records ``repro_torch.bench.run --workspace`` writes) instead of —
or in addition to — artifact files; duplicate (label, key) points collapse,
so passing both is harmless.  The history itself is written atomically
(temp-then-rename) and a corrupt existing history is tolerated with a
warning and a fresh start.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Optional

_FLOAT = re.compile(r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def parse_value(derived) -> Optional[float]:
    """Leading float of a ``derived`` cell (``"22.01GB/s cov 3.2%"`` → 22.01)."""
    m = _FLOAT.match(str(derived).strip())
    return float(m.group(0)) if m else None


def _env_key(doc: dict) -> str:
    env = doc.get("env", {})
    key = (f"s={env.get('BENCH_SECONDS', 'full')}"
           f"/k={env.get('BENCH_SEEDS', 'full')}")
    # section-specific shrink knobs (BENCH_FLEET_*, BENCH_KERN_ITERS, ...)
    # change what a row measures just like BENCH_SECONDS does — fold them
    # into the key so a shrunk CI run never shares a series with a
    # full-geometry local run
    extra = sorted(f"{k.removeprefix('BENCH_').lower()}={v}"
                   for k, v in env.items()
                   if k.startswith("BENCH_")
                   and k not in ("BENCH_SECONDS", "BENCH_SEEDS"))
    return key + ("/" + "/".join(extra) if extra else "")


def _attribute(name: str, runs: list[dict]) -> dict:
    """The ``runs`` entry whose scheduler the row name mentions (longest
    scheduler name wins, so ``adaptbf`` rows never match ``tbf``)."""
    best = {}
    for r in runs:
        s = r.get("scheduler") or ""
        if s and s in name and len(s) > len(best.get("scheduler") or ""):
            best = r
    return best


def extract_points(doc: dict, label: str) -> list[dict]:
    """Flatten one BENCH_*.json document into trend points."""
    points = []
    env = _env_key(doc)
    for section, sec in doc.get("sections", {}).items():
        runs = sec.get("runs", [])
        for row in sec.get("rows", []):
            value = parse_value(row.get("derived"))
            if value is None:
                continue
            run = _attribute(row.get("name", ""), runs)
            points.append({
                "label": label,
                "section": section,
                "name": row["name"],
                "value": value,
                "us_per_call": parse_value(row.get("us_per_call")),
                "scheduler": run.get("scheduler") or None,
                # "" (a param-less scheduler's attribution) and missing
                # both normalize to None, so the artifact and workspace
                # ingest paths key the same row into the same series
                "params_hash": run.get("params_hash") or None,
                "dropped": run.get("dropped"),
                "idle_worker_ticks": run.get("idle_worker_ticks"),
                "env": env,
            })
    return points


def point_key(p: dict) -> tuple:
    return (p["section"], p["name"], p.get("params_hash"), p.get("env"))


def load_history(path: Optional[str]) -> dict:
    """The rolling history, or a fresh one.  A corrupt file (a crashed
    earlier writer, pre-atomic-rename) is tolerated with a warning and a
    restarted trend — losing the trajectory beats refusing every future
    ingest."""
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or not isinstance(
                    doc.get("points"), list):
                raise ValueError("not a {'points': [...]} document")
            return doc
        except (json.JSONDecodeError, ValueError) as e:
            print(f"WARNING: corrupt trend history {path} ({e}); "
                  f"starting a fresh history", file=sys.stderr)
    return {"points": []}


def merge(history: dict, new_points: list[dict]) -> dict:
    """Append points, one per (label, key): duplicates within the ingest
    (the same artifact listed twice, or two artifacts sharing a key) collapse
    to the last occurrence, and any stale history point with the same
    (label, key) is replaced."""
    deduped: dict[tuple, dict] = {}
    for p in new_points:
        deduped[(p["label"],) + point_key(p)] = p
    kept = [p for p in history.get("points", [])
            if (p["label"],) + point_key(p) not in deduped]
    history["points"] = kept + list(deduped.values())
    return history


def _series(history: dict) -> dict[tuple, list[dict]]:
    """Group points by key, preserving history (= label) order."""
    out: dict[tuple, list[dict]] = {}
    for p in history.get("points", []):
        out.setdefault(point_key(p), []).append(p)
    return out


def direction(name: str) -> Optional[int]:
    """+1 higher-is-better, -1 lower-is-better, None ungated."""
    if "_vs_" in name or "budget" in name:
        return None   # ratios of gated quantities / analytic constants
    if "std" in name:
        return -1
    if "wait" in name or "bsld" in name:
        return -1     # waiting-time objectives (batch plane)
    if "speedup" in name:
        return +1
    if "gbps" in name or "jain" in name:
        return +1
    if "_us_" in name or name.endswith("_us"):
        return -1     # raw latency rows (kern ladder)
    return None


def trend_table(history: dict) -> str:
    lines = ["key,params_hash,env,trend,delta_pct"]
    # None params_hash sorts as "" so mixed attributed/unattributed series
    # (e.g. an old history written before "" normalized to None) still print
    for key, pts in sorted(_series(history).items(),
                           key=lambda kv: tuple(x or "" for x in kv[0])):
        section, name, phash, env = key
        vals = [p["value"] for p in pts]
        trail = " -> ".join(f"{v:g}" for v in vals[-6:])
        delta = ("" if len(vals) < 2 or vals[-2] == 0 else
                 f"{(vals[-1] - vals[-2]) / abs(vals[-2]) * 100:+.1f}")
        lines.append(f"{section}/{name},{phash or '-'},{env},{trail},{delta}")
    return "\n".join(lines)


def gate(history: dict, gate_pct: float, latest_label: str) -> list[str]:
    """Regressions of ``latest_label`` vs the previous *label* per key."""
    failures = []
    for key, pts in _series(history).items():
        if pts[-1]["label"] != latest_label:
            continue
        older = [p for p in pts if p["label"] != latest_label]
        if not older:
            continue
        sign = direction(key[1])
        prev, latest = older[-1]["value"], pts[-1]["value"]
        if sign is None or prev == 0:
            continue
        change = (latest - prev) / abs(prev) * 100
        if (sign > 0 and change < -gate_pct) or (sign < 0 and change > gate_pct):
            failures.append(
                f"{key[0]}/{key[1]} [{key[2]}]: {prev:g} -> {latest:g} "
                f"({change:+.1f}% beyond the {gate_pct:g}% gate)")
    return failures


def workspace_points(root: str, label: str) -> list[dict]:
    """Trend points from ``repro_torch.bench.run --workspace`` records (section
    ``bench``, one record per measurement row) — the artifact-file-free
    ingest path."""
    from ..workspace import WorkspaceStore

    points = []
    for rec in WorkspaceStore(root).query(section="bench"):
        section, _, name = rec.key.name.partition("/")
        p = rec.payload
        points.append({
            "label": label, "section": section, "name": name,
            "value": p.get("value"), "us_per_call": p.get("us_per_call"),
            "scheduler": rec.key.scheduler or None,
            "params_hash": rec.key.params_hash or None,
            "dropped": p.get("dropped"),
            "idle_worker_ticks": p.get("idle_worker_ticks"),
            "env": rec.key.env,
        })
    return [p for p in points if p["value"] is not None]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.bench.trend", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("artifacts", nargs="*", help="BENCH_*.json inputs")
    ap.add_argument("--history", help="rolling BENCH_TREND.json (read+write)")
    ap.add_argument("--workspace", metavar="DIR",
                    help="also ingest 'bench' records from this workspace "
                         "store (repro_torch.bench.run --workspace)")
    ap.add_argument("--label", default=None,
                    help="label for this ingest (default: GITHUB_SHA or 'local')")
    ap.add_argument("--gate", type=float, default=30.0,
                    help="regression gate in percent (default 30)")
    ap.add_argument("--no-gate", action="store_true",
                    help="ingest and print only; never fail")
    args = ap.parse_args(argv)
    if not args.artifacts and not args.workspace:
        ap.error("nothing to ingest: pass BENCH_*.json artifacts "
                 "and/or --workspace DIR")

    label = args.label or os.environ.get("GITHUB_SHA", "local")[:12]
    points = []
    for path in args.artifacts:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"cannot read artifact {path}: {e}", file=sys.stderr)
            return 2
        points.extend(extract_points(doc, label))
    if args.workspace:
        points.extend(workspace_points(args.workspace, label))
    if not points:
        print("no gateable rows found in the artifacts", file=sys.stderr)
        return 2

    history = merge(load_history(args.history), points)
    print(trend_table(history))
    failures = [] if args.no_gate else gate(history, args.gate, label)
    for f_ in failures:
        print(f"REGRESSION {f_}", file=sys.stderr)
    # History is persisted only when the gate passes: a regressing ingest
    # must not become the next run's baseline, or a sustained regression
    # would fail exactly once and then be ratified.
    if args.history:
        if failures:
            print(f"# history NOT updated ({args.history}): gate failed",
                  file=sys.stderr)
        else:
            # atomic temp-then-rename: a crash mid-dump must never leave a
            # torn history that poisons every later ingest
            from ..workspace import atomic_write_json
            atomic_write_json(args.history, history)
            print(f"# history: {args.history} "
                  f"({len(history['points'])} points)", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

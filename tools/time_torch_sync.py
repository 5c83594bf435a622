#!/usr/bin/env python3
"""What the λ-sync's order of sums costs a tick, on a CUDA card.

    python3 tools/time_torch_sync.py --other build/parent

Times, in a fresh process per checkout (the kernels built from each
checkout's own sources), the fleet rows' themis run (S = 128, J = 1024,
W = 4, user-fair, ``repro_torch.bench.fleet``; fused tick, λ-sync every
500 ticks) over ``--ticks`` ticks after a warm-up, and one
``global_sync.sync_segments`` at that geometry (32 Sinkhorn rounds), for
this checkout and ``--other DIR`` (another checkout, e.g. the parent commit
unpacked with ``git archive``) in turns: other, this, this, other.  Prints
one line per run with ms/tick and ms per λ-sync, then the card's
nvidia-smi name and power limit.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: Run in each checkout's own process: prints one JSON line.
CHILD = """
import json, time, torch
from repro_torch.bench import fleet
from repro_torch.core import engine, global_sync
from repro_torch.core.policy import PolicyChain
s, j, w, _ = fleet.geometry()
cfg, wl, table = fleet.experiment(s, j, w, "cuda", 1).build()
tick = engine.make_tick(cfg, wl, table, n_bins=1)
p = engine.get_scheduler(cfg.scheduler).params(cfg)
state = engine.init_state(cfg, 1)
for _ in range({warmup}):
    state = tick(p, state)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range({ticks}):
    state = tick(p, state)
torch.cuda.synchronize()
ms_tick = (time.perf_counter() - t0) / {ticks} * 1e3
chain = PolicyChain.from_table(cfg.policy, table)
demand = state.qcount[0] > 0 if state.qcount.dim() == 3 else state.qcount > 0
global_sync.sync_segments(chain, demand)
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(5):
    global_sync.sync_segments(chain, demand)
torch.cuda.synchronize()
ms_sync = (time.perf_counter() - t0) / 5 * 1e3
print(json.dumps({{"ms_per_tick": ms_tick, "ms_per_sync": ms_sync,
                  "sync_ticks": cfg.sync_ticks}}))
"""


def run(checkout: Path, ticks: int, warmup: int) -> dict:
    code = CHILD.format(ticks=ticks, warmup=warmup)
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(checkout / "src")},
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--warmup", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_torch_sync: needs a CUDA card", file=sys.stderr)
        return 2
    other = args.other.resolve()
    for name, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                       ("other", other)):
        out = run(tree, args.ticks, args.warmup)
        print(f"{name} ({tree}): themis fused {out['ms_per_tick']:.3f} "
              f"ms/tick over {args.ticks} ticks (λ-sync every "
              f"{out['sync_ticks']} ticks), {out['ms_per_sync']:.3f} ms per "
              "λ-sync", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

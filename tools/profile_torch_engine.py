#!/usr/bin/env python3
"""Where a tick of the PyTorch port's engine spends its time, on a CUDA card.

    python3 tools/profile_torch_engine.py

Runs the fleet geometry of ``chip_smoke.py`` (benchmarks/bench_fleet.py:
S=128, J=1024, W=4, user-fair) for themis and fifo on the fused path,
themis on the scan path, gift, tbf, adaptbf and plan (the scan path, with
the schedulers phase's 125-tick μ), and themis fused over 8 seed lanes of
one batched run.  After 20 warm-up ticks it profiles 100 steady
ticks with ``torch.profiler`` and prints, per tick: the host's wall time,
the device's busy time (the sum of kernel durations on the one stream),
the device's idle share, the number of kernel launches, and the kernels
that take the most device time.  Exits 2 without a card.
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WARMUP, TICKS = 20, 100


def profile(scheduler: str, impl: str, lanes: int = 1) -> None:
    import torch
    from chip_smoke import (FLEET_MU_TICKS, SCAN_SCHEDULERS, fleet_geometry,
                            scheduler_params)
    from repro_torch.api import Experiment
    from repro_torch.bench.fleet import fleet_jobs
    from repro_torch.core import engine
    from repro_torch.core.params import lane_params

    point = (scheduler_params(scheduler, FLEET_MU_TICKS)
             if scheduler in SCAN_SCHEDULERS else None)
    geom = fleet_geometry()
    cfg, wl, table = Experiment(
        policy="user-fair", scheduler=scheduler, tick_impl=impl,
        params=point, **geom
    ).add_jobs(fleet_jobs(geom["max_jobs"], geom["n_servers"])).build()
    tick = engine.make_tick(cfg, wl, table, n_bins=1)
    params = engine.get_scheduler(cfg.scheduler).params(cfg)
    state = engine.init_state(cfg, 1, seeds=range(lanes))
    if lanes > 1:
        params = lane_params([params], lanes, state.key.device)
    for _ in range(WARMUP):
        state = tick(params, state)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(TICKS):
            state = tick(params, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    print(f"{scheduler}/{impl} x{lanes} lanes: {TICKS} profiled ticks, "
          f"host wall {wall / TICKS * 1e3:.3f} ms/tick (profiler on)")
    summarize(prof, wall, TICKS, "tick")


def summarize(prof, wall: float, n: int, unit: str) -> None:
    """Device busy time, idle share, launches and the top kernels of a
    ``torch.profiler`` run of ``n`` ``unit``s that took ``wall`` seconds."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("  device time: not measured (the profiler recorded no kernels)")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"  device busy {busy_us / n / 1e3:.3f} ms/{unit}, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}, kernel launches "
          f"{len(kernels) / n:.1f}/{unit}")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / n:9.2f} us/{unit} {count / n:6.1f} "
              f"launches/{unit}  {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    print(f"device: {torch.cuda.get_device_name(0)}")
    for scheduler, impl in (("themis", "fused"), ("fifo", "fused"),
                            ("themis", "scan"), ("gift", "scan"),
                            ("tbf", "scan"), ("adaptbf", "scan"),
                            ("plan", "scan")):
        profile(scheduler, impl)
    profile("themis", "fused", lanes=8)
    return 0


if __name__ == "__main__":
    sys.exit(main())

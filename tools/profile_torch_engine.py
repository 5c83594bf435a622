#!/usr/bin/env python3
"""Where a tick of the PyTorch port's engine spends its time, on a CUDA card.

    python3 tools/profile_torch_engine.py

Runs the fleet geometry of ``chip_smoke.py`` (benchmarks/bench_fleet.py:
S=128, J=1024, W=4, user-fair) for themis and fifo on the fused path and
themis on the scan path.  After 20 warm-up ticks it profiles 100 steady
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


def profile(scheduler: str, impl: str) -> None:
    import torch
    from chip_smoke import FLEET, fleet_jobs
    from repro_torch.api import Experiment
    from repro_torch.core import engine

    cfg, wl, table = Experiment(
        policy="user-fair", scheduler=scheduler, tick_impl=impl, **FLEET
    ).add_jobs(fleet_jobs(FLEET["max_jobs"], FLEET["n_servers"])).build()
    tick = engine.make_tick(cfg, wl, table, n_bins=1)
    params = engine.get_scheduler(cfg.scheduler).params(cfg)
    state = engine.init_state(cfg, 1)
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

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"{scheduler}/{impl}: {TICKS} profiled ticks, host wall "
          f"{wall / TICKS * 1e3:.3f} ms/tick (profiler on)")
    if not kernels:
        print("  device time: not measured (the profiler recorded no kernels)")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"  device busy {busy_us / TICKS / 1e3:.3f} ms/tick, idle share "
          f"{1 - busy_us / 1e6 / wall:.3f}, kernel launches "
          f"{len(kernels) / TICKS:.1f}/tick")
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    for name, (count, us) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / TICKS:9.2f} us/tick {count / TICKS:6.1f} "
              f"launches/tick  {name[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    print(f"device: {torch.cuda.get_device_name(0)}")
    for scheduler, impl in (("themis", "fused"), ("fifo", "fused"),
                            ("themis", "scan")):
        profile(scheduler, impl)
    return 0


if __name__ == "__main__":
    sys.exit(main())

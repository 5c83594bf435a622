#!/usr/bin/env python3
"""Where the PyTorch port's serving path spends its time, on a card.

    python3 tools/profile_torch_serve.py [--arch h2o-danube-1.8b]

An architecture the port serves (h2o-danube-1.8b by default; zamba2-2.7b,
rwkv6-7b, ...) at full width and depth in bf16 (random weights from a
seed), at the shapes of ``chip_smoke.py``'s serve phases: a batched prefill
of 2 x 6000 tokens and greedy decode steps at B = 2.  After one warm-up
prefill and 3 warm-up decode steps it profiles one prefill and 8 decode
steps with ``torch.profiler`` and prints, for each: the host's wall time,
the device's busy time (the sum of kernel durations on the one stream), the
device's idle share, the number of kernel launches, and the kernels that
take the most device time.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ, WARMUP_STEPS, STEPS = 2, 6000, 3, 8


def main(argv=None) -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from profile_torch_engine import summarize
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    print(f"device: {torch.cuda.get_device_name(0)}; arch {args.arch}")
    cfg = get_config(args.arch)
    params = M.init_params(cfg, seed=0)
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, SEQ)),
        dtype=torch.int32, device="cuda")
    prefill = make_prefill_step(cfg, SEQ + WARMUP_STEPS + STEPS)
    decode = make_decode_step(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"prefill B={BATCH} S={SEQ}: host wall {wall * 1e3:.1f} ms "
          "(profiler on)")
    summarize(prof, wall, 1, "prefill")

    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    pos = SEQ

    def step():
        nonlocal tok, caches, pos
        p = torch.full((BATCH,), pos, dtype=torch.int32, device="cuda")
        _, tok, caches = decode(params, caches, {"tokens": tok}, p)
        pos += 1

    for _ in range(WARMUP_STEPS):
        step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"decode B={BATCH}: {STEPS} profiled steps, host wall "
          f"{wall / STEPS * 1e3:.2f} ms/step (profiler on)")
    summarize(prof, wall, STEPS, "step")
    return 0


if __name__ == "__main__":
    sys.exit(main())

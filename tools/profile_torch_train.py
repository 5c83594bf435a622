#!/usr/bin/env python3
"""Where the PyTorch port's train step spends its time, on a card.

    python3 tools/profile_torch_train.py [--arch h2o-danube-1.8b]
        [--seq 4096] [--batch 2] [--layers N]

An architecture at full width (its depth cut to ``--layers`` if given) in
bf16 with remat "block", at ``chip_smoke.py``'s train shape (2 x 4096
tokens).  After one warm-up step it times the forward and backward
(``train_step._grads``) and the AdamW update (``optimizer.apply``) of one
step with the device synchronised, then profiles one whole step with
``torch.profiler`` and prints the device's busy time and idle share, its
kernel time by kind (the WKV scan's backward, the SSD scan's backward,
the scan's forward (SSD or WKV, by the arch), the step and decay forward
and backward, flash backward, flash forward, bf16 GEMMs, float32 GEMMs,
the rest) and the kernels that take the most.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: Kernel kinds by name: the first pattern a kernel's name contains (the
#: float32 head's GEMMs are CUTLASS SIMT and xmma f32 kernels; cuBLASLt
#: names its bf16 GEMMs ``nvjet_*`` on Hopper).  The two scans' forward
#: kernels share their names (``kind_of`` names them by the arch).
KINDS = (("WKV backward", ("wkv_chunk_dstate_kernel",
                           "wkv_state_pass_bwd_kernel",
                           "wkv_chunk_bwd_kernel", "wkv_sum_du_kernel")),
         ("SSD backward", ("chunk_dstate_kernel", "state_pass_bwd_kernel",
                           "chunk_bwd_kernel", "sum_groups_kernel")),
         ("SSD forward", ("chunk_state_kernel", "state_pass_kernel",
                          "chunk_scan_kernel")),
         ("step and decay", ("step_decay",)),
         ("flash backward", ("dq_kernel", "dkv_kernel")),
         ("flash forward", ("flash_bf16_kernel", "flash_fwd_kernel")),
         ("float32 GEMM", ("f32f32", "sgemm", "gemm_f32", "tf32")),
         ("bf16 GEMM", ("nvjet", "bf16", "gemm", "xmma", "cutlass")))


def kind_of(name: str, arch: str = "") -> str:
    for kind, pats in KINDS:
        if any(p in name for p in pats):
            if kind == "SSD forward" and arch.startswith("rwkv"):
                return "WKV forward"
            return kind
    return "other"


def main(argv=None) -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    cfg = get_config(args.arch)
    if args.layers:
        kinds = cfg.pattern[0][1]
        cfg = dataclasses.replace(cfg, n_layers=args.layers,
                                  pattern=((args.layers, kinds),))
    cfg = dataclasses.replace(cfg, loss_chunk=min(cfg.loss_chunk, args.seq))
    print(f"device: {torch.cuda.get_device_name(0)}; {args.arch} "
          f"{cfg.n_layers} layers, {args.batch} x {args.seq} tokens")
    state = T.init_state(cfg, seed=0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab,
                                            (args.batch, args.seq + 1))
    batch = T.to_device({"tokens": ids[:, :-1], "labels": ids[:, 1:]},
                        "cuda")
    ocfg = O.OptConfig()
    step = T.make_train_step(cfg, ocfg)
    state, _ = step(state, batch)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    loss, _, grads = T._grads(state.params, cfg, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    O.apply(ocfg, state.params, grads, state.opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    print(f"forward + backward {1e3 * (t1 - t0):.1f} ms, AdamW "
          f"{1e3 * (t2 - t1):.1f} ms (host clock, synchronised)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    print(f"step: host wall {wall * 1e3:.1f} ms")
    if not kernels:
        print("  device time: not measured (the profiler recorded no kernels)")
        return 0
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f"  device busy {busy:.1f} ms, idle share {1 - busy / 1e3 / wall:.3f}"
          f", {len(kernels)} kernel launches")
    by_kind, by_name = defaultdict(float), defaultdict(lambda: [0, 0.0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name, args.arch)] += us / 1e3
        by_name[e.name][0] += 1
        by_name[e.name][1] += us / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:15s} {ms:9.1f} ms  {ms / busy:6.1%} of busy")
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        print(f"  {ms:9.2f} ms {count:5d} launches  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

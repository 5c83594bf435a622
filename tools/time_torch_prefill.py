#!/usr/bin/env python3
"""zamba2's serving speed on a CUDA card, this checkout against others.

    python3 tools/time_torch_prefill.py --other build/parent [--other DIR ...]

Times, in a fresh process per checkout (the kernels built from each
checkout's own sources), zamba2-2.7b at full width and depth in bf16
(random weights from seed 0) at the shapes of ``chip_smoke.py``'s
serve_zamba2 phase: a batched prefill of 2 x 6000 tokens (median of
``--prefills`` after one warm-up) and greedy decode steps at B = 2 (median
of ``--steps`` after 3 warm-up steps), host wall time around a device
synchronisation.  The checkouts run in turns: each other, this, this, each
other in reverse.  Prints one line per run with prefill ms and tokens/s and
decode ms/step, then the card's nvidia-smi name and power limit.  Exits 2
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: Run in each checkout's own process: prints one JSON line.
CHILD = """
import json, time, numpy as np, torch
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
batch, seq = 2, 6000
cfg = get_config("zamba2-2.7b")
params = M.init_params(cfg, seed=0, device="cuda")
prompt = torch.as_tensor(np.random.default_rng(0).integers(
    0, cfg.vocab, (batch, seq)), dtype=torch.int32, device="cuda")
prefill = make_prefill_step(cfg, seq + 3 + {steps})
decode = make_decode_step(cfg)
def wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out
prefill(params, {{"tokens": prompt}})
times = []
for _ in range({prefills}):
    t, (logits, caches) = wall(lambda: prefill(params, {{"tokens": prompt}}))
    times.append(t)
tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
steps = []
for i in range(3 + {steps}):
    pos = torch.full((batch,), seq + i, dtype=torch.int32, device="cuda")
    t, (logits, _, caches) = wall(
        lambda: decode(params, caches, {{"tokens": tok}}, pos))
    tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
    if i >= 3:
        steps.append(t)
med = lambda xs: sorted(xs)[len(xs) // 2]
print(json.dumps({{"prefill_ms": med(times) * 1e3,
                  "prefill_tokens_per_s": batch * seq / med(times),
                  "decode_ms_per_step": med(steps) * 1e3}}))
"""


def run(checkout: Path, prefills: int, steps: int) -> dict:
    code = CHILD.format(prefills=prefills, steps=steps)
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env={**os.environ,
                               "PYTHONPATH": str(checkout / "src")},
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", required=True)
    ap.add_argument("--prefills", type=int, default=5)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_torch_prefill: needs a CUDA card", file=sys.stderr)
        return 2
    others = [p.resolve() for p in args.other]
    order = others + [ROOT, ROOT] + others[::-1]
    for tree in order:
        out = run(tree, args.prefills, args.steps)
        name = "this" if tree == ROOT else tree.name
        print(f"{name} ({tree}): zamba2-2.7b bf16 prefill 2 x 6000 "
              f"{out['prefill_ms']:.1f} ms ({out['prefill_tokens_per_s']:.0f} "
              f"tokens/s, median of {args.prefills}); decode "
              f"{out['decode_ms_per_step']:.2f} ms/step (median of "
              f"{args.steps})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

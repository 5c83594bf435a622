#!/usr/bin/env python3
"""rwkv6 training on a card: the WKV backward's build and cases, how deep a
full-width step fits, and where a step's card-vs-CPU error comes from.

    python3 tools/probe_wkv6_training.py check
    python3 tools/probe_wkv6_training.py fit 16 12 10
    python3 tools/probe_wkv6_training.py card-vs-cpu

``check`` builds ``wkv6.cu`` (and prints ``ptxas -v``'s registers and
spills of its backward kernels), holds the WKV backward against its plain
version over ``chip_smoke.WKV6_BWD_CASES`` and then times it, each pass and
the plain version at rwkv6-7b's training shape (B = 2, S = 4096, H = 64,
K = 64, chunk 64, bf16) on random inputs.  ``fit`` runs ``chip_smoke``'s
``train_rwkv6`` phase (the train CLI, 2 x 4096 tokens, 3 steps and a
fourth with layer 0's backward inputs captured) at each depth given, and
prints its metrics or, where the card runs out of memory, the peak and
the allocator's account.  ``card-vs-cpu`` takes one float32 step of rwkv6
at 2 layers and full width (``chip_smoke.phase_train_card_vs_cpu``'s
set-up) on the CPU and, from the same weights, on the card four ways: the
WKV kernels; the kernels' forward with the backward's plain version; the
plain versions both ways; the kernels again.  It prints each pair's worst
leaves (gradients, AdamW's updated parameters and moments) as max abs
error over the leaf's max.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: The WKV backward at rwkv6-7b's training shape, a WKV6_BWD_CASES entry.
TRAIN_CASE = (2, 4096, 64, 64, 64, "bfloat16", False, False, "normal",
              False)


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def check(smoke) -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import ops
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
    ptxas = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS[:5], "-Xptxas", "-v", "-c", "-o",
         "/dev/null", str(_build.CSRC / "wkv6.cu")],
        capture_output=True, text=True)
    lines = (ptxas.stdout + ptxas.stderr).splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and "_wkv_" in line:
            print(line.split("'")[1][:80], *(x.strip() for x in
                  lines[n + 1:n + 4] if "Used" in x or "spill" in x))
    for n, case in enumerate(smoke.WKV6_BWD_CASES):
        args, kw = smoke.wkv6_bwd_inputs(case, "cuda", seed=n)
        smoke.wkv6_bwd_check(args, kw, str(case), "check")
        smoke.wkv6_bwd_layout_held(args[0], case[4], str(case))
    args, kw = smoke.wkv6_bwd_inputs(TRAIN_CASE, "cuda", seed=7)
    smoke.wkv6_bwd_check(args, kw, "training shape", "check")
    r, k, v, lw, u, dy, _ = args
    chunk = kw["chunk"]
    q = ops.chunk_dstate(r, dy, lw, chunk=chunk)
    times = {
        "wkv6_bwd": smoke.time_ms(lambda: ops.wkv6_bwd(*args, **kw), 10),
        "chunk_dstate": smoke.time_ms(lambda: ops.chunk_dstate(
            r, dy, lw, chunk=chunk), 10),
        "state_pass_bwd": smoke.time_ms(lambda: ops.state_pass_bwd(
            q, kw["cwl"]), 10),
        "chunk_bwd + sum_du": smoke.time_ms(lambda: ops.chunk_bwd(
            r, k, v, lw, u, dy, kw["s_in"], kw["sf"], q, chunk=chunk), 10),
        "wkv6 forward": smoke.time_ms(lambda: ops.wkv6(
            r, k, v, lw, u, chunk=chunk), 10),
        "plain wkv6_bwd": smoke.time_ms(lambda: wkv6_bwd_ref(*args, **kw),
                                        1)}
    print(f"training shape {tuple(r.shape)} bf16, random inputs: device ms "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in times.items())
          + "; bound " + str(smoke.pipe_bound(
              *smoke.wkv6_bwd_work(r, chunk),
              ops_per_s=smoke.TF32_OPS_PER_S, ops_pipe="TF32 tensor")))


def fit(smoke, depths) -> None:
    import gc
    import torch
    for n in depths:
        cut = dict(n_layers=n, pattern=((n, ("rwkv",)),))
        t0 = time.perf_counter()
        try:
            *_, metrics = smoke.phase_train(
                "cuda", arch="rwkv6-7b", tag=f"fit {n}", cut=cut,
                **smoke.TRAIN_RWKV6_ARGS)
            print(f"{n} layers: {json.dumps(metrics)}", flush=True)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{n} layers: out of memory after "
                  f"{time.perf_counter() - t0:.1f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB: "
                  f"{str(e)[:420]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()


def card_vs_cpu(smoke) -> None:
    import numpy as np
    from repro_torch.kernels.rwkv6 import ref
    from repro_torch.models import model as M
    from repro_torch.models import rwkv
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T
    cfg = smoke.serve_config(False, "rwkv6-7b", dtype="float32",
                             param_dtype="float32", block_q=256,
                             block_k=256, loss_chunk=256,
                             **smoke.SSM_CUTS["rwkv6-7b"])
    card = M.init_params(cfg, seed=2, device="cuda").requires_grad_(True)
    cpu = copy.deepcopy(card).to("cpu")
    ids = np.random.default_rng(2).integers(0, cfg.vocab, (1, 513))
    ocfg = O.OptConfig(lr=1e-3, warmup_steps=1, eps=1e-5)

    def step(params):
        dev = O.leaves(params)[0][1].device
        batch = T.to_device({"tokens": ids[:, :-1], "labels": ids[:, 1:]},
                            dev)
        loss, _, grads = T._grads(params, cfg, batch)
        params = copy.deepcopy(params)
        params, opt, _ = O.apply(ocfg, params, grads, O.init(params))
        return loss, grads, params, opt

    real = rwkv.wkv6, rwkv.wkv6_bwd
    out = {"cpu": step(cpu), "kernels": step(card)}
    rwkv.wkv6_bwd = ref.wkv6_bwd_ref
    out["plain backward"] = step(card)
    rwkv.wkv6 = ref.wkv6_ref
    out["plain both ways"] = step(card)
    rwkv.wkv6, rwkv.wkv6_bwd = real
    out["kernels again"] = step(card)
    watch = ("grad seg0.blk0.tm.u", "nu seg0.blk0.tm.u",
             "grad seg0.blk0.ln1.bias", "param seg0.blk0.ln1.bias")
    for a, b in (("kernels", "cpu"), ("plain backward", "cpu"),
                 ("plain both ways", "cpu"), ("kernels", "plain backward"),
                 ("kernels", "plain both ways"),
                 ("kernels", "kernels again")):
        errs = smoke.step_leaf_errors(out[a], out[b])
        top = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
        loss = abs(float(out[a][0]) - float(out[b][0])) / abs(
            float(out[b][0]))
        print(f"{a} against {b}: loss rel err {loss:.3g}; worst "
              + "; ".join(f"{k} {v:.3g}" for k, v in top) + "; "
              + "; ".join(f"{k} {errs[k]:.3g}" for k in watch), flush=True)
    grads = out["cpu"][1]
    bias = O.get_path(grads, ("seg0", "blk0", "ln1", "bias")).double()
    near = int(((bias.abs() > 1e-6) & (bias.abs() < 1e-4)).sum())
    print(f"ln1.bias's gradient: {near} of {bias.numel()} elements between "
          f"1e-6 and 1e-4 (AdamW's eps {ocfg.eps:g})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="what", required=True)
    sub.add_parser("check")
    p = sub.add_parser("fit")
    p.add_argument("depths", type=int, nargs="+")
    sub.add_parser("card-vs-cpu")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_wkv6_training: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = load_smoke()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.what == "check":
        check(smoke)
    elif args.what == "fit":
        fit(smoke, args.depths)
    else:
        card_vs_cpu(smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())

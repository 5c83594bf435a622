#!/usr/bin/env python3
"""How far the port's prefill and decode paths part, and how noisy bf16 is,
for each served model, on a card.

    python3 tools/profile_torch_drift.py [--arch zamba2-2.7b ...]

For each arch at full width and depth (random weights from seed 0, the
shapes of ``chip_smoke.py``'s serve phases: B = 2, a 6000-token prompt, 8
greedy decode steps) it prints, for k = 1 and 8, the gap (max |diff| and
RMS diff / RMS logit) between the prefill of the prompt plus k generated
tokens and the k-th decode step:

  * in float32 arithmetic (the bf16 weights upcast), once with the kernels
    and once with their plain versions in their place: if the two agree,
    the drift is the model's float32 arithmetic, not a kernel's;
  * in bf16, beside each bf16 path's distance from the same weights in
    float32: the bf16 rounding noise of the model.

Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ, STEPS, KS = 2, 6000, 8, (1, 8)
ARCHS = ("zamba2-2.7b", "rwkv6-7b", "h2o-danube-1.8b")


@contextmanager
def plain_kernels():
    """The model modules' kernel wrappers replaced by the plain versions
    (which the wrappers run only for CPU tensors)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mamba2.ref import mamba2_ssd_ref
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models import attention, rwkv, ssm
    saved = ssm.mamba2_ssd, rwkv.wkv6, attention.flash_attention
    ssm.mamba2_ssd, rwkv.wkv6 = mamba2_ssd_ref, wkv6_ref
    attention.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        ssm.mamba2_ssd, rwkv.wkv6, attention.flash_attention = saved


def paths(params, cfg, prompt, gen, device):
    """(the k-th decode step's logits, the prefill of prompt + k's) for k in
    KS, decoding the tokens ``gen``."""
    import torch
    from repro_torch.models import model as M
    max_len = SEQ + STEPS
    _, caches = M.prefill(params, cfg, {"tokens": prompt}, max_len=max_len)
    steps = []
    for i in range(max(KS)):
        pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32, device=device)
        logits, caches = M.decode_step(params, cfg, caches,
                                       {"tokens": gen[i]}, pos)
        steps.append(logits)
    return {k: (steps[k - 1], M.prefill(
        params, cfg, {"tokens": torch.cat([prompt] + gen[:k], dim=1)},
        max_len=max_len)[0]) for k in KS}


def probe(arch: str, device="cuda", reduced=False) -> None:
    import copy
    import dataclasses
    import numpy as np
    import torch
    from chip_smoke import logit_gap
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config(arch, reduced=reduced)
    params = M.init_params(cfg, seed=0, device=device)
    prompt = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, SEQ)),
        dtype=torch.int32, device=device)
    logits, caches = M.prefill(params, cfg, {"tokens": prompt},
                               max_len=SEQ + STEPS)
    gen = []
    for i in range(max(KS)):
        tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
        gen.append(tok)
        pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32, device=device)
        logits, caches = M.decode_step(params, cfg, caches, {"tokens": tok},
                                       pos)
    del caches
    bf16 = paths(params, cfg, prompt, gen, device)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = copy.deepcopy(params).float()
    del params
    f32 = paths(params32, cfg32, prompt, gen, device)
    with plain_kernels():
        f32_plain = paths(params32, cfg32, prompt, gen, device)
    fmt = "max {:.4g} RMS {:.4g}".format
    for k in KS:
        print(f"{arch} k={k}: float32 prefill vs decode "
              f"{fmt(*logit_gap(f32[k][1], f32[k][0]))} (kernels), "
              f"{fmt(*logit_gap(f32_plain[k][1], f32_plain[k][0]))} (plain "
              f"versions); bf16 prefill vs decode "
              f"{fmt(*logit_gap(bf16[k][1], bf16[k][0]))}; bf16 vs float32: "
              f"prefill {fmt(*logit_gap(bf16[k][1], f32[k][1]))}, decode "
              f"{fmt(*logit_gap(bf16[k][0], f32[k][0]))}", flush=True)
    del params32
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_drift: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    print(f"device: {torch.cuda.get_device_name(0)}")
    for arch in args.arch:
        probe(arch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""A few train steps of the port and of the JAX reference side by side, on
the CPU, at h2o-danube-1.8b's full width cut in depth.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_vs_reference.py \\
        [--layers 4] [--seq 256] [--batch 1] [--steps 5]

Both sides start from the port's random init (seed 0) in the full config's
dtypes (bf16 parameters and activations), take the train CLI's AdamW
(lr 3e-4, 20 warmup steps, cosine over ``--steps``) on the port's zipf
corpus (``DataLoader``, the CLI's data config), and print each step's loss
and grad norm beside the other's, then the largest relative difference.
It answers whether a loss's course in the first steps (a rise, say) is the
reference's too.  Not collected by pytest: at 4 layers the one process
holds ~15 GB (both sides' parameters, gradients and float32 moments).
"""
from __future__ import annotations

import argparse
import dataclasses
import resource
import time

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as ref_get_config
from repro.train import optimizer as RO
from repro.train import train_step as RT
from repro_torch.configs.base import get_config
from repro_torch.core import convert
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

ARCH = "h2o-danube-1.8b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    cut = dict(n_layers=args.layers, pattern=((args.layers, ("attn",)),),
               loss_chunk=min(1024, args.seq), remat="none")
    rcfg = dataclasses.replace(ref_get_config(ARCH), **cut)
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    ocfg = dict(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    loader = DataLoader(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, batch_size=args.batch,
        shard_tokens=max(1 << 16, args.batch * (args.seq + 1) * 8)))
    batches = [loader.next_batch() for _ in range(args.steps)]
    np_params = convert.tree_to_numpy(TM.init_params(cfg, 0, device="cpu"))
    ref = RT.TrainState(params=jax.tree.map(jnp.asarray, np_params),
                        opt=RO.init(np_params))
    port = convert.train_state_from_numpy(ref, cfg)
    del np_params
    rows = {}
    t0 = time.perf_counter()
    ref_step = jax.jit(RT.make_train_step(rcfg, RO.OptConfig(**ocfg)))
    for batch in batches:
        ref, m = ref_step(ref, batch)
        rows.setdefault("reference", []).append(
            (float(m["loss"]), float(m["grad_norm"])))
    del ref, ref_step
    t1 = time.perf_counter()
    step = TT.make_train_step(cfg, TO.OptConfig(**ocfg))
    for batch in batches:
        port, m = step(port, batch)
        rows.setdefault("port", []).append(
            (float(m["loss"]), float(m["grad_norm"])))
    t2 = time.perf_counter()
    print(f"{ARCH} full width, {args.layers} layers, {cfg.param_dtype}, "
          f"{args.batch} x {args.seq} tokens, lr {ocfg['lr']} with "
          f"{ocfg['warmup_steps']} warmup steps")
    worst = 0.0
    for i, ((rl, rg), (pl, pg)) in enumerate(zip(rows["reference"],
                                                 rows["port"])):
        rel = abs(pl - rl) / abs(rl)
        worst = max(worst, rel)
        print(f"step {i}: loss reference {rl!r} port {pl!r} (rel {rel:.3g}); "
              f"grad norm reference {rg!r} port {pg!r}")
    print(f"largest relative loss difference {worst:.3g}; reference "
          f"{t1 - t0:.1f} s, port {t2 - t1:.1f} s; peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.1f} GB")


if __name__ == "__main__":
    main()

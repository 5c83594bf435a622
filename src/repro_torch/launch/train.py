"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --steps 200 --seq 128 --batch 8 [--full] [--device cpu]

The port of ``repro.launch.train``: the arch's reduced config unless
``--full``, AdamW (lr 3e-4, 20 warmup steps, cosine to ``--steps``), the
synthetic zipf corpus through the port's ``DataLoader``, a checkpoint every
50 steps into ``--ckpt-dir`` if given.  Runs on the card by default;
``--device cpu`` runs the plain path.  Every arch trains on either
(zamba2-2.7b's SSD scan and step and decay and rwkv6-7b's WKV scan have
backward kernels).  ``--full`` rwkv6-7b does not fit one 80 GB card: its
7.53 B parameters at 12 bytes each (bf16 weights and gradients, float32
AdamW moments) take 90.4 GB before any activation; half its depth (16
layers, 48.4 GB) does.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..ckpt.manager import CheckpointManager
from ..configs.base import get_config
from ..data.pipeline import DataConfig, DataLoader
from ..train import optimizer as O
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (one card holds the smaller archs)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=not args.full)
    cfg = dataclasses.replace(cfg, loss_chunk=min(cfg.loss_chunk, args.seq))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      batch_size=args.batch,
                      shard_tokens=max(1 << 16, args.batch * (args.seq + 1) * 8))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(
        cfg,
        O.OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=50, log_every=10),
        DataLoader(dcfg), ckpt=ckpt, device=args.device)
    trainer.init_or_restore()
    hist = trainer.run()
    for h in hist[:: max(1, len(hist) // 10)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} {h['dt']*1e3:7.1f} ms")
    print(f"final loss {hist[-1]['loss']:.4f}")
    return trainer


if __name__ == "__main__":
    main()

"""Model input specs: ``(shape, dtype)`` stand-ins and random batches.

The port of ``repro.configs.inputs``.  Modality frontends are stubs:
musicgen gets precomputed EnCodec frame tokens (``codes``, one stream per
codebook), llama-vision gets precomputed patch embeddings (``vision``);
everything else gets token ids.  A spec is a ``(shape, torch dtype)`` tuple
where the reference has a ``jax.ShapeDtypeStruct``; batches are drawn from
an explicit ``torch.Generator`` on its device (they do not reproduce
``jax.random``'s bits).
"""
from __future__ import annotations

import torch

from .base import ModelConfig, ShapeSpec


def train_input_specs(cfg: ModelConfig, seq: int, batch: int) -> dict:
    specs = {}
    if cfg.n_codebooks:
        specs["codes"] = ((batch, seq, cfg.n_codebooks), torch.int32)
        specs["labels"] = ((batch, seq, cfg.n_codebooks), torch.int32)
    else:
        specs["tokens"] = ((batch, seq), torch.int32)
        specs["labels"] = ((batch, seq), torch.int32)
    if cfg.n_vision_tokens:
        specs["vision"] = ((batch, cfg.n_vision_tokens, cfg.vision_dim),
                           getattr(torch, cfg.dtype))
    return specs


def decode_input_specs(cfg: ModelConfig, batch: int) -> dict:
    if cfg.n_codebooks:
        return {"codes": ((batch, 1, cfg.n_codebooks), torch.int32)}
    return {"tokens": ((batch, 1), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Specs for the step function the shape lowers (train vs serve)."""
    if shape.kind == "train":
        return train_input_specs(cfg, shape.seq_len, shape.global_batch)
    if shape.kind == "prefill":
        specs = train_input_specs(cfg, shape.seq_len, shape.global_batch)
        specs.pop("labels")
        return specs
    # decode: one new token against a seq_len cache
    return decode_input_specs(cfg, shape.global_batch)


def random_batch(gen: torch.Generator, cfg: ModelConfig, seq: int,
                 batch: int, with_labels: bool = True) -> dict:
    """Token ids (or codes) uniform in ``[0, vocab)``, labels likewise, and
    the vision stub standard normal in float32 cast to ``cfg.dtype``, all
    drawn from ``gen`` on its device."""
    dev = gen.device
    ids = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks else (batch, seq)
    name = "codes" if cfg.n_codebooks else "tokens"

    def randint():
        return torch.randint(0, cfg.vocab, ids, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    out = {name: randint()}
    if with_labels:
        out["labels"] = randint()
    if cfg.n_vision_tokens:
        out["vision"] = torch.randn(
            (batch, cfg.n_vision_tokens, cfg.vision_dim), generator=gen,
            device=dev, dtype=torch.float32).to(getattr(torch, cfg.dtype))
    return out

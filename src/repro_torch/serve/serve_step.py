"""The serving steps: prefill (prompt -> caches) and decode (one token
against the caches), as ``repro.serve.serve_step`` builds them."""
from __future__ import annotations

import torch

from ..models import model as M


def make_prefill_step(cfg, max_len: int):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step


def make_decode_step(cfg, greedy: bool = True):
    def decode_step(params, caches, batch, pos):
        logits, caches = M.decode_step(params, cfg, caches, batch, pos)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32) if greedy else None
        return logits, nxt, caches
    return decode_step

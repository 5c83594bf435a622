"""Gemma3-4B [dense]: 34L d=2560 8H (GQA kv=4, head_dim=256) ff=10240
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    pattern=((5, ("local",) * 5 + ("global",)), (4, ("local",))),
    qk_norm=True, rope_theta=1e6, rope_theta_local=1e4, local_window=1024,
    act="geglu", norm="rms", tie_embeddings=True, embed_scale=True,
)

REDUCED = dataclasses.replace(
    CFG, n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, local_window=32,
    pattern=((2, ("local",) * 2 + ("global",)), (2, ("local",))),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

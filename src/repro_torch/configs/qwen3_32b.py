"""Qwen3-32B [dense]: 64L d=5120 64H (GQA kv=8, head_dim=128) ff=25600
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936,
    qk_norm=True, rope_theta=1e6, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, pattern=((4, ("attn",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

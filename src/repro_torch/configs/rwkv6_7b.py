"""RWKV6-7B (Finch) [ssm]: 32L d=4096 attention-free, ff=14336 vocab=65536 —
data-dependent decay linear recurrence. [arXiv:2404.05892; hf]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    pattern=((32, ("rwkv",)),),
    rwkv_head_dim=64, norm="ln",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, rwkv_head_dim=32, pattern=((3, ("rwkv",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

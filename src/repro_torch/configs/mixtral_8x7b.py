"""Mixtral-8x7B [moe]: 32L d=4096 32H (GQA kv=8) expert_ff=14336, 8 experts
top-2, sliding-window attention, vocab=32000. [arXiv:2401.04088; hf]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=((32, ("attn_moe",)),),
    n_experts=8, top_k=2, expert_ff=14336, moe_router="topk_softmax",
    window=4096, rope_theta=1e6, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, n_experts=4, top_k=2, expert_ff=128, window=64,
    pattern=((3, ("attn_moe",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

"""Qwen3-30B-A3B [moe]: 48L d=2048 32H (GQA kv=4, head_dim=128), 128 experts
top-8 with expert_ff=768, vocab=151936 — qk_norm. [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    pattern=((48, ("attn_moe",)),),
    n_experts=128, top_k=8, expert_ff=768, moe_router="softmax_topk",
    qk_norm=True, rope_theta=1e6, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab=512, n_experts=8, top_k=2, expert_ff=64,
    pattern=((3, ("attn_moe",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

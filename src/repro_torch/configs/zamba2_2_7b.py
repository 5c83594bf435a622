"""Zamba2-2.7B [hybrid]: 54 Mamba-2 layers + a shared transformer block
(32H, ff=10240) applied every 6 layers; ssm_state=64, vocab=32000.
[arXiv:2411.15242; hf]  Simplification (DESIGN.md): one shared block (the
upstream model alternates two) with concat(h, embeddings) input projection."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    pattern=((9, ("mamba",) * 6 + ("shared_attn",)),),
    ssm_state=64, ssm_d_inner=5120, ssm_head_dim=64, ssm_conv=4,
    rope_theta=1e4, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=6, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, ssm_state=16, ssm_d_inner=256, ssm_head_dim=32,
    pattern=((3, ("mamba",) * 2 + ("shared_attn",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

"""Llama-3.2-Vision-11B [vlm]: 40L d=4096 32H (GQA kv=8) ff=14336
vocab=128256 — gated cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Frontend stub per assignment: input_specs() provides precomputed vision
patch embeddings [B, 1024, 1280]; only the language backbone is modeled."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    pattern=((8, ("attn",) * 4 + ("cross",)),),
    n_vision_tokens=1024, vision_dim=1280,
    rope_theta=5e5, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, n_vision_tokens=16, vision_dim=32,
    pattern=((2, ("attn",) + ("cross",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

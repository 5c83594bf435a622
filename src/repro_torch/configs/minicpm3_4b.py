"""MiniCPM3-4B [dense]: 62L d=2560 40H ff=6400 vocab=73448 — MLA
(multi-head latent attention). [hf:openbmb/MiniCPM3-4B; hf]"""
import dataclasses
from .base import MLA, ModelConfig, register

CFG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=6400, vocab=73448,
    mla=MLA(q_lora=768, kv_lora=256, nope=64, rope=32, v=64),
    pattern=((62, ("mla",)),),
    rope_theta=1e4, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512, mla=MLA(q_lora=64, kv_lora=32, nope=16, rope=8, v=16),
    pattern=((4, ("mla",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

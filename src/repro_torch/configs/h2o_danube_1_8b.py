"""H2O-Danube-1.8B [dense]: 24L d=2560 32H (GQA kv=8) ff=6912 vocab=32000 —
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; hf]"""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000,
    window=4096, rope_theta=1e4, act="swiglu", norm="rms",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, window=64, pattern=((3, ("attn",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

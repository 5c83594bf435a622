"""MusicGen-medium [audio]: 48L d=1536 24H (MHA) ff=6144 vocab=2048 —
decoder-only over 4 EnCodec codebook streams. [arXiv:2306.05284; hf]
Frontend stub per assignment: input_specs() provides precomputed frame
tokens; the 4 codebooks are summed at the embedding and predicted by 4
parallel heads."""
import dataclasses
from .base import ModelConfig, register

CFG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048,
    n_codebooks=4, norm="ln", act="gelu", pos="sinusoidal",
)

REDUCED = dataclasses.replace(
    CFG, n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=192, vocab=128, n_codebooks=2, pattern=((3, ("attn",)),),
    dtype="float32", param_dtype="float32", remat="none", loss_chunk=64,
)
register(CFG, REDUCED)

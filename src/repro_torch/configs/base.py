"""Model configuration: one frozen dataclass drives every architecture.

The port's copy of ``repro.configs.base`` (the reference; the port imports
nothing of it).  The layer stack is described by ``pattern``: a tuple of
segments, each ``(repeat, (block_kind, ...))``.  The reference lowers a
segment to a ``lax.scan`` over ``repeat`` stacked groups; the port keeps the
same stacked ``[repeat, ...]`` parameters and loops over them in Python.

Block kinds: ``attn`` (self-attn + MLP), ``local`` / ``global`` (gemma3
window/full alternation), ``attn_moe`` (self-attn + MoE FFN), ``mamba``
(Mamba-2 SSD), ``shared_attn`` (zamba2 shared transformer block; parameters
shared across invocations), ``rwkv`` (RWKV-6 time-mix + channel-mix),
``cross`` (cross-attention to stub vision embeddings + MLP).  The port
runs every kind and all ten architectures (:data:`PORTED`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLA:
    q_lora: int
    kv_lora: int
    nope: int
    rope: int
    v: int

    def __getitem__(self, key):  # attention.py uses mapping-style access
        return getattr(self, key)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple = ()       # ((repeat, (kind, ...)), ...); default uniform attn

    # attention
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4
    window: int = 0           # sliding window for "attn" blocks (0 = full)
    local_window: int = 0     # window for "local" blocks (gemma3)
    mla: Optional[MLA] = None

    # moe
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    moe_router: str = "softmax_topk"     # qwen3 | "topk_softmax" (mixtral)
    moe_dispatch: str = "dense_onehot"   # | ragged_sort
    moe_capacity_factor: float = 1.25
    moe_local_groups: int = 1            # >1: dispatch locally per dp shard
    moe_aux_coef: float = 0.01

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_d_inner: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # rwkv
    rwkv_head_dim: int = 64

    # embeddings / io
    norm: str = "rms"
    act: str = "swiglu"
    pos: str = "rope"         # rope | sinusoidal
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    n_codebooks: int = 0      # musicgen EnCodec streams
    n_vision_tokens: int = 0  # llama-vision stub patch embeddings
    vision_dim: int = 0

    # compute knobs (perf levers; see EXPERIMENTS.md §Perf)
    sequence_parallel: bool = False  # shard residual-stream seq over 'model'
    attn_schedule: str = "masked"   # masked | tri
    block_q: int = 512
    block_k: int = 512
    ssm_chunk: int = 128
    rwkv_chunk: int = 64
    loss_chunk: int = 1024          # sequence-chunked loss (bounds logits memory)
    remat: str = "block"            # none | block
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if not self.pattern:
            object.__setattr__(self, "pattern", ((self.n_layers, ("attn",)),))

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    def layer_count(self) -> int:
        """Real transformer layers implied by the pattern (shared blocks
        counted once per invocation)."""
        return sum(rep * len(kinds) for rep, kinds in self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


_REGISTRY: dict[str, "ModelConfig"] = {}
_REDUCED: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _REDUCED[cfg.name] = reduced
    return cfg


#: Architectures the port runs (config module of each).
PORTED = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen3-32b": "qwen3_32b",
    "gemma3-4b": "gemma3_4b",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "minicpm3-4b": "minicpm3_4b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    """The architectures the port runs."""
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    import importlib
    for mod in PORTED.values():
        importlib.import_module(f"repro_torch.configs.{mod}")


# -- shapes (assignment) -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic attention; skipped for pure full-attention
# archs per the assignment (see DESIGN.md §3 / EXPERIMENTS.md §Dry-run).
LONG_CONTEXT_ARCHS = {
    "h2o-danube-1.8b",   # SWA bounds the KV working set
    "gemma3-4b",         # 5:1 local:global — local layers ring-buffered
    "zamba2-2.7b",       # hybrid: O(1) SSM state + SWA'd shared attention
    "mixtral-8x7b",      # SWA
    "rwkv6-7b",          # attention-free
}


# Production performance overlay (EXPERIMENTS.md §Perf): the dry-run
# baseline table uses the naive settings above; these are the settings the
# framework ships with for real runs.  Applied by
# ``dryrun --tag optimized --override`` and recorded separately.
# sequence_parallel applies to pure-transformer stacks only: it regresses
# MoE (dispatch flatten crosses shard boundaries: +44x collectives measured
# on qwen3-moe) and Mamba (chunk scan needs full sequences) — see
# EXPERIMENTS.md §Perf E.
PERF_OVERRIDES = {
    "attn_schedule": "tri",          # skip causally-dead tiles (-38% flops)
    "moe_dispatch": "ragged_sort",   # no (T,E,C) one-hot dispatch tensors
    "sequence_parallel": True,       # RS+AG instead of AR around TP blocks
}


def cells(arch: str) -> list[str]:
    """The shape cells this arch runs (assignment: skip long_500k for pure
    full-attention archs)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out

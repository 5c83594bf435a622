"""Decoder LM, dense subset: the ``attn`` / ``local`` / ``global`` blocks.

The port of ``repro.models.model`` for the architectures built only of
those kinds (h2o-danube-1.8b, qwen3-32b, gemma3-4b).  Parameters are a
:class:`ModelParams` module whose parameter names are the reference's
pytree paths (``seg0.blk0.attn.wq.w``), each segment's blocks stacked
``[repeat, ...]`` as the reference's ``lax.scan`` carries them; the port
loops over the repeats in Python (``cfg.remat`` has no effect: this slice
does not train).  Caches are nested dicts of the same stacked layout.

Entry points:
  * ``init_params(cfg, seed, device)``                      — ModelParams
  * ``forward_hidden(params, cfg, batch)``                  — [B,S,d]
  * ``init_caches(cfg, batch, max_len)``                    — decode state
  * ``prefill(params, cfg, batch, max_len)``                — logits, caches
  * ``decode_step(params, cfg, caches, batch, pos)``        — logits, caches

Other block kinds (``mamba``, ``rwkv``, ``mla``, ``attn_moe``, ``cross``,
``shared_attn``), codebook inputs and ``loss_fn`` raise
``NotImplementedError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from . import attention as A
from .layers import (Init, draw, embed, embedding_init, linear_init, mlp,
                     mlp_init, norm_apply, norm_init, sinusoidal_positions)

NEG_INF = -1e30
DENSE_KINDS = ("attn", "local", "global")

#: Block kinds of the reference the port does not run yet, with the slice
#: that brings each.
_LATER = {
    "mamba": "the zamba2 serving slice",
    "shared_attn": "the zamba2 serving slice",
    "rwkv": "the rwkv6 serving slice",
    "attn_moe": "the slice of the remaining block kinds",
    "mla": "the slice of the remaining block kinds",
    "cross": "the slice of the remaining block kinds",
}


def _dt(cfg, which="param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if which == "param" else cfg.dtype)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    for _, kinds in cfg.pattern:
        for kind in kinds:
            if kind in _LATER:
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet; it comes with "
                    f"{_LATER[kind]}")
            if kind not in DENSE_KINDS:
                raise ValueError(f"unknown block kind {kind}")
    if cfg.n_codebooks:
        raise NotImplementedError(
            "codebook inputs (musicgen) are not ported yet; they come with "
            "the slice of the remaining block kinds")
    if cfg.n_vision_tokens:
        raise NotImplementedError(
            "vision inputs are not ported yet; they come with the slice of "
            "the remaining block kinds")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(cfg) -> dict:
    d = cfg.d_model
    return {"ln1": norm_init(cfg.norm, d),
            "attn": A.attn_init(cfg),
            "ln2": norm_init(cfg.norm, d),
            "mlp": mlp_init(d, cfg.d_ff, cfg.act,
                            out_scale=cfg.d_ff ** -0.5
                            / math.sqrt(2 * cfg.n_layers))}


def _stacked(tree, rep: int):
    if isinstance(tree, Init):
        return tree._replace(shape=(rep,) + tuple(tree.shape))
    return {k: _stacked(v, rep) for k, v in tree.items()}


def param_specs(cfg) -> dict:
    """The parameter tree as :class:`~.layers.Init` leaves (nothing
    allocated), with the reference's paths and shapes."""
    check_supported(cfg)
    specs = {"embed": embedding_init(cfg.vocab_padded, cfg.d_model)}
    if not cfg.tie_embeddings:
        specs["head"] = linear_init(cfg.d_model, cfg.vocab_padded)
    specs["final_norm"] = norm_init(cfg.norm, cfg.d_model)
    for si, (rep, kinds) in enumerate(cfg.pattern):
        specs[f"seg{si}"] = {f"blk{j}": _stacked(_block_init(cfg), rep)
                             for j in range(len(kinds))}
    return specs


class ModelParams(nn.Module):
    """A node of the parameter tree.  ``node["wq"]`` reads like the
    reference's dicts; leaves are ``nn.Parameter``s that need no gradient
    (this slice serves, it does not train)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ModelParams(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def keys(self):
        return list(self._parameters) + list(self._modules)


def _materialize(specs, gen, dtype):
    if isinstance(specs, Init):
        return draw(specs, gen, dtype)
    return {k: _materialize(v, gen, dtype) for k, v in specs.items()}


def init_params(cfg, seed: int = 0, device="cuda") -> ModelParams:
    """Random parameters from ``seed`` in ``cfg.param_dtype`` on ``device``
    (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return ModelParams(_materialize(param_specs(cfg), gen, _dt(cfg)))


def count_params(cfg, active_only: bool = False) -> int:
    """Exact parameter count from the port's init shapes (dense kinds only:
    every parameter is active)."""
    def total(tree):
        if isinstance(tree, Init):
            return int(np.prod(tree.shape))
        return sum(total(v) for v in tree.values())
    return total(param_specs(cfg))


def _layer(tree, li: int) -> dict:
    """Repeat ``li`` of a stacked block: a dict of views, no copy."""
    if isinstance(tree, torch.Tensor):
        return tree[li]
    return {k: _layer(tree[k], li) for k in tree.keys()}


# ---------------------------------------------------------------------------
# block application (sequence mode: prefill)
# ---------------------------------------------------------------------------

def _attn_kind_args(cfg, kind):
    if kind == "local":
        return dict(window=cfg.local_window, theta=cfg.rope_theta_local)
    if kind in ("global", "shared_attn", "attn", "attn_moe"):
        w = cfg.window if kind in ("attn", "attn_moe") else 0
        return dict(window=w, theta=cfg.rope_theta)
    return dict(window=0, theta=cfg.rope_theta)


def _apply_block_seq(kind, p, cfg, x, ctx, want_cache):
    """Returns (x, cache_entry_or_None)."""
    ka = _attn_kind_args(cfg, kind)
    h = norm_apply(cfg.norm, p["ln1"], x)
    out = A.gqa_forward(p["attn"], cfg, h, ctx["positions"], causal=True,
                        schedule=cfg.attn_schedule, block_q=cfg.block_q,
                        block_k=cfg.block_k, return_kv=want_cache, **ka)
    if want_cache:
        y, (k, v) = out
        cache = _ring_pack(k, v, ka["window"], ctx["max_len"])
    else:
        y, cache = out, None
    x = x + y
    x = x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
    return x, cache


def _ring_pack(k, v, window, max_len):
    """Convert full prefill K/V to the decode cache layout (ring for SWA)."""
    b, s = k.shape[:2]
    c = min(window, max_len) if window > 0 else max_len
    ck = k.new_zeros((b, c) + tuple(k.shape[2:]))
    cv = v.new_zeros((b, c) + tuple(v.shape[2:]))
    if s <= c:
        ck[:, :s] = k
        cv[:, :s] = v
    else:
        slots = torch.remainder(torch.arange(s - c, s, device=k.device), c)
        ck[:, slots] = k[:, s - c:]
        cv[:, slots] = v[:, s - c:]
    return {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# forward (sequence)
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg, batch, *, pos_offset=0):
    adt = _dt(cfg, "act")
    x = embed(params["embed"], batch["tokens"]).to(adt)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.pos == "sinusoidal":
        s = x.shape[1]
        x = x + sinusoidal_positions(s, cfg.d_model, offset=pos_offset,
                                     device=x.device).to(adt)[None]
    return x


@torch.no_grad()
def forward_hidden(params, cfg, batch, *, want_caches=False, max_len=0):
    """Full-sequence forward. Returns (hidden, caches, aux); ``aux`` is 0
    (no MoE in the dense kinds)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    ctx = {"positions": positions, "max_len": max_len if max_len else s}
    caches = {}
    for si, (rep, kinds) in enumerate(cfg.pattern):
        seg_params = params[f"seg{si}"]
        layer_caches = []
        for li in range(rep):
            new_caches = {}
            for j, kind in enumerate(kinds):
                x, cache = _apply_block_seq(
                    kind, _layer(seg_params[f"blk{j}"], li), cfg, x, ctx,
                    want_caches)
                if want_caches:
                    new_caches[f"blk{j}"] = cache
            layer_caches.append(new_caches)
        if want_caches:
            caches[f"seg{si}"] = {
                f"blk{j}": {n: torch.stack([lc[f"blk{j}"][n]
                                            for lc in layer_caches])
                            for n in ("k", "v")}
                for j in range(len(kinds))}
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, (caches if want_caches else None), torch.zeros(())


def head_logits(params, cfg, x):
    """x: [B, S, d] -> float32 logits [B, S, vocab_padded].  The product
    runs in full float32: TF32 is switched off around it, as the
    reference's float32 matmul does not round its operands."""
    w = params["embed"]["table"].T if cfg.tie_embeddings \
        else params["head"]["w"]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def loss_fn(*args, **kwargs):
    raise NotImplementedError(
        "loss_fn is not ported yet; it comes with the training slice")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch_size: int, max_len: int, device="cuda"):
    """Zeroed decode caches ``{"segI": {"blkJ": {"k", "v"}}}``, each
    ``[repeat, B, C, Hk, D]`` with C the window for windowed layers."""
    check_supported(cfg)
    dev = resolve_device(device)
    adt = _dt(cfg, "act")
    caches = {}
    for si, (rep, kinds) in enumerate(cfg.pattern):
        seg = {}
        for j, kind in enumerate(kinds):
            c_full = max_len
            if kind == "attn" and cfg.window > 0:
                c_full = min(cfg.window, max_len)
            if kind == "local":
                c_full = min(cfg.local_window, max_len)
            shape = (rep, batch_size, c_full, cfg.n_kv_heads, cfg.head_dim)
            seg[f"blk{j}"] = {"k": torch.zeros(shape, dtype=adt, device=dev),
                              "v": torch.zeros(shape, dtype=adt, device=dev)}
        caches[f"seg{si}"] = seg
    return caches


@torch.no_grad()
def prefill(params, cfg, batch, max_len: int):
    """Run the prompt, return (last-token logits, caches)."""
    x, caches, _ = forward_hidden(params, cfg, batch, want_caches=True,
                                  max_len=max_len)
    return head_logits(params, cfg, x[:, -1:]), caches


def _apply_block_decode(kind, p, cfg, x, cache, ctx):
    ka = _attn_kind_args(cfg, kind)
    h = norm_apply(cfg.norm, p["ln1"], x)
    # The reference's ring test (cache shorter than max_len) picks the
    # layer's window in both branches, so the window is passed as is and
    # decode needs no max_len (nor the reference's _caches_max_len).
    y, ck, cv = A.gqa_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                             ctx["pos"], window=ka["window"],
                             theta=ka["theta"])
    x = x + y
    x = x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
    return x, {"k": ck, "v": cv}


@torch.no_grad()
def decode_step(params, cfg, caches, batch, pos):
    """One token for every sequence in the batch.

    batch: {"tokens": [B,1]}; pos: [B] absolute position.  Returns (logits
    [B,1,vocab_padded], caches).  The caches are updated in place (the
    reference returns new ones) and returned.
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch, pos_offset=pos[0])
    ctx = {"pos": pos}
    for si, (rep, kinds) in enumerate(cfg.pattern):
        seg_params = params[f"seg{si}"]
        seg_cache = caches[f"seg{si}"]
        for li in range(rep):
            for j, kind in enumerate(kinds):
                x, _ = _apply_block_decode(
                    kind, _layer(seg_params[f"blk{j}"], li), cfg, x,
                    _layer(seg_cache[f"blk{j}"], li), ctx)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return head_logits(params, cfg, x), caches

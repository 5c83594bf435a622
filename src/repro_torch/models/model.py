"""Composable decoder LM covering all ten architectures.

The port of ``repro.models.model`` for every block kind: ``attn`` /
``local`` / ``global`` (h2o-danube-1.8b, qwen3-32b, gemma3-4b, musicgen),
``attn_moe`` (qwen3-moe-30b-a3b, mixtral-8x7b), ``mla`` (minicpm3-4b),
``cross`` (llama-3.2-vision-11b, beside ``attn``), ``mamba`` with
``shared_attn`` (zamba2-2.7b) and ``rwkv`` (rwkv6-7b); musicgen's codebook
inputs and heads, and llama-vision's stub vision inputs.  Parameters are
a :class:`ModelParams` module whose parameter names are the reference's
pytree paths (``seg0.blk0.attn.wq.w``), each segment's blocks stacked
``[repeat, ...]`` as the reference's ``lax.scan`` carries them; the port
loops over the repeats in Python over views of one ``unbind`` of each
leaf, so a gradient comes back as one stack per leaf, not a zeroed stack
per layer.  ``cfg.remat == "block"`` checkpoints each repeat's blocks
under a gradient, as the reference's ``jax.checkpoint`` does, and the loss
checkpoints each of its chunks.  The shared block's parameters live once in
``params["shared"]``; its stacked entry is empty.  Caches are nested dicts
of the same stacked layout: attention ``k``/``v`` (a cross block's hold the
projected vision tokens), MLA ``ckv``/``kr``, mamba ``h`` (float32) and
``conv``, rwkv ``s`` (float32), ``prev`` and ``cm_prev``.

Entry points:
  * ``init_params(cfg, seed, device)``                      — ModelParams
  * ``forward_hidden(params, cfg, batch)``                  — [B,S,d]
  * ``loss_fn(params, cfg, batch)``                         — loss, metrics
  * ``init_caches(cfg, batch, max_len)``                    — decode state
  * ``prefill(params, cfg, batch, max_len)``                — logits, caches
  * ``decode_step(params, cfg, caches, batch, pos)``        — logits, caches

A batch holds ``tokens`` [B, S] (musicgen: ``codes`` [B, S, nq]) and, for
llama-vision, ``vision`` [B, n_vision_tokens, vision_dim]; the loss also
reads ``labels`` [B, S] (musicgen: [B, S, nq]).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from . import attention as A
from . import moe as MOE
from . import rwkv as RW
from . import ssm as SSM
from .layers import (Init, draw, embed, embedding_init, linear, linear_init,
                     mlp, mlp_init, norm_apply, norm_init, rmsnorm,
                     sinusoidal_positions)

NEG_INF = -1e30
DENSE_KINDS = ("attn", "local", "global")
KINDS = DENSE_KINDS + ("attn_moe", "mla", "cross", "mamba", "shared_attn",
                       "rwkv")


def _dt(cfg, which="param") -> torch.dtype:
    return getattr(torch, cfg.param_dtype if which == "param" else cfg.dtype)


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a block kind the model does not know."""
    for _, kinds in cfg.pattern:
        for kind in kinds:
            if kind not in KINDS:
                raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(kind: str, cfg) -> dict:
    d = cfg.d_model
    if kind in DENSE_KINDS:
        return {"ln1": norm_init(cfg.norm, d),
                "attn": A.attn_init(cfg),
                "ln2": norm_init(cfg.norm, d),
                "mlp": mlp_init(d, cfg.d_ff, cfg.act,
                                out_scale=cfg.d_ff ** -0.5
                                / math.sqrt(2 * cfg.n_layers))}
    if kind == "attn_moe":
        return {"ln1": norm_init(cfg.norm, d), "attn": A.attn_init(cfg),
                "ln2": norm_init(cfg.norm, d), "moe": MOE.moe_init(cfg)}
    if kind == "mamba":
        return {"ln1": norm_init(cfg.norm, d), "mamba": SSM.mamba2_init(cfg)}
    if kind == "rwkv":
        return {"ln1": norm_init("ln", d), "tm": RW.rwkv6_init(cfg),
                "ln2": norm_init("ln", d), "cm": RW.channelmix_init(cfg)}
    if kind == "cross":
        # The gate starts at zero: a fresh cross block adds nothing.
        return {"ln1": norm_init(cfg.norm, d),
                "attn": A.attn_init(cfg, cross=True, kv_dim=cfg.vision_dim),
                "ln2": norm_init(cfg.norm, d),
                "mlp": mlp_init(d, cfg.d_ff, cfg.act),
                "gate": Init("zeros", (1,))}
    if kind == "mla":
        return {"ln1": norm_init(cfg.norm, d), "attn": A.mla_init(cfg),
                "ln2": norm_init(cfg.norm, d),
                "mlp": mlp_init(d, cfg.d_ff, cfg.act)}
    return {}  # shared_attn: parameters live in params["shared"]


def _shared_attn_init(cfg) -> dict:
    d = cfg.d_model
    return {"in_proj": linear_init(2 * d, d),
            "ln1": norm_init(cfg.norm, d),
            "attn": A.attn_init(cfg),
            "ln2": norm_init(cfg.norm, d),
            "mlp": mlp_init(d, cfg.d_ff, cfg.act)}


def _has_shared(cfg) -> bool:
    return any("shared_attn" in kinds for _, kinds in cfg.pattern)


def _stacked(tree, rep: int):
    if isinstance(tree, Init):
        return tree._replace(shape=(rep,) + tuple(tree.shape))
    return {k: _stacked(v, rep) for k, v in tree.items()}


def param_specs(cfg) -> dict:
    """The parameter tree as :class:`~.layers.Init` leaves (nothing
    allocated), with the reference's paths and shapes."""
    check_supported(cfg)
    if cfg.n_codebooks:
        specs = {"embed": {"codes": Init(
            "normal", (cfg.n_codebooks, cfg.vocab_padded, cfg.d_model),
            0.02)}}
    else:
        specs = {"embed": embedding_init(cfg.vocab_padded, cfg.d_model)}
    if not cfg.tie_embeddings:
        specs["head"] = linear_init(
            cfg.d_model, cfg.vocab_padded * max(1, cfg.n_codebooks))
    specs["final_norm"] = norm_init(cfg.norm, cfg.d_model)
    if _has_shared(cfg):
        specs["shared"] = _shared_attn_init(cfg)
    for si, (rep, kinds) in enumerate(cfg.pattern):
        specs[f"seg{si}"] = {f"blk{j}": _stacked(_block_init(kind, cfg), rep)
                             for j, kind in enumerate(kinds)}
    return specs


class ModelParams(nn.Module):
    """A node of the parameter tree.  ``node["wq"]`` reads like the
    reference's dicts; leaves are ``nn.Parameter``s created frozen, as
    serving wants them.  ``params.requires_grad_(True)`` makes them train
    (``repro_torch.train.train_step.init_state`` does)."""

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
    """Random parameters from ``seed`` in ``cfg.param_dtype`` (float32 where
    the reference pins it) on ``device`` (the card unless the caller asks
    for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return ModelParams(_materialize(param_specs(cfg), gen, _dt(cfg)))


def count_params(cfg, active_only: bool = False) -> int:
    """Exact parameter count from the port's init shapes; ``active_only``
    leaves out the experts a token does not reach (all but ``top_k`` of
    each MoE block), as the reference's ``count_params_analytic``."""
    def total(tree):
        if isinstance(tree, Init):
            return int(np.prod(tree.shape))
        return sum(total(v) for v in tree.values())
    n = total(param_specs(cfg))
    if active_only and cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.expert_ff
        n_moe = sum(rep * kinds.count("attn_moe") for rep, kinds in cfg.pattern)
        n -= n_moe * per_expert * (cfg.n_experts - cfg.top_k)
    return n


def _layers(tree, rep: int) -> list:
    """Every repeat of a stacked block, from one ``unbind`` per leaf: views,
    no copy, whose gradients autograd stacks once into the leaf's."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    subs = {k: _layers(tree[k], rep) for k in tree.keys()}
    return [{k: v[li] for k, v in subs.items()} for li in range(rep)]


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


def _apply_block_seq(kind, p, shared, cfg, x, ctx, want_cache):
    """Returns (x, cache entry or None, float32 aux loss or None)."""
    if kind == "mamba":
        h = norm_apply(cfg.norm, p["ln1"], x)
        if want_cache:
            y, st = SSM.mamba2_forward(p["mamba"], cfg, h, chunk=cfg.ssm_chunk,
                                       return_state=True)
            return x + y, st, None
        return x + SSM.mamba2_forward(p["mamba"], cfg, h,
                                      chunk=cfg.ssm_chunk), None, None
    if kind == "rwkv":
        h = norm_apply("ln", p["ln1"], x)
        if want_cache:
            y, tm_state = RW.rwkv6_timemix(p["tm"], cfg, h,
                                           chunk=cfg.rwkv_chunk,
                                           return_state=True)
            x = x + y
            h2 = norm_apply("ln", p["ln2"], x)
            y2, cm_prev = RW.channelmix(p["cm"], cfg, h2, return_state=True)
            return x + y2, {"s": tm_state["s"], "prev": tm_state["prev"],
                            "cm_prev": cm_prev}, None
        x = x + RW.rwkv6_timemix(p["tm"], cfg, h, chunk=cfg.rwkv_chunk)
        x = x + RW.channelmix(p["cm"], cfg, norm_apply("ln", p["ln2"], x))
        return x, None, None
    if kind == "mla":
        h = norm_apply(cfg.norm, p["ln1"], x)
        out = A.mla_forward(p["attn"], cfg, h, ctx["positions"],
                            return_cache=want_cache,
                            schedule=cfg.attn_schedule)
        if want_cache:
            y, (ckv, kr) = out
            cache = _mla_pack(ckv, kr, ctx["max_len"])
        else:
            y, cache = out, None
        x = x + y
        x = x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
        return x, cache, None
    if kind == "cross":
        h = norm_apply(cfg.norm, p["ln1"], x)
        q, k, v = A.gqa_project(p["attn"], cfg, h, ctx["positions"],
                                theta=cfg.rope_theta, kv_src=ctx["vision"],
                                rope=False)
        o = A.dense_attention(q, k, v, causal=False)
        y = linear(p["attn"]["wo"], o.reshape(x.shape[0], x.shape[1], -1))
        x = x + torch.tanh(p["gate"]).to(x.dtype) * y
        x = x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
        return x, ({"k": k, "v": v} if want_cache else None), None
    if kind == "shared_attn":
        # The shared block projects [x, x0] (x0: the step's embedded input)
        # and takes the config's window, as the reference's prefill does.
        p = shared
        h = linear(p["in_proj"], torch.cat([x, ctx["x0"]], dim=-1))
        h = norm_apply(cfg.norm, p["ln1"], h)
        ka = dict(window=cfg.window, theta=cfg.rope_theta)
    else:
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
    h2 = norm_apply(cfg.norm, p["ln2"], x)
    if kind == "attn_moe":
        ff, aux = MOE.moe_forward(p["moe"], cfg, h2)
        return x + ff, cache, aux
    return x + mlp(p["mlp"], h2, cfg.act), cache, None


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


def _mla_pack(ckv, kr, max_len):
    """The prefill's latent cache entries in ``max_len`` rows."""
    b, s = ckv.shape[:2]
    out_c = ckv.new_zeros((b, max_len, ckv.shape[-1]))
    out_r = kr.new_zeros((b, max_len, kr.shape[-1]))
    out_c[:, :s] = ckv
    out_r[:, :s] = kr
    return {"ckv": out_c, "kr": out_r}


# ---------------------------------------------------------------------------
# forward (sequence)
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg, batch, *, pos_offset=0):
    adt = _dt(cfg, "act")
    if cfg.n_codebooks:
        # The nq embeddings summed in the parameter dtype from 0, codebook
        # by codebook, as the reference's Python sum.
        codes = batch["codes"]                               # [B, S, nq]
        tables = params["embed"]["codes"]
        x = sum(embed({"table": tables[q]}, codes[..., q])
                for q in range(cfg.n_codebooks))
    else:
        x = embed(params["embed"], batch["tokens"])
    x = x.to(adt)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.pos == "sinusoidal":
        s = x.shape[1]
        x = x + sinusoidal_positions(s, cfg.d_model, offset=pos_offset,
                                     device=x.device).to(adt)[None]
    return x


def forward_hidden(params, cfg, batch, *, want_caches=False, max_len=0):
    """Full-sequence forward. Returns (hidden, caches, aux): ``aux`` is the
    float32 sum of the MoE blocks' load-balancing losses (0 without).
    Under a gradient with ``cfg.remat == "block"`` each repeat's blocks are
    recomputed in the backward (``torch.utils.checkpoint``)."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    vision = batch.get("vision")
    if vision is not None:
        vision = vision.to(x.dtype)
    elif any("cross" in kinds for _, kinds in cfg.pattern):
        raise ValueError(f"{cfg.name}'s cross blocks need batch['vision'] "
                         f"[B, {cfg.n_vision_tokens}, {cfg.vision_dim}]")
    ctx = {"positions": positions, "x0": x, "vision": vision,
           "max_len": max_len if max_len else s}
    shared = params["shared"] if _has_shared(cfg) else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    remat = (cfg.remat == "block" and torch.is_grad_enabled()
             and not want_caches)
    for si, (rep, kinds) in enumerate(cfg.pattern):
        layers = _layers(params[f"seg{si}"], rep)
        layer_caches = []
        for li in range(rep):
            new_caches = {}

            def body(x, aux_total, p_g=layers[li], kinds=kinds):
                for j, kind in enumerate(kinds):
                    x, cache, aux = _apply_block_seq(
                        kind, p_g[f"blk{j}"], shared, cfg, x, ctx,
                        want_caches)
                    if aux is not None:
                        aux_total = aux_total + aux
                    if want_caches:
                        new_caches[f"blk{j}"] = cache
                return x, aux_total

            if remat:
                x, aux_total = checkpoint(body, x, aux_total,
                                          use_reentrant=False)
            else:
                x, aux_total = body(x, aux_total)
            layer_caches.append(new_caches)
        if want_caches:
            # Each leaf stacked per repeat, as the reference's scan does.
            caches[f"seg{si}"] = {
                f"blk{j}": {n: torch.stack([lc[f"blk{j}"][n]
                                            for lc in layer_caches])
                            for n in layer_caches[0][f"blk{j}"]}
                for j in range(len(kinds))}
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return x, (caches if want_caches else None), aux_total


def head_logits(params, cfg, x):
    """x: [B, S, d] -> float32 logits [B, S, vocab_padded] (codebooks:
    [B, S, nq, vocab_padded]).  The product runs in full float32: TF32 is
    switched off around it, as the reference's float32 matmul does not
    round its operands."""
    w = params["embed"]["table"].T if cfg.tie_embeddings \
        else params["head"]["w"]
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits = x.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    if cfg.n_codebooks:
        b, s = x.shape[:2]
        return logits.reshape(b, s, cfg.n_codebooks, cfg.vocab_padded)
    return logits


def _vocab_mask(cfg, device=None) -> torch.Tensor:
    cols = torch.arange(cfg.vocab_padded, device=device)
    return torch.where(cols < cfg.vocab, 0.0, NEG_INF)


def _ce(cfg, logits, labels):
    """Cross-entropy over the (padded, masked) vocab; logits float32."""
    logits = logits + _vocab_mask(cfg, logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    return lse - gold


def loss_fn(params, cfg, batch):
    """Chunked-over-sequence LM loss; returns (loss, {"ce", "aux"}).

    The float32 logits of one ``cfg.loss_chunk`` of the sequence at a time
    go through the head and the cross-entropy; under a gradient each chunk
    is checkpointed, so its logits are recomputed in the backward and
    ``loss_chunk`` bounds their memory, as the reference's scan does.  The
    loss is ``ce + moe_aux_coef * aux / layer_count``."""
    x, _, aux = forward_hidden(params, cfg, batch)
    labels = batch["labels"]
    b, s = x.shape[:2]
    chunk = min(cfg.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss_chunk {chunk} != 0")

    def chunk_ce(xc, lc):
        return _ce(cfg, head_logits(params, cfg, xc), lc).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        xc, lc = x[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:
                                                          (c + 1) * chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_ce, xc, lc, use_reentrant=False)
        else:
            total = total + chunk_ce(xc, lc)
    denom = b * s * max(1, cfg.n_codebooks)
    loss = total / denom + cfg.moe_aux_coef * aux / max(1, cfg.layer_count())
    return loss, {"ce": total / denom, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch_size: int, max_len: int, device="cuda"):
    """Zeroed decode caches ``{"segI": {"blkJ": {...}}}``, each leaf
    ``[repeat, B, ...]``: attention ``k``/``v`` ``[.., C, Hk, D]`` with C the
    window for windowed layers (a cross block's C is the vision tokens');
    MLA ``ckv`` ``[.., max_len, kv_lora]`` and ``kr`` ``[.., max_len,
    rope]``; mamba ``h`` ``[.., H, P, N]`` (float32) and ``conv`` ``[..,
    conv - 1, d_inner + 2 N]``; rwkv ``s`` ``[.., H, K, K]`` (float32),
    ``prev`` and ``cm_prev`` ``[.., 1, d]``."""
    check_supported(cfg)
    dev = resolve_device(device)
    adt = _dt(cfg, "act")
    f32 = torch.float32

    def zeros(shape, dtype=adt):
        return torch.zeros((rep, batch_size) + shape, dtype=dtype, device=dev)

    caches = {}
    for si, (rep, kinds) in enumerate(cfg.pattern):
        seg = {}
        for j, kind in enumerate(kinds):
            if kind == "mamba":
                heads = cfg.ssm_d_inner // cfg.ssm_head_dim
                seg[f"blk{j}"] = {
                    "h": zeros((heads, cfg.ssm_head_dim, cfg.ssm_state), f32),
                    "conv": zeros((cfg.ssm_conv - 1,
                                   cfg.ssm_d_inner + 2 * cfg.ssm_state))}
                continue
            if kind == "rwkv":
                heads = cfg.d_model // cfg.rwkv_head_dim
                hd = cfg.rwkv_head_dim
                seg[f"blk{j}"] = {"s": zeros((heads, hd, hd), f32),
                                  "prev": zeros((1, cfg.d_model)),
                                  "cm_prev": zeros((1, cfg.d_model))}
                continue
            if kind == "mla":
                seg[f"blk{j}"] = {"ckv": zeros((max_len, cfg.mla.kv_lora)),
                                  "kr": zeros((max_len, cfg.mla.rope))}
                continue
            c_full = max_len
            if kind in ("attn", "attn_moe") and cfg.window > 0:
                c_full = min(cfg.window, max_len)
            if kind == "local":
                c_full = min(cfg.local_window, max_len)
            if kind == "cross":
                c_full = cfg.n_vision_tokens
            shape = (c_full, cfg.n_kv_heads, cfg.head_dim)
            seg[f"blk{j}"] = {"k": zeros(shape), "v": zeros(shape)}
        caches[f"seg{si}"] = seg
    return caches


@torch.no_grad()
def prefill(params, cfg, batch, max_len: int):
    """Run the prompt, return (last-token logits, caches)."""
    x, caches, _ = forward_hidden(params, cfg, batch, want_caches=True,
                                  max_len=max_len)
    return head_logits(params, cfg, x[:, -1:]), caches


def _apply_block_decode(kind, p, shared, cfg, x, cache, ctx):
    """One block of one decode step; ``cache`` (views of the stacked
    caches) is updated in place."""
    if kind == "mamba":
        h = norm_apply(cfg.norm, p["ln1"], x)
        y, st = SSM.mamba2_decode(p["mamba"], cfg, h, cache)
        for name in ("h", "conv"):
            cache[name].copy_(st[name])
        return x + y
    if kind == "rwkv":
        h = norm_apply("ln", p["ln1"], x)
        y, tm = RW.rwkv6_decode(p["tm"], cfg, h, {"s": cache["s"],
                                                 "prev": cache["prev"]})
        x = x + y
        h2 = norm_apply("ln", p["ln2"], x)
        y2, cm_prev = RW.channelmix(p["cm"], cfg, h2, state=cache["cm_prev"],
                                    return_state=True)
        cache["s"].copy_(tm["s"])
        cache["prev"].copy_(tm["prev"])
        cache["cm_prev"].copy_(cm_prev)
        return x + y2
    if kind == "mla":
        h = norm_apply(cfg.norm, p["ln1"], x)
        y, _, _ = A.mla_decode(p["attn"], cfg, h, cache["ckv"], cache["kr"],
                               ctx["pos"])
        x = x + y
        return x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
    if kind == "cross":
        # Against the cached vision K/V (no rope, no mask); the cache stays.
        h = norm_apply(cfg.norm, p["ln1"], x)
        q = linear(p["attn"]["wq"], h).reshape(x.shape[0], 1, cfg.n_heads,
                                                cfg.head_dim)
        if cfg.qk_norm:
            q = rmsnorm(p["attn"]["qnorm"], q)
        o = A.dense_attention(q, cache["k"], cache["v"], causal=False)
        y = linear(p["attn"]["wo"], o.reshape(x.shape[0], 1, -1))
        x = x + torch.tanh(p["gate"]).to(x.dtype) * y
        return x + mlp(p["mlp"], norm_apply(cfg.norm, p["ln2"], x), cfg.act)
    # Decode takes the window of _attn_kind_args (0 for shared_attn), where
    # the shared block's prefill takes cfg.window, as in the reference.
    ka = _attn_kind_args(cfg, kind)
    if kind == "shared_attn":
        p = shared
        h = linear(p["in_proj"], torch.cat([x, ctx["x0"]], dim=-1))
        h = norm_apply(cfg.norm, p["ln1"], h)
    else:
        h = norm_apply(cfg.norm, p["ln1"], x)
    # The reference's ring test (cache shorter than max_len) picks the
    # layer's window in both branches, so the window is passed as is and
    # decode needs no max_len (nor the reference's _caches_max_len).
    y, _, _ = A.gqa_decode(p["attn"], cfg, h, cache["k"], cache["v"],
                           ctx["pos"], window=ka["window"], theta=ka["theta"])
    x = x + y
    h2 = norm_apply(cfg.norm, p["ln2"], x)
    if kind == "attn_moe":
        return x + MOE.moe_forward(p["moe"], cfg, h2)[0]
    return x + mlp(p["mlp"], h2, cfg.act)


@torch.no_grad()
def decode_step(params, cfg, caches, batch, pos):
    """One token for every sequence in the batch.

    batch: {"tokens": [B,1]} or {"codes": [B,1,nq]}; pos: [B] absolute
    position.  Returns (logits [B,1,vocab_padded] or [B,1,nq,vocab_padded],
    caches).  The caches are updated in place (the
    reference returns new ones) and returned.
    """
    check_supported(cfg)
    x = embed_inputs(params, cfg, batch, pos_offset=pos[0])
    ctx = {"pos": pos, "x0": x}
    shared = params["shared"] if _has_shared(cfg) else None
    for si, (rep, kinds) in enumerate(cfg.pattern):
        layers = _layers(params[f"seg{si}"], rep)
        layer_caches = _layers(caches[f"seg{si}"], rep)
        for li in range(rep):
            for j, kind in enumerate(kinds):
                x = _apply_block_decode(
                    kind, layers[li][f"blk{j}"], shared, cfg, x,
                    layer_caches[li][f"blk{j}"], ctx)
    x = norm_apply(cfg.norm, params["final_norm"], x)
    return head_logits(params, cfg, x), caches

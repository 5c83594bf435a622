"""Attention: blocked (flash) prefill and cached decode, grouped-query heads.

The port of the GQA part of ``repro.models.attention``: GQA with optional
qk-norm (qwen3, h2o-danube, gemma3) and sliding windows (h2o-danube, gemma3
local layers).  Prefill longer than ``block_q`` goes through
:func:`blocked_attention`, whose forward is the ``flash_attention`` kernel
on the card and its plain tile loop on the CPU.  MLA and the attention
backward wait for later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, linear, linear_init, rmsnorm, rmsnorm_init

NEG_INF = -1e30


# -- parameter init -----------------------------------------------------------

def attn_init(cfg) -> dict:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": linear_init(d, h * hd),
        "wk": linear_init(d, hk * hd),
        "wv": linear_init(d, hk * hd),
        "wo": linear_init(h * hd, d, scale=(h * hd) ** -0.5
                          / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd)
        p["knorm"] = rmsnorm_init(hd)
    return p


def _expand_kv(x, rep: int, axis: int):
    """Repeat KV heads ``rep`` times along ``axis`` (GQA), each head's copies
    adjacent, as the reference's broadcast + reshape does."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=axis)


# -- core blocked attention ----------------------------------------------------

def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      block_q=512, block_k=512, schedule="masked", scale=None):
    """Flash attention forward: q [B, Sq, H, D], k/v [B, Sk, Hk, D].

    The ``flash_attention`` kernel for a CUDA tensor (it skips dead tiles
    whatever the schedule), the reference's tile loop with ``block_q`` x
    ``block_k`` tiles for a CPU tensor.  The two schedules (``masked``,
    ``tri``) give the same output on every row with a live key: a dead tile
    contributes exactly nothing to the online softmax.  No backward: that
    comes with the training slice."""
    if schedule not in ("masked", "tri"):
        raise ValueError(f"unknown attention schedule {schedule!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "blocked_attention has no backward yet (the training slice "
            "ports the reference's _flash_bwd)")
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, scale=scale, block_q=block_q,
                           block_k=block_k)


def dense_attention(q, k, v, *, causal=True, window=0, q_offset=0, scale=None,
                    kv_len: torch.Tensor | None = None):
    """Unblocked reference / short-prefill path. q: [B,Sq,H,D], k/v:
    [B,Sk,Hk,D].  ``kv_len`` masks positions >= kv_len (partly filled
    caches)."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale = scale if scale is not None else d ** -0.5
    kk = _expand_kv(k, rep, axis=2)
    vv = _expand_kv(v, rep, axis=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kk.float())
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    rel = qpos[:, None] - kpos[None, :]
    ok = torch.ones(rel.shape, dtype=torch.bool, device=q.device)
    if causal:
        ok &= rel >= 0
    if window > 0:
        ok &= rel < window
    mask = torch.where(ok, 0.0, NEG_INF)[None, None]
    if kv_len is not None:
        mask = mask + torch.where(
            kpos[None, None, None, :] < kv_len.reshape(-1, 1, 1, 1), 0.0,
            NEG_INF)
    p = torch.softmax(s + mask, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


# -- GQA block forward ---------------------------------------------------------

def gqa_project(params, cfg, x, positions, *, theta, kv_src=None, rope=True):
    """Project to q, k, v heads (with qk-norm + rope)."""
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    q = linear(params["wq"], x).reshape(b, s, h, hd)
    k = linear(params["wk"], src).reshape(b, src.shape[1], hk, hd)
    v = linear(params["wv"], src).reshape(b, src.shape[1], hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q)
        k = rmsnorm(params["knorm"], k)
    if rope:
        q = apply_rope(q, positions, theta)
        kpos = positions if kv_src is None else \
            torch.arange(src.shape[1], device=x.device)[None, :]
        k = apply_rope(k, kpos, theta)
    return q, k, v


def gqa_forward(params, cfg, x, positions, *, causal=True, window=0,
                theta=1e4, schedule="masked", block_q=512, block_k=512,
                return_kv=False):
    q, k, v = gqa_project(params, cfg, x, positions, theta=theta)
    if x.shape[1] <= block_q:
        o = dense_attention(q, k, v, causal=causal, window=window)
    else:
        o = blocked_attention(q, k, v, causal=causal, window=window,
                              schedule=schedule, block_q=block_q,
                              block_k=block_k)
    b, s = x.shape[:2]
    y = linear(params["wo"], o.reshape(b, s, -1))
    return (y, (k, v)) if return_kv else y


def gqa_decode(params, cfg, x, cache_k, cache_v, pos, *, window=0, theta=1e4):
    """One-token decode against a (possibly ring-buffer) KV cache.

    x: [B, 1, d]; cache_k/v: [B, C, Hk, D]; pos: [B] absolute position.
    Returns (y, cache_k, cache_v).  For SWA layers the cache length C ==
    window and indexing is mod-C (ring buffer); otherwise C >= max
    positions.  Unlike the reference, which returns new caches, the new
    k/v row is written into ``cache_k``/``cache_v`` in place (they may be
    views of a stacked cache): no copy of the cache per token.
    """
    b = x.shape[0]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    c = cache_k.shape[1]
    q = linear(params["wq"], x).reshape(b, 1, h, hd)
    k = linear(params["wk"], x).reshape(b, 1, hk, hd)
    v = linear(params["wv"], x).reshape(b, 1, hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["qnorm"], q)
        k = rmsnorm(params["knorm"], k)
    q = apply_rope(q, pos[:, None], theta)
    k = apply_rope(k, pos[:, None], theta)
    slot = torch.remainder(pos, c) if window > 0 else pos
    bi = torch.arange(b, device=x.device)
    cache_k[bi, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bi, slot] = v[:, 0].to(cache_v.dtype)
    kpos = torch.arange(c, device=x.device)[None, :]
    if window > 0:
        # ring buffer: slot holds position p iff p = pos - ((slot_cur - slot) mod C)
        kp = pos[:, None] - torch.remainder(slot[:, None] - kpos, c)
        valid = kp >= 0
    else:
        valid = kpos <= pos[:, None]
    rep = h // hk
    q4 = (q.reshape(b, hk, rep, hd) * hd ** -0.5).to(cache_k.dtype)
    # The reference multiplies the cache-dtype operands with float32
    # accumulation (preferred_element_type).  torch.einsum on bf16 would
    # round scores and output to bf16, so the operands are upcast: a
    # product of two bf16 values is exact in float32.
    s = torch.einsum("bkrd,bskd->bkrs", q4.float(), cache_k.float())
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    o = torch.einsum("bkrs,bskd->bkrd", p.float(), cache_v.float())
    y = linear(params["wo"], o.reshape(b, 1, h * hd).to(x.dtype))
    return y, cache_k, cache_v


# -- MLA ------------------------------------------------------------------------

def mla_forward(*args, **kwargs):
    raise NotImplementedError(
        "MLA attention (minicpm3) is not ported yet; it comes with the "
        "slice of the remaining block kinds")


def mla_decode(*args, **kwargs):
    raise NotImplementedError(
        "MLA decode (minicpm3) is not ported yet; it comes with the slice "
        "of the remaining block kinds")

"""Attention: blocked (flash) prefill and cached decode, grouped-query heads.

The port of ``repro.models.attention``: GQA with optional qk-norm (qwen3,
qwen3-moe, h2o-danube, gemma3, zamba2, mixtral, musicgen, llama-vision),
sliding windows (h2o-danube, mixtral, gemma3 local layers), MLA with its
compressed latent cache and absorbed decode (minicpm3), and cross-attention
to stub vision embeddings (llama-vision).  Prefill and training sequences longer
than ``block_q`` (MLA: 512) go through :func:`blocked_attention`, whose
forward is the ``flash_attention`` kernel on the card and its plain tile
loop on the CPU, and whose backward (a ``torch.autograd.Function``, the
reference's ``custom_vjp``) is the ``flash_attention_bwd`` kernel on the
card and the reference's tile-recompute backward on the CPU.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention.ops import flash_attention, flash_attention_bwd
from .layers import apply_rope, linear, linear_init, rmsnorm, rmsnorm_init

NEG_INF = -1e30


# -- parameter init -----------------------------------------------------------

def attn_init(cfg, *, cross: bool = False, kv_dim: int | None = None) -> dict:
    """Self-attention projections; a cross block (``cross=True``) reads its
    keys and values from ``kv_dim``-wide inputs (the vision stub)."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kv_in = kv_dim if kv_dim is not None else d
    p = {
        "wq": linear_init(d, h * hd),
        "wk": linear_init(kv_in, hk * hd),
        "wv": linear_init(kv_in, hk * hd),
        "wo": linear_init(h * hd, d, scale=(h * hd) ** -0.5
                          / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["qnorm"] = rmsnorm_init(hd)
        p["knorm"] = rmsnorm_init(hd)
    return p


def mla_init(cfg) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m["q_lora"]
    return {
        "wdq": linear_init(d, qd),
        "qnorm": rmsnorm_init(qd),
        "wuq": linear_init(qd, h * (m["nope"] + m["rope"])),
        "wdkv": linear_init(d, m["kv_lora"]),
        "kvnorm": rmsnorm_init(m["kv_lora"]),
        "wukv": linear_init(m["kv_lora"], h * (m["nope"] + m["v"])),
        "wkr": linear_init(d, m["rope"]),
        "wo": linear_init(h * m["v"], d, scale=(h * m["v"]) ** -0.5
                          / math.sqrt(2 * cfg.n_layers)),
    }


def _expand_kv(x, rep: int, axis: int):
    """Repeat KV heads ``rep`` times along ``axis`` (GQA), each head's copies
    adjacent, as the reference's broadcast + reshape does."""
    return x if rep == 1 else x.repeat_interleave(rep, dim=axis)


# -- core blocked attention ----------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward keeps (q, k, v, out, m,
    l), nothing of size Sq x Sk, and the backward recomputes the tiles."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, m, l = flash_attention(q, k, v, return_stats=True, **kw)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None


def blocked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      block_q=512, block_k=512, schedule="masked", scale=None):
    """Flash attention: q [B, Sq, H, D], k/v [B, Sk, Hk, D].

    The ``flash_attention`` kernels for a CUDA tensor (they skip dead tiles
    whatever the schedule), the reference's tile loops with ``block_q`` x
    ``block_k`` tiles for a CPU tensor.  The two schedules (``masked``,
    ``tri``) give the same output and gradients on every row with a live
    key: a dead tile contributes exactly nothing.  When no gradient is
    wanted the forward writes no row statistics."""
    if schedule not in ("masked", "tri"):
        raise ValueError(f"unknown attention schedule {schedule!r}")
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, kw)
    return flash_attention(q, k, v, **kw)


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

#: Prompts longer than this take the head-folded flash path in
#: :func:`mla_forward` (the reference's constant, not ``cfg.block_q``).
MLA_DENSE_MAX = 512


def mla_forward(params, cfg, x, positions, *, return_cache=False,
                schedule="masked"):
    """Prefill MLA: expand the latent, run standard attention.  Past
    ``MLA_DENSE_MAX`` tokens the heads fold into the batch ([B*H, S, 1,
    nope + rope], V zero-padded to that width) and go through
    :func:`blocked_attention` with its default 512 x 512 tiles, as in the
    reference.  ``return_cache`` adds the latent cache entries (ckv [B, S,
    kv_lora], the roped shared key [B, S, rope])."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = m["nope"], m["rope"], m["v"]
    cq = rmsnorm(params["qnorm"], linear(params["wdq"], x))
    q = linear(params["wuq"], cq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv = rmsnorm(params["kvnorm"], linear(params["wdkv"], x))   # [B,S,kv_lora]
    kv = linear(params["wukv"], ckv).reshape(b, s, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k_rope = apply_rope(linear(params["wkr"], x).reshape(b, s, 1, dr),
                        positions, cfg.rope_theta)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    scale = (dn + dr) ** -0.5
    vp = _pad_v(v, dn + dr)
    if s <= MLA_DENSE_MAX:
        o = dense_attention(q_full, k_full, vp, causal=True, scale=scale)
    else:
        def fold(t):   # a copy: the kernel takes contiguous tensors
            return t.transpose(1, 2).reshape(b * h, s, 1,
                                             dn + dr).contiguous()
        of = blocked_attention(fold(q_full), fold(k_full), fold(vp),
                               causal=True, scale=scale, schedule=schedule)
        o = of.reshape(b, h, s, dn + dr).transpose(1, 2)
    o = o[..., :dv]
    y = linear(params["wo"], o.reshape(b, s, -1))
    if return_cache:
        return y, (ckv, k_rope[:, :, 0, :])
    return y


def _pad_v(v, d_target):
    pad = d_target - v.shape[-1]
    return torch.nn.functional.pad(v, (0, pad)) if pad > 0 else v


def mla_decode(params, cfg, x, cache_ckv, cache_kr, pos):
    """Absorbed-matmul decode: attention runs in the latent space, so the
    cache is just (kv_lora + rope) values per position (MLA's point), all of
    it in float32 as in the reference.  x: [B, 1, d]; cache_ckv [B, L,
    kv_lora], cache_kr [B, L, rope]; pos: [B].  The new latent row is
    written into the caches in place; returns (y, cache_ckv, cache_kr)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = m["nope"], m["rope"], m["v"]
    kv_l = m["kv_lora"]
    cq = rmsnorm(params["qnorm"], linear(params["wdq"], x))
    q = linear(params["wuq"], cq).reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
    # absorb W_uk into q: q_eff [B, H, kv_lora]
    wukv = params["wukv"]["w"].reshape(kv_l, h, dn + dv)
    q_eff = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(),
                         wukv[:, :, :dn].float())
    ckv_t = rmsnorm(params["kvnorm"], linear(params["wdkv"], x))[:, 0]
    kr_t = apply_rope(linear(params["wkr"], x).reshape(b, 1, 1, dr),
                      pos[:, None], cfg.rope_theta)[:, 0, 0]     # [B, rope]
    bi = torch.arange(b, device=x.device)
    cache_ckv[bi, pos] = ckv_t.to(cache_ckv.dtype)
    cache_kr[bi, pos] = kr_t.to(cache_kr.dtype)
    kpos = torch.arange(cache_ckv.shape[1], device=x.device)[None, :]
    valid = kpos <= pos[:, None]
    scale = (dn + dr) ** -0.5
    ckv32 = cache_ckv.float()
    s_nope = torch.einsum("bhl,bsl->bhs", q_eff, ckv32)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                          cache_kr.float())
    s = (s_nope + s_rope) * scale + torch.where(valid, 0.0,
                                                NEG_INF)[:, None, :]
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsl->bhl", p, ckv32)               # [B,H,kv_l]
    o = torch.einsum("bhl,lhd->bhd", o_lat, wukv[:, :, dn:].float())
    y = linear(params["wo"], o.reshape(b, 1, -1).to(x.dtype))
    return y, cache_ckv, cache_kr

"""RWKV-6 (Finch) block: data-dependent per-channel decay linear attention.

The port of ``repro.models.rwkv``.  Per head (head dim K = V):
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t            S: [K, V]
    y_t = r_t · (S_{t-1} + diag(u) · k_t ⊗ v_t)
with w_t = exp(-exp(w0 + LoRA(x̃_t))).  The sequence path is the chunked
WKV recurrence (:func:`wkv6_chunked`): the ``wkv6`` kernel on the card, its
plain version (the reference's ``wkv6_chunked``) on the CPU; it returns the
final state, which fills the decode cache.  Under a gradient it is an
autograd Function whose backward is ``wkv6_bwd`` (the backward kernels on
the card, their plain version on the CPU).  Decode carries (S, prev-token)
per layer.  The reference's simplifications are kept: static per-stream
token-shift mixes μ, a per-head LayerNorm in place of GroupNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv6.ops import wkv6, wkv6_bwd
from .layers import Init, layernorm, layernorm_init, linear, linear_init


def rwkv6_init(cfg) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    heads = d // hd
    lora = max(32, d // 64)
    return {
        "mu": Init("full", (5, d), value=0.5),  # r,k,v,g,w token-shift mixes
        "wr": linear_init(d, d),
        "wk": linear_init(d, d),
        "wv": linear_init(d, d),
        "wg": linear_init(d, d),
        "w0": Init("full", (d,), value=-2.0, dtype="float32"),
        "w_lora_a": linear_init(d, lora),
        "w_lora_b": linear_init(lora, d, scale=0.01),
        "u": Init("normal", (heads, hd), 0.1, dtype="float32"),
        "ln_y": layernorm_init(hd),
        "wo": linear_init(d, d),
    }


def channelmix_init(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": Init("full", (2, d), value=0.5),
        "wk": linear_init(d, f),
        "wv": linear_init(f, d),
        "wr": linear_init(d, d),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / carried last token at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


class _WKV(torch.autograd.Function):
    """``wkv6`` under a gradient.  The forward keeps the scratch its passes
    leave (each chunk's total log decay and the state entering each chunk)
    and the final state, so the backward ``wkv6_bwd`` does not run the
    forward's passes again: under remat "block" the forward already runs
    twice, and the scratch lives only while its block's backward does."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, s0, chunk):
        y, sf, cwl, s_in = wkv6(r, k, v, lw, u, chunk=chunk, s0=s0,
                                keep=True)
        ctx.chunk = chunk
        ctx.has_s0 = s0 is not None
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, lw, u, cwl, s_in, sf)
        return y, sf

    @staticmethod
    def backward(ctx, dy, dsf):
        r, k, v, lw, u, cwl, s_in, sf = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd(
            r, k, v, lw, u, dy.contiguous(),
            None if dsf is None else dsf.contiguous(), chunk=ctx.chunk,
            cwl=cwl, s_in=s_in, sf=sf)
        return dr, dk, dv, dlw, du, (ds0 if ctx.has_s0 else None), None


def wkv6_chunked(r, k, v, lw, u, *, chunk: int, s0=None):
    """Chunked RWKV-6 recurrence.

    r,k,v: [B,S,H,K]; lw: [B,S,H,K] log-decay (<= 0); u: [H,K] bonus.
    Returns y [B,S,H,K] and final state [B,H,K,K] (k-major, v-minor), both
    float32: the ``wkv6`` kernel for CUDA tensors, its plain version for CPU
    tensors; under a gradient through ``_WKV``, whose backward is the
    backward kernels on the card and their plain version on the CPU."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, lw, u, s0)):
        return _WKV.apply(r, k, v, lw, u, s0, chunk)
    return wkv6(r, k, v, lw, u, chunk=chunk, s0=s0)


def wkv6_reference(r, k, v, lw, u):
    """O(S) sequential oracle."""
    bsz, s, h, kd = r.shape
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    sprev = torch.zeros((bsz, h, kd, kd), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               sprev + u[None, :, :, None] * kv))
        sprev = sprev * torch.exp(lw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1), sprev


def rwkv6_timemix(params, cfg, x, *, chunk: int = 64, state=None,
                  return_state=False):
    """x: [B,S,d]. state: {"s": [B,H,K,K], "prev": [B,1,d]} for chunked
    prefill continuation / decode."""
    bsz, s, d = x.shape
    hd = cfg.rwkv_head_dim
    heads = d // hd
    prev = None if state is None else state["prev"]
    xx = _shift(x, prev) - x
    mu = params["mu"]
    xr = x + xx * mu[0]
    xk = x + xx * mu[1]
    xv = x + xx * mu[2]
    xg = x + xx * mu[3]
    xw = x + xx * mu[4]
    r = linear(params["wr"], xr).reshape(bsz, s, heads, hd)
    k = linear(params["wk"], xk).reshape(bsz, s, heads, hd)
    v = linear(params["wv"], xv).reshape(bsz, s, heads, hd)
    g = F.silu(linear(params["wg"], xg))
    lora = linear(params["w_lora_b"], torch.tanh(linear(params["w_lora_a"],
                                                        xw)))
    lw = -torch.exp(params["w0"] + lora.float())          # log decay <= 0
    lw = lw.reshape(bsz, s, heads, hd)
    s0 = None if state is None else state["s"]
    pad = (-s) % chunk
    if pad:
        # The tail has lw = k = v = 0: it decays by 1 and adds nothing, so
        # the final state is exact.
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    y, sf = wkv6_chunked(r, k, v, lw, params["u"], chunk=chunk, s0=s0)
    y = y[:, :s]
    y = layernorm(params["ln_y"], y.to(x.dtype))
    y = y.reshape(bsz, s, d) * g
    out = linear(params["wo"], y)
    if return_state:
        return out, {"s": sf, "prev": x[:, -1:].clone()}
    return out


def rwkv6_decode(params, cfg, x, state):
    """One-token decode; state {"s","prev"} -> (y, new_state); ``state`` is
    read, not written."""
    bsz, _, d = x.shape
    hd = cfg.rwkv_head_dim
    heads = d // hd
    xx = state["prev"] - x
    mu = params["mu"]
    r = linear(params["wr"], x + xx * mu[0]).reshape(bsz, heads, hd)
    k = linear(params["wk"], x + xx * mu[1]).reshape(bsz, heads, hd)
    v = linear(params["wv"], x + xx * mu[2]).reshape(bsz, heads, hd)
    g = F.silu(linear(params["wg"], x + xx * mu[3]))
    lora = linear(params["w_lora_b"],
                  torch.tanh(linear(params["w_lora_a"], x + xx * mu[4])))
    lw = -torch.exp(params["w0"] + lora[:, 0].float()).reshape(bsz, heads, hd)
    sprev = state["s"]
    rf, kf, vf = (t.float() for t in (r, k, v))
    kv = kf[..., :, None] * vf[..., None, :]                   # [B,H,K,V]
    bonus = (params["u"][None] * kf)[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, sprev + bonus)
    snew = sprev * torch.exp(lw)[..., None] + kv
    y = layernorm(params["ln_y"], y.to(x.dtype).reshape(bsz, 1, heads, hd))
    y = y.reshape(bsz, 1, d) * g
    return linear(params["wo"], y), {"s": snew, "prev": x}


def channelmix(params, cfg, x, *, state=None, return_state=False):
    xx = _shift(x, state) - x
    xk = x + xx * params["mu"][0]
    xr = x + xx * params["mu"][1]
    k = torch.square(F.relu(linear(params["wk"], xk)))
    kv = linear(params["wv"], k)
    out = torch.sigmoid(linear(params["wr"], xr)) * kv
    if return_state:
        return out, x[:, -1:].clone()
    return out

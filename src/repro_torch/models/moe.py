"""Mixture-of-Experts FFN: top-k routing with two dispatch strategies.

The port of ``repro.models.moe``.  The reference computes all of it in XLA,
outside any Pallas kernel, and so does the port: sorts, gathers, scatters
and batched matrix products in PyTorch.

  * ``dense_onehot`` — GShard/Switch-style capacity-bounded dispatch by
    one-hot ``[T, E, C]`` tensors and matrix products.
  * ``ragged_sort`` — stable sort of the assignments by expert, a gather
    into capacity-bounded per-expert buffers, the batched expert FFN, and a
    gather back.

Routing follows the arch: mixtral = softmax over the top-k logits; qwen3-moe
= softmax over all experts, then the top-k probabilities renormalised.  Both
dispatches keep the same assignments: the first ``_capacity`` of each
expert in the flattened ``(token, slot)`` order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Init, linear, linear_init


def moe_init(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": linear_init(d, e),
        "gate": Init("normal", (e, d, f), d ** -0.5),
        "up": Init("normal", (e, d, f), d ** -0.5),
        "down": Init("normal", (e, f, d), f ** -0.5),
    }


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of the last axis,
    largest first, the lower index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg, x_flat):
    """x_flat: [T, d] -> (weights [T, k] in x's dtype, experts int32 [T, k],
    float32 aux loss)."""
    logits = linear(params["router"], x_flat).float()          # [T, E]
    probs_full = torch.softmax(logits, dim=-1)
    if cfg.moe_router == "topk_softmax":                        # mixtral
        vals, idx = top_k(logits, cfg.top_k)
        w = torch.softmax(vals, dim=-1)
    else:                                   # qwen3: softmax -> topk -> renorm
        w, idx = top_k(probs_full, cfg.top_k)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    flat = idx.reshape(-1)
    load = torch.zeros(cfg.n_experts, dtype=torch.float32,
                       device=x_flat.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x_flat.device))
    load = load / torch.clamp(load.sum(), min=1.0)
    imp = probs_full.mean(dim=0)
    aux = cfg.n_experts * torch.sum(load * imp)
    return w.to(x_flat.dtype), idx.to(torch.int32), aux


def _capacity(cfg, t: int) -> int:
    """Per-expert buffer size.  Small token counts (decode batches) are made
    dropless (cap >= t) so decode matches the full forward exactly; large
    counts use GShard capacity-factor dropping."""
    cap = math.ceil(cfg.moe_capacity_factor * t * cfg.top_k / cfg.n_experts)
    return int(max(cap, min(t, 32)))


def _positions(idx, n_experts: int) -> torch.Tensor:
    """[T, k] int64: each assignment's position within its expert, counted
    over the flattened ``(token, slot)`` stream (counting per slot would
    collide capacity cells)."""
    flat = idx.long().reshape(-1)
    oh = F.one_hot(flat, n_experts)
    return (torch.cumsum(oh, dim=0) - oh).gather(1, flat[:, None]).reshape(
        idx.shape)


def kept(cfg, idx) -> torch.Tensor:
    """[T, k] bool: the assignments of ``idx`` [T, k] a dispatch keeps, the
    first ``_capacity(cfg, T)`` of each expert in stream order."""
    return _positions(idx, cfg.n_experts) < _capacity(cfg, idx.shape[0])


def _expert_ffn(params, h):
    """h: [E, C, d] -> [E, C, d] batched over experts."""
    g = torch.bmm(h, params["gate"])
    u = torch.bmm(h, params["up"])
    return torch.bmm(F.silu(g) * u, params["down"])


def moe_dense_onehot(params, cfg, x_flat, w, idx):
    """GShard dispatch: one-hot dispatch and combine tensors with capacity
    dropping."""
    t, d = x_flat.shape
    e = cfg.n_experts
    cap = _capacity(cfg, t)
    onehot = F.one_hot(idx.long(), e).float()                   # [T, k, E]
    pos = _positions(idx, e)
    keep = pos < cap
    # one_hot of a position past the buffer is all zeros, as jax's is
    pos_oh = (pos[..., None]
              == torch.arange(cap, device=x_flat.device)).float()  # [T,k,C]
    disp = torch.bmm((onehot * keep[..., None]).transpose(1, 2),
                     pos_oh)                                    # [T, E, C]
    # The reference's weighted combine "tec,tk,tke->tec": the k experts of a
    # token are distinct, so sum_k w[t,k] onehot[t,k,e] has one term and
    # the [T, E] weight is exact; no [T, E, C, k] intermediate.
    comb = disp * (w.float()[..., None] * onehot).sum(1)[..., None]
    h = (disp.reshape(t, e * cap).T @ x_flat.float()).to(x_flat.dtype)
    y = _expert_ffn(params, h.reshape(e, cap, d))               # [E, C, d]
    out = (comb.reshape(t, e * cap) @ y.reshape(e * cap, d).float()
           ).to(x_flat.dtype)
    return out


def moe_ragged_sort(params, cfg, x_flat, w, idx):
    """Sort-based dispatch: no O(T·E·C) tensors; capacity enforced per
    expert.  The reference scatter-adds each token's k weighted outputs in
    sorted order (ascending expert) onto zeros; the port gathers them to
    ``[T, k, d]`` and adds them in that order, so the sum repeats on the
    card (``index_add_`` there fixes no order)."""
    t, d = x_flat.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    dev = x_flat.device
    flat_e = idx.reshape(-1).long()                             # [T*k]
    flat_w = w.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.sort(flat_e, stable=True).indices
    se, sw, stok = flat_e[order], flat_w[order], flat_tok[order]
    # position within expert group
    same = torch.arange(t * k, device=dev)
    first = torch.full((e,), t * k, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, se, same, reduce="amin")
    posn = same - first[se]
    keep = posn < cap
    slot = torch.where(keep, se * cap + posn, e * cap)   # overflow slot dropped
    buf = x_flat.new_zeros((e * cap + 1, d))
    buf[slot] = x_flat[stok]          # only the dropped share the last row
    y = _expert_ffn(params, buf[:-1].reshape(e, cap, d)).reshape(e * cap, d)
    terms = torch.where(keep[:, None],
                        y[torch.clamp(slot, max=e * cap - 1)].float()
                        * sw[:, None].float(), 0.0)             # sorted order
    # Back to [T, k] with each token's terms in ascending expert order.
    by_tok = torch.empty_like(order)
    by_tok[order] = same
    rank = torch.sort(idx.long(), dim=1, stable=True).indices
    at = by_tok.reshape(t, k).gather(1, rank)
    per_tok = terms[at.reshape(-1)].reshape(t, k, d)
    out = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + per_tok[:, j]
    return out.to(x_flat.dtype)


DISPATCH = {"ragged_sort": moe_ragged_sort, "dense_onehot": moe_dense_onehot}


def moe_forward(params, cfg, x):
    """x: [B, S, d] -> ([B, S, d], float32 aux loss)."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    w, idx, aux = route(params, cfg, x_flat)
    fn = DISPATCH[cfg.moe_dispatch]
    g = cfg.moe_local_groups
    if g > 1 and x_flat.shape[0] % g == 0:
        # group-local dispatch: each group of T/g consecutive tokens has its
        # own capacity and buffers, as the reference's vmap over the groups
        tl = x_flat.shape[0] // g
        y = torch.cat([fn(params, cfg, x_flat[i * tl:(i + 1) * tl],
                          w[i * tl:(i + 1) * tl], idx[i * tl:(i + 1) * tl])
                       for i in range(g)])
        return y.reshape(b, s, d), aux
    return fn(params, cfg, x_flat, w, idx).reshape(b, s, d), aux

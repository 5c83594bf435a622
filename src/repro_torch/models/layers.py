"""Shared neural-net layers: norms, rotary embeddings, MLPs, embeddings.

The port of ``repro.models.layers``.  Layers are plain functions over
parameter dicts of tensors (``{"w": ...}``, ``{"scale": ...}``), so the
model code reads like the reference.  The reference's ``shard_act``
annotations have no counterpart: the port runs on one card.

The ``*_init`` functions return trees of :class:`Init` leaves (shape,
rule and, where the reference pins one, dtype; nothing allocated);
``repro_torch.models.model.init_params`` draws them, ``normal * scale``
from an explicit ``torch.Generator`` in float32 cast to the leaf's dtype.
That does not reproduce ``jax.random``'s bits; tests carry the reference's
parameters across with ``repro_torch.core.convert.params_from_numpy``
instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Init(NamedTuple):
    """One parameter leaf: ``rule`` is ``normal`` (times ``scale``),
    ``ones``, ``zeros``, ``full`` (every entry ``value``) or
    ``log_linspace`` (``log(linspace(1, value, n))`` along the last axis,
    the same for every leading index).  ``dtype`` pins the leaf's dtype
    (the reference keeps some SSM leaves in float32 in a bf16 model);
    ``None`` takes the model's parameter dtype."""
    rule: str
    shape: tuple
    scale: float = 1.0
    value: float = 0.0
    dtype: str | None = None


def draw(spec: Init, gen: torch.Generator, dtype) -> torch.Tensor:
    """Materialise one leaf on ``gen``'s device, in ``spec.dtype`` if set,
    else ``dtype``."""
    dtype = getattr(torch, spec.dtype) if spec.dtype else dtype
    dev = gen.device
    if spec.rule == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.rule == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.rule == "full":
        return torch.full(spec.shape, spec.value, dtype=torch.float32,
                          device=dev).to(dtype)
    if spec.rule == "log_linspace":
        row = torch.log(torch.linspace(1.0, spec.value, spec.shape[-1],
                                       dtype=torch.float32, device=dev))
        return row.expand(spec.shape).to(dtype).contiguous()
    if spec.rule != "normal":
        raise ValueError(f"unknown init rule {spec.rule!r}")
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=dev)
    return (x * spec.scale).to(dtype)


# -- norms --------------------------------------------------------------------

def rmsnorm_init(d: int) -> dict:
    return {"scale": Init("ones", (d,))}


def layernorm_init(d: int) -> dict:
    return {"scale": Init("ones", (d,)), "bias": Init("zeros", (d,))}


def norm_init(kind: str, d: int) -> dict:
    return rmsnorm_init(d) if kind == "rms" else layernorm_init(d)


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def norm_apply(kind: str, params, x):
    return rmsnorm(params, x) if kind == "rms" else layernorm(params, x)


# -- rotary -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D] (or [..., 1, H, D] for decode), positions: [..., S].
    Split-halves layout: the first D/2 channels rotate with the last D/2."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # [D/2]
    ang = positions[..., None].float() * freqs              # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -- linear / MLP --------------------------------------------------------------

def linear_init(d_in: int, d_out: int, scale: float | None = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": Init("normal", (d_in, d_out), scale)}


def linear(params, x):
    return x @ params["w"]


def mlp_init(d: int, d_ff: int, act: str, out_scale=None) -> dict:
    p = {"down": linear_init(d_ff, d, scale=out_scale)}
    if act in ("swiglu", "geglu"):
        p["gate"] = linear_init(d, d_ff)
    p["up"] = linear_init(d, d_ff)
    return p


def mlp(params, x, act: str):
    if act == "swiglu":
        h = F.silu(linear(params["gate"], x)) * linear(params["up"], x)
    elif act == "geglu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(linear(params["gate"], x), approximate="tanh") \
            * linear(params["up"], x)
    elif act == "gelu":
        h = F.gelu(linear(params["up"], x), approximate="tanh")
    else:
        h = F.relu(linear(params["up"], x))
    return linear(params["down"], h)


def embedding_init(vocab: int, d: int) -> dict:
    return {"table": Init("normal", (vocab, d), 0.02)}


def embed(params, ids):
    """Rows ``ids`` of the table.  ``F.embedding``, whose backward sums a
    row's gradients in a fixed order on the CPU and the card, where the
    backward of ``table[ids]`` adds them in whatever order the CPU's
    threads reach them."""
    return F.embedding(ids, params["table"])


def unembed(params, x):
    """Tied or untied output head: x [..., d] @ table.T -> logits."""
    return x @ params["table"].T.to(x.dtype)

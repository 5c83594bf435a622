"""AdamW with float32 state and global-norm clipping.

The port of ``repro.train.optimizer``.  The state is a tree parallel to the
parameters (nested dicts of float32 tensors under the reference's paths)
plus an int32 step.  Schedule: linear warmup, then cosine decay.  The
arithmetic is the reference's, in float32 and in its order: gradients
(in the parameter's dtype) are cast to float32 only here, and the update
is cast back to each parameter's dtype.  ``b ** step`` is glibc's ``powf``
as the reference's compiled code calls it (``core.prng.pow_f32``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..core.prng import pow_f32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: dict
    nu: dict


def leaves(tree, prefix: tuple = ()) -> list:
    """``(path, tensor)`` of every leaf of a parameter tree (a
    ``ModelParams`` or nested dicts), in ``jax.tree.leaves`` order: the
    keys of each node sorted."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree.keys()):
        out += leaves(tree[key], prefix + (key,))
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of a parameter tree, as nested dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: tree_map(fn, tree[k]) for k in tree.keys()}


def get_path(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def init(params) -> OptState:
    dev = leaves(params)[0][1].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf, the squares summed leaf by leaf in
    ``jax.tree.leaves`` order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in leaves(tree)))


def _decay_mask(path) -> bool:
    """Weight decay only on matrices (not norms/biases/scalars).  The
    reference's rule, quirk and all: ``gate`` is the MoE router's matrix
    and also the cross block's scalar gate."""
    last = str(path[-1])
    return last in ("w", "table", "gate", "up", "down") or last.startswith(
        "conv_w")


@torch.no_grad()
def apply(cfg: OptConfig, params, grads, state: OptState):
    """Returns (params, new_state, {"grad_norm", "lr"}).  ``grads`` is a
    tree of the parameters' shapes (any float dtype); the parameters are
    updated in place (the reference returns new ones) and returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - pow_f32(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - pow_f32(torch.full_like(stepf, cfg.b2), stepf)
    mu, nu = {}, {}
    for path, p in leaves(params):
        g = get_path(grads, path).float() * scale
        m = cfg.b1 * get_path(state.mu, path) + (1 - cfg.b1) * g
        v = cfg.b2 * get_path(state.nu, path) + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        node_m, node_v = mu, nu
        for key in path[:-1]:
            node_m = node_m.setdefault(key, {})
            node_v = node_v.setdefault(key, {})
        node_m[path[-1]], node_v[path[-1]] = m, v
    return params, OptState(step=step, mu=mu, nu=nu), {"grad_norm": gnorm,
                                                       "lr": lr}

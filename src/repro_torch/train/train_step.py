"""The train step: loss, gradients, AdamW.

The port of ``repro.train.train_step`` (its plain and microbatched
variants; the compressed data-parallel variant belongs to the reference's
``distributed/``, which the port does not have).  Gradients come from
``loss.backward()`` in each parameter's dtype, as ``jax.grad`` gives them;
with ``accum > 1`` they are summed in float32 over the microbatches in
order and divided by ``accum``, and so is the loss.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..models import model as M
from . import optimizer as O


class TrainState(NamedTuple):
    params: M.ModelParams
    opt: O.OptState


def init_state(cfg, seed: int = 0, device="cuda") -> TrainState:
    """Parameters from ``seed`` that require grad, and a zero optimizer
    state, on ``device`` (the card unless the caller asks for the CPU)."""
    params = M.init_params(cfg, seed, resolve_device(device))
    return TrainState(params=params.requires_grad_(True), opt=O.init(params))


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _grads(params, cfg, batch):
    """(loss, metrics, gradient tree); the parameters' ``.grad`` cleared."""
    loss, metrics = M.loss_fn(params, cfg, batch)
    loss.backward()
    grads = O.tree_map(lambda p: p.grad if p.grad is not None
                       else torch.zeros_like(p), params)
    params.zero_grad(set_to_none=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, opt_cfg: O.OptConfig, accum: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: metrics ``loss``,
    ``grad_norm`` and ``lr`` as the reference's, plus ``ce`` and ``aux``
    (averaged like the loss).  The batch (numpy or tensors) is moved to
    the parameters' device."""
    def train_step(state: TrainState, batch):
        params = state.params
        device = O.leaves(params)[0][1].device
        batch = to_device(batch, device)
        if accum <= 1:
            loss, metrics, grads = _grads(params, cfg, batch)
        else:
            micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                     for k, v in batch.items()}
            grads = O.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            metrics = {"ce": loss.clone(), "aux": loss.clone()}
            for i in range(accum):
                l, m, g = _grads(params, cfg, {k: v[i]
                                               for k, v in micro.items()})
                for path, acc in O.leaves(grads):
                    acc.add_(O.get_path(g, path).float())
                loss = loss + l
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            grads = O.tree_map(lambda g: g / accum, grads)
            loss = loss / accum
            metrics = {k: v / accum for k, v in metrics.items()}
        params, opt, om = O.apply(opt_cfg, params, grads, state.opt)
        return TrainState(params=params, opt=opt), {"loss": loss, **metrics,
                                                    **om}

    return train_step

"""State carried across between the reference and the port.

The reference's ``Workload``, ``JobTable`` and ``EngineState`` with numpy
leaves (the PRNG key as its two uint32 words) become the port's tensors on
a given device, and back.  This is how both engines start from the same
mid-run state.  Model parameters, decode caches and a training state
(parameters, step, AdamW's ``mu``/``nu``) cross the same way: the
reference's pytrees (numpy leaves, stacked ``[repeat, ...]`` per segment)
become the port's ``ModelParams``, cache dicts and ``TrainState``, and
gradients and optimizer trees come back as numpy.  Leaves are copied,
never shared.
"""
from __future__ import annotations

import numpy as np
import torch

from .baselines import AuxState
from .engine import EngineState, Workload
from .job_table import JobTable


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.array(x), device=device)


def workload_from_numpy(wl, device="cpu") -> Workload:
    return Workload(*(_tensor(getattr(wl, f), device)
                      for f in Workload._fields))


def table_from_numpy(table, device="cpu") -> JobTable:
    return JobTable(*(_tensor(getattr(table, f), device)
                      for f in JobTable._fields))


def state_from_numpy(state, device="cpu") -> EngineState:
    fields = {}
    for f in EngineState._fields:
        v = getattr(state, f)
        if f == "t":
            fields[f] = int(np.asarray(v))
        elif f == "key":
            fields[f] = _tensor(np.asarray(v).astype(np.int64), device)
        elif f == "aux":
            fields[f] = AuxState(*(_tensor(getattr(v, a), device)
                                   for a in AuxState._fields))
        else:
            fields[f] = _tensor(v, device)
    return EngineState(**fields)


def state_to_numpy(state: EngineState) -> EngineState:
    """The port's state with numpy leaves: ``t`` an int32 scalar and the
    key a uint32 ``[2]``, as the reference holds them."""
    fields = {}
    for f in EngineState._fields:
        v = getattr(state, f)
        if f == "t":
            fields[f] = np.int32(v)
        elif f == "key":
            fields[f] = v.cpu().numpy().astype(np.uint32)
        elif f == "aux":
            fields[f] = AuxState(*(getattr(v, a).cpu().numpy()
                                   for a in AuxState._fields))
        else:
            fields[f] = v.cpu().numpy()
    return EngineState(**fields)


def tensor_from_numpy(x, device="cpu") -> torch.Tensor:
    """One leaf of a reference pytree as a tensor.  A bfloat16 leaf comes out
    of JAX as an ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy``
    refuses: its bits cross as ``uint16`` and are viewed as bfloat16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as its bits viewed as
    ``ml_dtypes.bfloat16`` (the package JAX's bfloat16 arrays use)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(jax_params, cfg, device="cpu"):
    """The reference's parameter pytree (numpy or JAX leaves) as the port's
    :class:`~repro_torch.models.model.ModelParams` on ``device``.  Every
    path, shape and dtype must be the one the port's init would make for
    ``cfg``: ``cfg.param_dtype``, or float32 for the leaves the reference
    keeps in float32 in any model (the SSM decay, skip and bonus leaves),
    which cross as float32."""
    from ..models.layers import Init
    from ..models.model import ModelParams, param_specs

    def check(spec, tree, path):
        if isinstance(spec, Init):
            shape = tuple(np.shape(tree))
            if shape != tuple(spec.shape):
                raise ValueError(f"{path}: shape {shape}, the port's init "
                                 f"makes {tuple(spec.shape)}")
            dtype = np.asarray(tree).dtype.name
            want = spec.dtype or cfg.param_dtype
            if dtype != want:
                raise ValueError(f"{path}: dtype {dtype}, the port's init "
                                 f"makes {want}")
            return
        if not isinstance(tree, dict) or set(tree) != set(spec):
            have = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: keys {have}, the port's "
                             f"init makes {sorted(spec)}")
        for k in spec:
            check(spec[k], tree[k], f"{path}.{k}" if path else k)

    check(param_specs(cfg), jax_params, "")
    return ModelParams(_map_tree(
        jax_params, lambda x: tensor_from_numpy(x, device)))


def caches_from_numpy(jax_caches, device="cpu") -> dict:
    """The reference's decode caches as the port's nested dict of tensors."""
    return _map_tree(jax_caches, lambda x: tensor_from_numpy(x, device))


def caches_to_numpy(caches) -> dict:
    """The port's decode caches with numpy leaves, as the reference holds
    them."""
    return _map_tree(caches, tensor_to_numpy)


def tree_to_numpy(tree) -> dict:
    """A parameter-shaped tree of the port (``ModelParams``, a gradient or
    optimizer tree) as nested dicts of numpy arrays, as the reference holds
    them (bfloat16 as ``ml_dtypes.bfloat16``)."""
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    return {k: tree_to_numpy(tree[k]) for k in tree.keys()}


def train_state_from_numpy(jax_state, cfg, device="cpu"):
    """The reference's ``TrainState`` (numpy or JAX leaves) as the port's:
    parameters that require grad (``params_from_numpy``), the int32 step,
    and ``mu``/``nu`` float32 trees."""
    from ..train.optimizer import OptState
    from ..train.train_step import TrainState
    params = params_from_numpy(jax_state.params, cfg, device)
    opt = jax_state.opt
    return TrainState(params=params.requires_grad_(True), opt=OptState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                          device=device),
        mu=_map_tree(opt.mu, lambda x: tensor_from_numpy(x, device)),
        nu=_map_tree(opt.nu, lambda x: tensor_from_numpy(x, device))))

"""State carried across between the reference engine and the port.

The reference's ``Workload``, ``JobTable`` and ``EngineState`` with numpy
leaves (the PRNG key as its two uint32 words) become the port's tensors on
a given device, and back.  This is how both engines start from the same
mid-run state.  Leaves are copied, never shared.
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

"""The job status table (paper §4.1): fixed-slot struct-of-tensors."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class JobTable(NamedTuple):
    """One slot per job. ``active`` marks live slots (heartbeat fresh)."""

    active: torch.Tensor          # bool[J]
    user_id: torch.Tensor         # int32[J]
    group_id: torch.Tensor        # int32[J]
    size: torch.Tensor            # float32[J]  node count
    priority: torch.Tensor        # float32[J]
    last_heartbeat: torch.Tensor  # float32[J] seconds

    @property
    def max_jobs(self) -> int:
        return self.active.shape[0]


def make_table(jobs: Sequence[dict], max_jobs: int, device="cpu") -> JobTable:
    """Build a table from dicts with keys: user, group, size, priority."""
    if len(jobs) > max_jobs:
        raise ValueError(f"{len(jobs)} jobs > {max_jobs} slots")
    active = np.zeros((max_jobs,), dtype=bool)
    user = np.zeros((max_jobs,), dtype=np.int32)
    group = np.zeros((max_jobs,), dtype=np.int32)
    size = np.zeros((max_jobs,), dtype=np.float32)
    prio = np.ones((max_jobs,), dtype=np.float32)
    for j, spec in enumerate(jobs):
        active[j] = True
        user[j] = spec.get("user", j)
        group[j] = spec.get("group", 0)
        size[j] = spec.get("size", 1)
        prio[j] = spec.get("priority", 1.0)
    t = lambda a: torch.as_tensor(a, device=device)
    return JobTable(active=t(active), user_id=t(user), group_id=t(group),
                    size=t(size), priority=t(prio),
                    last_heartbeat=torch.zeros((max_jobs,), dtype=torch.float32,
                                               device=device))

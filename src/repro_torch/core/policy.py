"""Sharing policies and the statistical-token chain (paper §3, Eq. 1).

A policy is an ordered list of *levels* (``group`` ⊐ ``user`` ⊐ ``job``),
each with a weight rule (``fair`` | ``size`` | ``priority``); see the
reference ``repro.core.policy`` for the named policies.

The reference evaluates Eq. 1 as a product of dense transition matrices,
``(prev_dim, dim)`` per level, which is ``J x J`` per server at the job level
and ``J x J²`` at a user level under a group level.  Every column of those
matrices has exactly one non-zero entry (an entity has one parent), so the
port computes the same chain with gathers and ``index_add_`` over each
level's entities and never builds a matrix: for child entity ``c`` of parent
``p``,

    share[c] = share[p] * w[c] / sum(w[children of p])

which is the reference's ``vec @ tm`` term for term.  Each row sum is
taken in the order XLA's CPU code takes ``tm.sum(axis=1)``: over the
parent's ``dim`` columns (the composite ids) by windows of 32, then over the
window sums by the same rule (:mod:`repro_torch.core.ordered`); the zero
columns change no sum, so only the windows holding a child are added
(:func:`_sum_stages`).  The entity structure of a table (which job belongs
to which composite entity, each entity's parent and window) is static, so
it is built once into a :class:`PolicyChain` and reused every tick.

Float sums run through ``index_add_``, which on the CPU adds in index order
and on the card uses atomics.  The named policies only sum exact values
(counts of 1.0 for ``fair`` levels, integer node counts for ``size``), so
their shares are deterministic everywhere; non-integer ``priority`` weights
equal the reference's on the CPU and may differ in the last bit from run
to run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

ENTITIES = ("group", "user", "job")
WEIGHTS = ("fair", "size", "priority")
_ENTITY_RANK = {e: i for i, e in enumerate(ENTITIES)}


@dataclasses.dataclass(frozen=True)
class Level:
    entity: str
    weight: str = "fair"

    def __post_init__(self):
        if self.entity not in ENTITIES:
            raise ValueError(f"unknown entity {self.entity!r}; expected one of {ENTITIES}")
        if self.weight not in WEIGHTS:
            raise ValueError(f"unknown weight {self.weight!r}; expected one of {WEIGHTS}")


@dataclasses.dataclass(frozen=True)
class Policy:
    """A composite sharing policy: a strictly coarse-to-fine chain of levels
    whose final level is ``job``."""

    levels: tuple[Level, ...]
    name: str = ""

    def __post_init__(self):
        if not self.levels:
            raise ValueError("policy needs at least one level")
        ranks = [_ENTITY_RANK[lv.entity] for lv in self.levels]
        if any(b <= a for a, b in zip(ranks, ranks[1:])):
            raise ValueError(f"levels must be strictly coarse-to-fine, got {self.levels}")
        if self.levels[-1].entity != "job":
            raise ValueError("final level must be 'job' (use Policy.parse to auto-append)")

    @property
    def depth(self) -> int:
        return len(self.levels)

    @staticmethod
    def parse(spec: str) -> "Policy":
        """Parse either a paper-style name or a ``entity:weight,...`` chain."""
        named = {
            "fifo": None,  # handled by the engine as a baseline, not a token policy
            "job-fair": "job:fair",
            "size-fair": "job:size",
            "priority-fair": "job:priority",
            "user-fair": "user:fair,job:fair",
            "group-fair": "group:fair,user:fair,job:fair",
            "user-then-job-fair": "user:fair,job:fair",
            "user-then-size-fair": "user:fair,job:size",
            "group-then-user-fair": "group:fair,user:fair,job:fair",
            "group-then-size-fair": "group:fair,job:size",
            "group-user-size-fair": "group:fair,user:fair,job:size",
        }
        chain = named.get(spec, spec)
        if chain is None:
            raise ValueError("'fifo' is a baseline scheduler, not a token policy")
        if spec not in named:
            tokens = [part.strip().partition(":")[0].strip()
                      for part in chain.split(",")]
            if not all(t in ENTITIES for t in tokens):
                known = ", ".join(sorted(k for k, v in named.items() if v))
                raise ValueError(
                    f"unknown policy {spec!r}. Known named policies: {known}. "
                    f"Or give an 'entity[:weight],...' chain with entities "
                    f"{ENTITIES} and weights {WEIGHTS}, "
                    f"e.g. 'group:fair,user:fair,job:size'.")
        levels = []
        for part in chain.split(","):
            entity, _, weight = part.strip().partition(":")
            levels.append(Level(entity, weight or "fair"))
        if levels[-1].entity != "job":
            levels.append(Level("job", "fair"))
        return Policy(tuple(levels), name=spec)


def _sum_stages(pos: np.ndarray, parent: np.ndarray, dim: int
                ) -> list[tuple[np.ndarray, int]]:
    """How to sum per-entity values into per-parent sums in XLA CPU's
    order of a row sum over ``dim`` columns, entity ``e`` at column
    ``pos[e]`` (ascending within a parent): one ``(index, size)`` per
    ``index_add`` stage.  Above 32 columns each stage sums the windows of 32
    (the row zero-padded, half the padding in front) into one value per
    (parent, window) that holds an entity; the last stage adds the
    remaining values of each parent in order into the parent."""
    stages = []
    owner, length = parent, dim
    while length > 32:
        m = -(-length // 32)
        win = (pos + (32 * m - length) // 2) // 32
        pairs, index = np.unique(owner * m + win, return_inverse=True)
        stages.append((index, len(pairs)))
        owner, pos, length = pairs // m, pairs % m, m
    stages.append((owner, -1))
    return stages


class _ChainLevel:
    """One level of a compiled chain: job -> entity and entity -> parent."""

    def __init__(self, weight: str, ent: torch.Tensor, parent: torch.Tensor,
                 n_ent: int, n_parent: int, w_job: Optional[torch.Tensor],
                 stages: list[tuple[torch.Tensor, int]]):
        self.weight = weight
        self.ent = ent            # long[J]      entity index of each job
        self.parent = parent      # long[n_ent]  parent entity (previous level)
        self.n_ent = n_ent
        self.n_parent = n_parent
        self.w_job = w_job        # f32[J] per-job weight (None for fair)
        self.stages = stages      # _sum_stages, indices on the device

    def row_sums(self, cols: torch.Tensor) -> torch.Tensor:
        """``[b, n_parent]`` sums of ``cols`` ``[b, n_ent]`` over each
        parent's children, in the reference's order."""
        for index, size in self.stages[:-1]:
            cols = cols.new_zeros((cols.shape[0], size)).index_add(
                1, index, cols)
        return cols.new_zeros((cols.shape[0], self.n_parent)).index_add(
            1, self.stages[-1][0], cols)


class PolicyChain:
    """A :class:`Policy` compiled against one job table's attributes.

    Entities are the reference's composite ids (``parent_id * J + raw``, so
    a user under two groups is two entities), renumbered densely per level.
    Building it reads the ids on the host once; :meth:`shares` then runs
    entirely on the table's device.
    """

    def __init__(self, policy: Policy, *, active, user_id, group_id, size,
                 priority):
        self.policy = policy
        self.active = active.bool()
        device = active.device
        n = active.shape[0]
        raw_ids = {"job": np.arange(n, dtype=np.int64),
                   "user": user_id.detach().cpu().numpy().astype(np.int64),
                   "group": group_id.detach().cpu().numpy().astype(np.int64)}
        prev_cid = np.zeros((n,), np.int64)
        prev_ent = np.zeros((n,), np.int64)
        prev_n, prev_dim = 1, 1
        levels = []
        for level in policy.levels:
            raw = raw_ids[level.entity]
            if level.entity == "job":
                cid, dim = raw, n
            else:
                cid, dim = prev_cid * n + raw, prev_dim * n
            keys, ent = np.unique(cid, return_inverse=True)
            parent = np.zeros((len(keys),), np.int64)
            parent[ent] = prev_ent
            w_job = None
            if level.weight == "size":
                w_job = size.to(torch.float32)
            elif level.weight == "priority":
                w_job = priority.to(torch.float32)
            stages = [(torch.as_tensor(index, device=device), size)
                      for index, size in _sum_stages(keys, parent, dim)]
            levels.append(_ChainLevel(
                level.weight, torch.as_tensor(ent, device=device),
                torch.as_tensor(parent, device=device), len(keys), prev_n,
                w_job, stages))
            prev_cid, prev_ent, prev_n, prev_dim = cid, ent, len(keys), dim
        self.levels = tuple(levels)

    @classmethod
    def from_table(cls, policy: Policy, table) -> "PolicyChain":
        return cls(policy, active=table.active, user_id=table.user_id,
                   group_id=table.group_id, size=table.size,
                   priority=table.priority)

    def shares(self, mask: torch.Tensor) -> torch.Tensor:
        """Eq. 1 over the jobs in ``mask`` (bool ``[..., J]``, already ANDed
        with ``active`` and any demand): f32 ``[..., J]`` shares summing to
        1 per row, or zeros where nothing is masked in."""
        batch = mask.shape[:-1]
        maskf = mask.reshape(-1, mask.shape[-1]).to(torch.float32)
        b = maskf.shape[0]
        vec = torch.ones((b, 1), dtype=torch.float32, device=maskf.device)
        for lv in self.levels:
            zeros = maskf.new_zeros((b, lv.n_ent))
            child_live = zeros.index_add(1, lv.ent, maskf) > 0
            if lv.w_job is None:
                w_child = child_live.to(torch.float32)
            else:
                w_child = zeros.index_add(1, lv.ent, lv.w_job * maskf)
            cols = torch.where(child_live, w_child, 0.0)
            row_sum = lv.row_sums(cols)[:, lv.parent]
            frac = torch.where(row_sum > 0,
                               cols / torch.clamp_min(row_sum, 1e-30), 0.0)
            vec = vec[:, lv.parent] * frac
        return vec.reshape(batch + (vec.shape[-1],))


def compute_job_shares(policy: Policy, *, active, user_id, group_id, size,
                       priority, demand=None) -> torch.Tensor:
    """Evaluate Eq. 1 for one table: f32 ``[J]`` job shares summing to 1 over
    live (and, if ``demand`` is given, demanded) jobs, or zeros."""
    chain = PolicyChain(policy, active=active, user_id=user_id,
                        group_id=group_id, size=size, priority=priority)
    mask = chain.active if demand is None else chain.active & demand.bool()
    return chain.shares(mask)


def compute_job_shares_from_table(policy: Policy, table,
                                  demand=None) -> torch.Tensor:
    """:func:`compute_job_shares` over a
    :class:`repro_torch.core.job_table.JobTable`."""
    return compute_job_shares(
        policy, active=table.active, user_id=table.user_id,
        group_id=table.group_id, size=table.size, priority=table.priority,
        demand=demand)

"""Multi-tenant serving engine with ThemisIO fair-share slot scheduling.

The port of ``repro.serve.engine``.  The paper's statistical tokens map onto
continuous batching: decode-batch slots are the I/O workers, tenants are
the jobs, and the policy (user-fair, size-fair by paid capacity,
priority-fair, composite) decides whose queued request takes a freed slot.
Opportunity fairness keeps the batch full when some tenants are idle.

The admission draw is the reference's, draw for draw: the key is the
port's threefry (``core/prng.py``, bit-exact to ``jax.random``), the shares
come from the port's policy chain, and the pick goes through
``core/tokens.select_job``, so on the card the ``token_select`` kernel
makes it.  The engine runs on the card unless the caller asks for
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import prng
from ..core.job_table import make_table
from ..core.policy import Policy, compute_job_shares_from_table
from ..core.tokens import select_job
from ..models import model as M


@dataclasses.dataclass
class Tenant:
    tenant_id: int
    user: int = 0
    group: int = 0
    size: int = 1          # provisioned capacity weight (size-fair)
    priority: float = 1.0


@dataclasses.dataclass
class GenRequest:
    tenant: Tenant
    prompt: np.ndarray              # [S] int32
    max_new: int = 16
    rid: int = 0
    out_tokens: list = dataclasses.field(default_factory=list)
    submitted_at: int = 0
    finished_at: Optional[int] = None


class ServeEngine:
    def __init__(self, cfg, params, *, batch_slots: int = 8,
                 max_len: int = 256, policy: str = "user-fair",
                 max_tenants: int = 16, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        where = {p.device for p in params.parameters()}
        if where != {self.device}:
            raise ValueError(f"params lie on {sorted(map(str, where))}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = batch_slots
        self.max_len = max_len
        self.policy = Policy.parse(policy)
        self.max_tenants = max_tenants
        self.queues: dict[int, deque[GenRequest]] = {}
        self.tenants: dict[int, Tenant] = {}
        self.slot_req: list[Optional[GenRequest]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.caches = M.init_caches(cfg, batch_slots, max_len,
                                    device=self.device)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.key = prng.PRNGKey(seed, device=self.device)
        self._rid = itertools.count()
        self.step_count = 0
        self.decoded_per_tenant: dict[int, int] = {}

    # -- tenant-facing -----------------------------------------------------
    def submit(self, tenant: Tenant, prompt: np.ndarray, max_new: int = 16
               ) -> GenRequest:
        self.tenants[tenant.tenant_id] = tenant
        req = GenRequest(tenant=tenant, prompt=np.asarray(prompt, np.int32),
                         max_new=max_new, rid=next(self._rid),
                         submitted_at=self.step_count)
        self.queues.setdefault(tenant.tenant_id, deque()).append(req)
        return req

    # -- scheduler ----------------------------------------------------------
    def _shares(self):
        ids = sorted(self.tenants)
        specs = [{"user": self.tenants[t].user, "group": self.tenants[t].group,
                  "size": self.tenants[t].size,
                  "priority": self.tenants[t].priority} for t in ids]
        table = make_table(specs, max_jobs=self.max_tenants,
                           device=self.device)
        demand = np.zeros(self.max_tenants, bool)
        for i, t in enumerate(ids):
            demand[i] = bool(self.queues.get(t))
        demand_t = torch.as_tensor(demand, device=self.device)
        shares = compute_job_shares_from_table(self.policy, table, demand_t)
        return ids, shares, demand, demand_t

    def _admit(self):
        """Fill free slots by statistical-token draws over tenant queues."""
        for slot in range(self.slots):
            if self.slot_req[slot] is not None:
                continue
            ids, shares, demand, demand_t = self._shares()
            if not demand.any():
                return
            self.key, sub = prng.split(self.key)
            u = prng.uniform(sub, ())
            idx = int(select_job(shares, demand_t, u))
            if idx < 0 or idx >= len(ids):
                return
            req = self.queues[ids[idx]].popleft()
            self._start(slot, req)

    def _start(self, slot: int, req: GenRequest):
        # per-slot prefill: run prompt[:-1] through decode steps (simple and
        # uniform across cache types; M.prefill is the batched path).  The
        # LAST prompt token stays pending: the decode phase consumes it and
        # its logits produce the first generated token.
        self.slot_req[slot] = req
        self.slot_pos[slot] = 0
        self._reset_slot_cache(slot)
        for tok in req.prompt[:-1]:
            self.tokens[slot, 0] = tok
            self._step_slots(only_slot=slot)
        self.tokens[slot, 0] = req.prompt[-1]

    def _reset_slot_cache(self, slot: int):
        """Zero the slot's rows of every cache leaf, in place."""
        for seg in self.caches.values():
            for blk in seg.values():
                for leaf in blk.values():
                    leaf[:, slot].zero_()

    def _step_slots(self, only_slot: Optional[int] = None):
        batch = {"tokens": torch.as_tensor(self.tokens, device=self.device)}
        if self.cfg.n_codebooks:
            # Each slot's token fed on every codebook; codebook 0 is read.
            codes = np.repeat(self.tokens[:, :, None], self.cfg.n_codebooks, 2)
            batch = {"codes": torch.as_tensor(codes, device=self.device)}
        pos = torch.as_tensor(self.slot_pos, device=self.device)
        logits, self.caches = M.decode_step(self.params, self.cfg,
                                            self.caches, batch, pos)
        nxt = torch.argmax(logits[..., :self.cfg.vocab], dim=-1).cpu().numpy()
        for slot in range(self.slots):
            if only_slot is not None and slot != only_slot:
                continue
            req = self.slot_req[slot]
            if req is None:
                continue
            self.slot_pos[slot] += 1
            if only_slot is None:  # decode phase: emit a token
                tok = int(nxt[slot, 0]) if nxt.ndim == 2 \
                    else int(nxt[slot, 0, 0])
                req.out_tokens.append(tok)
                self.tokens[slot, 0] = tok
                tid = req.tenant.tenant_id
                self.decoded_per_tenant[tid] = \
                    self.decoded_per_tenant.get(tid, 0) + 1
                if (len(req.out_tokens) >= req.max_new
                        or self.slot_pos[slot] >= self.max_len - 1):
                    req.finished_at = self.step_count
                    self.slot_req[slot] = None

    def step(self):
        """One engine tick: admit into free slots, decode one token each."""
        self._admit()
        if any(r is not None for r in self.slot_req):
            self._step_slots()
        self.step_count += 1

    def run(self, steps: int):
        for _ in range(steps):
            self.step()

    def drain(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not any(self.queues.values()) and \
                    all(r is None for r in self.slot_req):
                return
            self.step()

"""Plan-based scheduling: simulated annealing over job orderings, ported
from the reference's ``repro.batch.plan`` (Kopanski & Rzadca,
arXiv:2109.00082).

The plan is a permutation of the queued jobs; its value is the mean wait of
the reservation-aware list schedule it induces
(:func:`repro_torch.batch.sim.schedule_order`).  ``sa_restarts`` streams of
``sa_steps`` Metropolis swap proposals each run as a leading batch axis
``[R]`` (the reference's ``jax.vmap``), and every accept and best-so-far
decision stays on the device (``torch.where``), so a step never waits for
the host.  The randomness is the reference's, drawn up front for every
step at once: ``PRNGKey(seed)``, ``fold_in(r)``, ``fold_in(s)``,
``split(3)``, two ``randint`` positions and one ``uniform``.  On the card
the step is one CUDA graph, replayed ``sa_steps`` times.  The float32
arithmetic is the reference's compiled arithmetic (read off XLA's dumps):
the mean wait is the ordered sum times ``float32(1 / N)``, ``sum / N - cost``
is one fused multiply-add, and ``exp`` and ``cooling ** s`` are XLA's
(:func:`repro_torch.core.prng.exp_f32`, :func:`~repro_torch.core.prng.pow_f32`).
So the winning order, its start vector and its cost equal the reference's
bit for bit on the CPU, and the card's equal the CPU's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import prng
from ..core.ordered import fma, ordered_sum
from ..core.params import PlanOptParams
from .queue import BatchQueue
from .sim import arrival_order, queue_columns, schedule_order

#: Per-step values :func:`anneal` records with ``record=True``, each
#: ``[sa_steps, sa_restarts]`` (``cost`` is the stream's cost before the step).
RECORD_FIELDS = ("c_prop", "cost", "temp", "u", "exp", "accept")


def anneal(order0: torch.Tensor, cols: torch.Tensor, n_nodes: int,
           bb_cap: float, p: PlanOptParams, seed: int, n_plan: int, *,
           record: bool = False):
    """Best ``(order, mean wait)`` over ``p.sa_restarts`` annealing streams
    of ``p.sa_steps`` swap proposals within the first ``n_plan`` plan
    positions; with ``record`` also a dict of :data:`RECORD_FIELDS`.

    On the card the step is captured once as a CUDA graph and replayed
    ``sa_steps`` times (its ops are host-bound when launched one by one);
    the graph runs the same kernels on the same inputs, so the plan is the
    one the step gives when it runs eagerly, as it does on the CPU.  With
    ``record`` the step also writes its row of each preallocated
    ``[sa_steps, sa_restarts]`` record, in the graph on the card, so the
    recorded run is the one that gives the plan."""
    dev = cols.device
    steps, restarts, n = p.sa_steps, p.sa_restarts, order0.shape[0]
    submit = cols[0]
    inv_n = torch.tensor(np.float32(1.0) / np.float32(n), device=dev)

    def wait_sum(order):
        start = schedule_order(order, cols, n_nodes, bb_cap, fcfs=False)
        return ordered_sum(start - submit)

    # Every step's proposal and uniform, for all streams at once.
    key = prng.PRNGKey(seed, dev)
    k_r = prng.fold_in(key, torch.arange(restarts, device=dev))      # [R, 2]
    s_idx = torch.arange(steps, device=dev)
    keys = prng.split(prng.fold_in(k_r, s_idx[:, None]), 3)          # [S, R, 3, 2]
    pos_i = prng.randint(keys[..., 0, :], 0, n_plan).to(torch.int64)
    pos_j = prng.randint(keys[..., 1, :], 0, n_plan).to(torch.int64)
    uni = prng.uniform(keys[..., 2, :], ())                          # [S, R]
    t0 = torch.tensor(p.t0_s, dtype=torch.float32, device=dev)
    cooling = torch.tensor(p.cooling, dtype=torch.float32, device=dev)
    temps = t0 * prng.pow_f32(cooling, s_idx.to(torch.float32))      # [S]

    c0 = wait_sum(order0[None]) * inv_n                              # [1]
    order = order0.to(torch.int64).expand(restarts, n).clone()
    cost, best_o, best_c = (c0.expand(restarts).clone(), order.clone(),
                            c0.expand(restarts).clone())
    rec = ({f: torch.empty((steps, restarts), device=dev,
                           dtype=torch.bool if f == "accept" else torch.float32)
            for f in RECORD_FIELDS} if record else None)

    def at(x, s):
        """Row ``s`` of ``x``: ``s`` an int, or in the graph a ``[1]`` index
        on the device (read there, never by the host)."""
        return x[s] if isinstance(s, int) else x.index_select(0, s)[0]

    def put(x, s, v):
        """Write ``v`` to row ``s`` of ``x`` (``s`` as in :func:`at`)."""
        if isinstance(s, int):
            x[s] = v
        else:
            x.index_copy_(0, s, v[None])

    def step(s):
        """Step ``s`` of every stream, in place."""
        i, j = at(pos_i, s)[:, None], at(pos_j, s)[:, None]
        prop = order.scatter(1, i, order.gather(1, j)).scatter(
            1, j, order.gather(1, i))
        total = wait_sum(prop)
        c_prop = total * inv_n
        # XLA fuses ``total * (1 / N) - cost`` into one multiply-add.
        temp, u = at(temps, s), at(uni, s)
        e = prng.exp_f32(-fma(total, inv_n, -cost) / temp)
        accept = (c_prop <= cost) | (u < e)
        if record:
            for f, v in zip(RECORD_FIELDS, (c_prop, cost,
                                            temp.expand(restarts), u, e,
                                            accept)):
                put(rec[f], s, v)
        order.copy_(torch.where(accept[:, None], prop, order))
        cost.copy_(torch.where(accept, c_prop, cost))
        best_o.copy_(torch.where((c_prop < best_c)[:, None], prop, best_o))
        best_c.copy_(torch.minimum(c_prop, best_c))

    if dev.type == "cuda":
        state = [order, cost, best_o, best_c]
        initial = [x.clone() for x in state]
        counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(counter)                     # warm-up, undone below
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step(counter)
            counter.add_(1)
        for x, x0 in zip(state, initial):
            x.copy_(x0)
        counter.zero_()
        for _ in range(steps):
            graph.replay()
    else:
        for s in range(steps):
            step(s)
    r = torch.argmin(best_c)             # ties -> the lowest restart
    out = (best_o[r], best_c[r])
    return out + (rec,) if record else out


def plan_window(queue: BatchQueue, p: PlanOptParams) -> int:
    """Plan positions the annealer permutes: the jobs submitted within
    ``p.lookahead_s`` of the first submit (at least one)."""
    a = queue.arrays()
    order0 = arrival_order(queue)
    window_end = float(a["submit"].min()) + float(p.lookahead_s)
    return max(1, int((a["submit"][order0] <= window_end).sum()))


def plan_schedule(queue: BatchQueue, params: Optional[PlanOptParams] = None,
                  *, seed: int = 0, device="cuda"
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """SA-optimized plan for ``queue``: ``(start, order, mean_wait)``.

    ``start`` is the executed plan's per-job start vector (f64 seconds,
    original job indexing), ``order`` the winning permutation, and
    ``mean_wait`` its objective value.  The initial plan is arrival order;
    only jobs submitted within ``params.lookahead_s`` of the first submit
    are permuted.  Deterministic per ``(queue, params, seed)``, on either
    device."""
    p = params if params is not None else PlanOptParams()
    if type(p) is not PlanOptParams:
        raise TypeError(
            f"params must be PlanOptParams, got {type(p).__name__}")
    dev = resolve_device(device)
    cols = queue_columns(queue, dev)
    order0 = torch.from_numpy(arrival_order(queue)).to(dev)
    best_order, best_cost = anneal(order0, cols, queue.cluster.n_nodes,
                                   queue.cluster.bb_total, p, seed,
                                   plan_window(queue, p))
    start = schedule_order(best_order, cols, queue.cluster.n_nodes,
                           queue.cluster.bb_total, fcfs=False)
    return (start.cpu().numpy().astype(np.float64),
            best_order.cpu().numpy().astype(np.int64), float(best_cost))

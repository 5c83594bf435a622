"""Serving driver: multi-tenant engine with a ThemisIO slot scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
        --policy user-fair --requests 24

The port of ``repro.launch.serve``: the same set-up (three tenants, the
first with twice the size, 8-token prompts, 8 new tokens each, the arch's
reduced config) on the card by default; ``--device cpu`` runs the plain
path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.base import get_config
from ..models import model as M
from ..serve.engine import ServeEngine, Tenant


def submit_tenant_requests(eng: ServeEngine, n_requests: int, *,
                           prompt_len: int = 8) -> list:
    """Three tenants (user i; tenant 0 twice the size) take turns
    submitting ``n_requests`` random prompts of ``prompt_len`` tokens from
    seed 0, 8 new tokens each."""
    tenants = [Tenant(tenant_id=i, user=i, size=1 + (i == 0))
               for i in range(3)]
    rng = np.random.default_rng(0)
    return [eng.submit(tenants[i % len(tenants)],
                       rng.integers(0, eng.cfg.vocab, size=prompt_len),
                       max_new=8)
            for i in range(n_requests)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--policy", default="user-fair")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    params = M.init_params(cfg, seed=0, device=args.device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots, max_len=96,
                      policy=args.policy, device=args.device)
    reqs = submit_tenant_requests(eng, args.requests)
    t0 = time.perf_counter()
    eng.drain()
    wall = time.perf_counter() - t0
    done = sum(r.finished_at is not None for r in reqs)
    print(f"completed {done}/{len(reqs)} requests in {eng.step_count} ticks "
          f"({wall:.2f} s wall on {eng.device})")
    print("tokens/tenant:", eng.decoded_per_tenant)
    return eng, reqs


if __name__ == "__main__":
    main()

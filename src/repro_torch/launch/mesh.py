"""The engine's ``(sweep, servers)`` mesh over the ranks of a process group,
and a launcher that starts such a group on one host.

The reference (``repro.launch.mesh``) is single-controller SPMD: its mesh is
made of the devices one JAX process sees.  The port runs one process per
rank under ``torch.distributed``, and every rank calls the same entry point
(``run``, ``run_batch``, ``Experiment.run/run_batch/sweep/solo``).  A world
comes from :func:`spawn` below, or from ``torchrun`` with the same rendezvous
(``torchrun --nproc-per-node 4 script.py``, the script calling
``torch.distributed.init_process_group("gloo")``).

``make_production_mesh`` and ``make_debug_mesh`` belong to the LLM substrate
(``repro.distributed``) and are not ported yet.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

_MESHES: dict = {}

#: Seconds a rank's collective may wait before it raises.
TIMEOUT_S = 600.0


def make_engine_mesh(n_sweep: int = 1, n_servers: int = 1,
                     device_type: str = "cpu"):
    """The ``('sweep', 'servers')`` device mesh over the first
    ``n_sweep * n_servers`` ranks of the initialized process group.

    Building a mesh is a collective: every rank of the world calls this, in
    the same order, and a rank past the first ``n_sweep * n_servers`` gets a
    mesh whose ``get_coordinate()`` is None.  Meshes are cached per world."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.group.WORLD
    key = (n_sweep, n_servers, device_type)
    cached = _MESHES.get(key)
    if cached is None or cached[0] is not world:
        mesh = init_device_mesh(device_type, (n_sweep, n_servers),
                                mesh_dim_names=("sweep", "servers"))
        _MESHES[key] = cached = (world, mesh)
    return cached[1]


def _rank_main(rank: int, fn, args, n_ranks: int, backend: str, device: str,
               rendezvous: str, result_path: str) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                            world_size=n_ranks, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(*args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], n_ranks: int, *, args: tuple = (),
          backend: str = "gloo", device: str = "cpu") -> Any:
    """Run ``fn(*args)`` on ``n_ranks`` new processes joined in one
    ``torch.distributed`` world; return rank 0's result.

    The processes start by the ``spawn`` method (the parent may have CUDA
    initialized, which a fork cannot carry) and rendezvous through a
    ``file://`` store in a fresh temporary directory (no network).  Each
    rank runs with one intra-op thread and, for ``device="cuda"``, on card
    ``rank % torch.cuda.device_count()``.  ``fn`` must be importable by
    name (a module-level function) and rank 0's result picklable.  If a
    rank raises, the others are stopped and the call raises
    ``torch.multiprocessing.ProcessRaisedException`` with that rank's
    traceback; every process has ended when this returns.  A collective
    that waits longer than :data:`TIMEOUT_S` raises on its rank."""
    import torch.multiprocessing as mp

    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        result_path = os.path.join(tmp, "result.pkl")
        mp.start_processes(
            _rank_main, nprocs=n_ranks, join=True, start_method="spawn",
            args=(fn, args, n_ranks, backend, device,
                  os.path.join(tmp, "rendezvous"), result_path))
        with open(result_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

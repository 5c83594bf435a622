"""Fleet sharding: the engine's server slabs and sweep lanes on a mesh of
ranks.

The port of ``repro.core.shard``.  The engine's state is laid out lanes
first (``[L, S, ...]``, see :mod:`.engine`), and a mesh of ranks
``('sweep', 'servers')`` (:func:`repro_torch.launch.mesh.make_engine_mesh`)
splits it two ways:

  * **servers axis**: the server dimension (dim 1) of the slab fields
    (:data:`SLAB_FIELDS`) is split into contiguous slabs of
    ``S // n_servers`` rows.  Each rank keeps its slab's rings and time
    wheel (``arr_time [L, S, J, CAP]``, ``wheel [L, S, J, H]``) to itself;
    the small control plane (queue counters, heads, ``known``, ``seg``,
    ``free_at``, the scheduler's aux, the wheel's current slot and the
    ``W``-wide ring window) is all-gathered each tick, so every decision
    sees the whole fleet;
  * **sweep axis**: :func:`~.engine.run_batch` splits its leading grid axis
    (``params_points`` if given, else the seeds) into equal contiguous
    blocks of lanes.  Lanes are independent simulations: this axis needs no
    collective until the results are gathered.

Determinism: every rank recomputes each decision on the gathered full-``[S]``
plane with the single-device tick's op sequence (full-shape uniform and
Poisson draws, the per-worker scatter order) and applies only its own
slab's rows, so a sharded run equals the unsharded one: on the CPU bit for
bit, on the card with every field exact but ``bytes_bin`` (the order of
``index_add_``'s atomic adds).

Each collective packs its tensors into one byte buffer, so the sharded tick
issues one ``all_gather`` per tick.  The buffer stays on the state's
device: gloo (the transport for ranks that share a card) takes CUDA
tensors and stages them through host memory itself; NCCL (one card per
rank) would gather on the cards, and is not verified.

Knobs, on :class:`~.engine.EngineConfig`: ``shard_servers=k`` is a
``(1, k)`` mesh; ``mesh_shape=(m, k)`` is ``m`` sweep lanes × ``k`` server
slabs (``m * k`` ranks); ``(k,)`` means ``(1, k)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

#: Mesh axis names: ``sweep`` maps independent grid/seed lanes, ``servers``
#: maps contiguous server slabs (the only axis the tick gathers over).
AXIS_SWEEP = "sweep"
AXIS_SERVERS = "servers"

#: EngineState fields stored as per-rank server slabs (server axis split
#: over :data:`AXIS_SERVERS`).  Everything else (the tick, PRNG key,
#: per-job counters, throughput bins) is replicated on every rank.
SLAB_FIELDS = frozenset({
    "qcount", "head", "arr_time", "wheel", "free_at", "known", "seg", "aux"})

#: Collectives this process has issued (each packed gather, broadcast or
#: reduction counts one); the sharded tick's count per tick is read off it.
COLLECTIVES = 0


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Resolved mesh geometry of one engine run: ``n_sweep`` × ``n_servers``
    ranks, ``n_servers`` dividing the engine's ``S``."""

    n_sweep: int = 1
    n_servers: int = 1

    @property
    def n_devices(self) -> int:
        return self.n_sweep * self.n_servers

    def slab(self, n_servers_total: int) -> int:
        """Rows of the server axis each rank owns."""
        return n_servers_total // self.n_servers

    def mesh(self, device_type: str = "cpu"):
        """The ``('sweep', 'servers')`` mesh over the first ``n_devices``
        ranks of the process group (a collective: every rank calls it)."""
        from ..launch.mesh import make_engine_mesh
        return make_engine_mesh(self.n_sweep, self.n_servers, device_type)


def world_size() -> int:
    """Ranks of the initialized process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_axes(cfg) -> tuple[int, int]:
    """``(n_sweep, n_servers)`` of ``EngineConfig.mesh_shape`` /
    ``shard_servers`` (``(1, 1)`` for the single-device path).  Raises
    ``ValueError`` for knobs that conflict, a mesh that is not 1- or 2-D,
    or axes below 1."""
    shape = cfg.mesh_shape
    shard_servers = int(getattr(cfg, "shard_servers", 1))
    if shard_servers < 1:
        raise ValueError(f"shard_servers must be >= 1, got {shard_servers}")
    if shape is None:
        shape = (1, shard_servers)
    else:
        shape = tuple(int(x) for x in shape)
        if len(shape) == 1:
            shape = (1, shape[0])
        if len(shape) != 2:
            raise ValueError(
                f"mesh_shape must be (sweep, servers) or (servers,), got "
                f"{cfg.mesh_shape!r}")
        if shard_servers != 1 and shard_servers != shape[1]:
            raise ValueError(
                f"shard_servers={shard_servers} conflicts with "
                f"mesh_shape={cfg.mesh_shape!r} (servers axis {shape[1]}); "
                "set one or make them agree")
    if shape[0] < 1 or shape[1] < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    return shape


def server_shards(cfg) -> int:
    """The number of server slabs ``cfg``'s mesh knobs ask for."""
    return mesh_axes(cfg)[1]


def resolve_shard(cfg) -> Optional[ShardSpec]:
    """``EngineConfig.mesh_shape`` / ``shard_servers`` as a
    :class:`ShardSpec`, or None for the single-device path.

    Raises ``ValueError`` at config time for the knobs :func:`mesh_axes`
    refuses, a server count the mesh cannot split evenly, or more mesh
    slots than ranks in the process group."""
    n_sweep, n_srv = shape = mesh_axes(cfg)
    if cfg.n_servers % n_srv:
        raise ValueError(
            f"n_servers={cfg.n_servers} is not divisible by the mesh's "
            f"servers axis ({n_srv}); each rank owns an equal slab")
    if n_sweep == 1 and n_srv == 1:
        return None
    spec = ShardSpec(n_sweep=n_sweep, n_servers=n_srv)
    avail = world_size()
    if avail < spec.n_devices:
        raise ValueError(
            f"mesh_shape {shape} needs {spec.n_devices} devices but only "
            f"{avail} are visible: sharding needs an initialized "
            f"torch.distributed process group with at least "
            f"{spec.n_devices} ranks; start them with "
            f"repro_torch.launch.mesh.spawn (or torchrun) and call the entry "
            f"point on every rank")
    return spec


def state_specs(state, spec: ShardSpec, lead: tuple = (None,)):
    """Per state field, the mesh axis each leading dimension is split over
    (a tuple, ``None`` for a dimension that is not split), in the
    ``EngineState`` shape.

    ``lead`` names the lane axis: ``(None,)`` when every rank holds all
    lanes (:func:`~.engine.run`), ``(AXIS_SWEEP,)`` when ``run_batch``
    splits its grid.  Slab fields add the server axis (every ``aux`` leaf
    leads with it too); the rest replicate.  ``t`` is a host int: ``()``."""
    srv = AXIS_SERVERS if spec.n_servers > 1 else None
    return type(state)(**{
        name: (() if name == "t" else
               (*lead, srv) if name in SLAB_FIELDS else tuple(lead))
        for name in state._fields})


# -- packed collectives -------------------------------------------------------

def _pack(tensors: Sequence[torch.Tensor]):
    """One flat byte buffer holding ``tensors`` (each padded to 8 bytes, so
    every piece can be viewed back at its dtype) and its layout."""
    pieces, layout = [], []
    for x in tensors:
        flat = x.contiguous().view(-1)
        if flat.numel() == 1:      # a one-element view may keep any stride
            flat = flat.as_strided((1,), (1,))
        b = flat.view(torch.uint8)
        pad = -b.numel() % 8
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        pieces.append(b)
        layout.append((x.dtype, x.shape, b.numel()))
    return torch.cat(pieces), layout


def _unpack(buf: torch.Tensor, layout) -> list[torch.Tensor]:
    """The tensors of ``_pack`` from a ``[n, bytes]`` buffer of ``n``
    ranks' packs, each ``[n, *shape]``."""
    out, off = [], 0
    for dtype, shape, n in layout:
        nbytes = shape.numel() * torch.empty((), dtype=dtype).element_size()
        out.append(buf[:, off:off + nbytes].view(dtype)
                   .view((buf.shape[0],) + tuple(shape)))
        off += n
    return out


def all_gather(tensors: Sequence[torch.Tensor], group, dim: int
               ) -> list[torch.Tensor]:
    """Each of ``tensors`` from every rank of ``group``, concatenated along
    ``dim`` in rank order: one collective."""
    global COLLECTIVES
    buf, layout = _pack(tensors)
    flat = buf.new_empty((dist.get_world_size(group), buf.numel()))
    dist.all_gather(list(flat), buf, group=group)
    COLLECTIVES += 1
    # [n, *shape] -> the ranks' pieces side by side along ``dim``.
    return [x.movedim(0, dim).flatten(dim, dim + 1)
            for x in _unpack(flat, layout)]


def broadcast(tensors: Sequence[torch.Tensor], src: int, group=None
              ) -> list[torch.Tensor]:
    """``tensors`` as global rank ``src`` holds them, on every rank of
    ``group`` (the world by default; the other ranks pass tensors of the
    same shapes and dtypes): one collective."""
    global COLLECTIVES
    buf, layout = _pack(tensors)
    dist.broadcast(buf, src=src, group=group)
    COLLECTIVES += 1
    return [x[0] for x in _unpack(buf[None], layout)]


def any_rank(flag: bool) -> bool:
    """``flag`` or-ed over every rank of the world: one collective."""
    global COLLECTIVES
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    x = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    COLLECTIVES += 1
    return bool(x.item())


def barrier() -> None:
    """Wait for every rank of the world (nothing without one)."""
    if dist.is_initialized():
        dist.barrier()


def is_writer() -> bool:
    """True on the one rank that writes shared files: rank 0 of the world,
    or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class ServerSlabs:
    """This rank's place on the mesh: its slab of the server axis (dim 1
    of the lanes-first state) and the groups it gathers over."""

    def __init__(self, spec: ShardSpec, mesh, n_servers: int):
        self.spec = spec
        self.group = mesh.get_group(AXIS_SERVERS)
        self.sweep_group = mesh.get_group(AXIS_SWEEP)
        self.sweep_index, self.index = (int(c) for c in mesh.get_coordinate())
        self.height = spec.slab(n_servers)
        self.row0 = self.index * self.height

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full ``[L, S, ...]`` tensor."""
        return x[:, self.row0:self.row0 + self.height]

    def gather(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Full ``[L, S, ...]`` tensors from every rank's ``[L, S/k, ...]``
        slab: one collective."""
        return all_gather(tensors, self.group, dim=1)

    def gather_lanes(self, tensors: Sequence[torch.Tensor]
                     ) -> list[torch.Tensor]:
        """Every sweep rank's lanes, concatenated on the lane axis: one
        collective."""
        return all_gather(tensors, self.sweep_group, dim=0)

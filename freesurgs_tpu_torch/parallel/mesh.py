"""The ranks of a run as a mesh (port of ``freesurgs_tpu/parallel/mesh.py``).

JAX drives a grid of devices from one controller. Here every rank is a
process running the same program on replicated parameters (SPMD), and a
``Mesh`` is this rank's place in a ``{data: d, tiles: t}`` grid of ranks:
rank r sits at (r // t, r % t), the JAX reshape of the device list. Its
``tiles`` group (one row: the ranks that split one image into bands of
tile rows, ``parallel/sharded.py``) and its ``data`` group (one column:
one rank per sequence, ``parallel/multiseq.py``) are process groups of
the default group; a group of one rank is None and needs no collective.

The backend follows the topology (``backend_for``): NCCL when each rank of
a host has a card of its own, gloo on the CPU or when ranks share a card
(NCCL refuses two ranks on one device). Gloo reduces a CUDA tensor by way
of the host (``all_reduce_sum`` / ``all_gather_cat`` stage it there on
that backend, always; so do ``send`` / ``recv`` / ``broadcast``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
DATA_AXIS = "data"


def backend_for(world_size: int, device) -> str:
    """NCCL when every rank of this host has a card of its own, else gloo."""
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda" and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> tuple[int, int]:
    """Join the default process group: from the arguments (``coordinator``
    a ``host:port`` or an init-method URL such as ``file://...``), or from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    a no-op without either, or when the group exists. ``device`` (the card
    unless "cpu") picks the backend. Returns (world_size, rank)."""
    if not dist.is_initialized():
        if coordinator is not None:
            init = coordinator if "://" in coordinator else \
                f"tcp://{coordinator}"
            world, rank = num_processes, process_id
        elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            init = "env://"
            world = int(os.environ["WORLD_SIZE"])
            rank = int(os.environ["RANK"])
        else:
            return 1, 0
        backend = backend_for(world, "cuda" if device is None else device)
        print(f"rank {rank}/{world}: {backend} process group", flush=True)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
    return dist.get_world_size(), dist.get_rank()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the grid and the process groups it reduces in."""

    shape: dict[str, int]          # {DATA_AXIS: d, TILE_AXIS: t}
    data_index: int
    tile_index: int
    tiles_group: Any               # None when t == 1
    data_group: Any                # None when d == 1
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[TILE_AXIS]

    @property
    def rank(self) -> int:
        return self.data_index * self.shape[TILE_AXIS] + self.tile_index

    def barrier(self) -> None:
        """Wait for every rank of the mesh (no-op on one rank)."""
        if self.size > 1:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def make_mesh(n_devices: int | None = None, data_parallel: int = 1,
              device=None) -> Mesh:
    """This rank's mesh over the default group's ranks (one rank when no
    group is initialized): ``data_parallel`` rows of n / data_parallel
    tile ranks. ``n_devices`` defaults to the world size and must equal
    it: every process is one rank of the mesh. ``device``: the card
    ``cuda:(local_rank % device_count)`` unless the caller names one
    ("cpu" for a CPU mesh). Every rank must call this, in the same
    order: it creates the groups."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: every "
                         "process is one rank of the mesh")
    if n % data_parallel:
        raise ValueError(f"{n} ranks do not split into {data_parallel} rows")
    t = n // data_parallel

    def group(ranks):
        return dist.new_group(ranks) if len(ranks) > 1 else None

    # every rank creates every group, in one order
    tiles = [group(list(range(i * t, (i + 1) * t)))
             for i in range(data_parallel)]
    data = [group(list(range(j, n, t))) for j in range(t)]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a CPU "
                               "mesh")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if world > 1 and dist.get_backend() == "nccl":
        torch.cuda.set_device(device)
    i, j = divmod(rank, t)
    return Mesh(shape={DATA_AXIS: data_parallel, TILE_AXIS: t},
                data_index=i, tile_index=j, tiles_group=tiles[i],
                data_group=data[j], device=device)


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor with the same bits on
    every rank (``x`` itself when the group is None)."""
    if group is None:
        return x
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def send(x: torch.Tensor, dst: int, group) -> None:
    """Send ``x`` to rank ``dst`` of ``group``."""
    src = x.cpu() if _staged(x, group) else x.contiguous()
    dist.send(src, dist.get_global_rank(group, dst), group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor shaped like ``like`` from rank ``src`` of ``group``."""
    buf = torch.empty_like(like, device="cpu" if _staged(like, group)
                           else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank of ``group`` (a new tensor)."""
    buf = x.cpu() if _staged(x, group) else x.contiguous().clone()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(x.device)


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x``, in rank order, concatenated along dim 0 (the
    list form of all_gather, which gloo and NCCL both have)."""
    if group is None:
        return x
    src = x.cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def same_on_all_ranks(tensors, group=None) -> bool:
    """Whether every rank of ``group`` (None: the default group) holds the
    same bits in ``tensors`` (True on one process)."""
    if not dist.is_initialized():
        return True
    raw = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                     for t in tensors])
    rows = all_gather_cat(raw[None], group or dist.group.WORLD)
    return bool((rows == rows[0]).all())

"""The process mesh and the start of a world of ranks (port of
``pmfm_tpu/parallel/mesh.py``).

The reference lays JAX devices out in a ``jax.sharding.Mesh`` whose
collectives ride the TPU interconnect. Here each device is one process, a
rank of a ``torch.distributed`` world, and the mesh lays the world's first
ranks out in ``shape`` (row-major, as the reference reshapes its device
list): a 1-D ``pop`` axis, or ``pop x frame``. Each rank knows its
coordinate on each axis, the process group of each axis (the ranks that
differ from it on that axis only) and its device.

Backend: NCCL where every rank of the host has a card of its own; gloo for
CPU ranks and for ranks that share a card (NCCL refuses two ranks on one
device). Under gloo a collective on a CUDA tensor goes through a host copy
(``all_gather``/``all_reduce`` here). Every ``init_process_group`` is given
a timeout of ``INIT_TIMEOUT_S``, so a rank that hangs fails the run within a
minute rather than torch's default thirty.

The reference's ``pop_sharding`` and ``replicated_sharding`` return JAX
``NamedSharding``s, which torch has no counterpart of; the port does not
need them (the state is replicated by construction: every rank runs the
same merge on the same gathered parents) and leaves them out.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

POP_AXIS = "pop"
FRAME_AXIS = "frame"  # optional second axis: frame sharding of the multi-frame fitness
INIT_TIMEOUT_S = 60

# the environment python -m torch.distributed.run sets for each rank
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def local_device(platform: str = "cuda") -> torch.device:
    """The device of this rank: the CPU, or the card ``LOCAL_RANK`` modulo
    the host's cards (ranks beyond the cards share them)."""
    if torch.device(platform).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("pmfm_tpu_torch: device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def _indexed(device) -> torch.device:
    """``device`` with its index (a bare ``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def backend_for(device: torch.device) -> str:
    """``nccl`` when ``device`` is a card and the host's ranks
    (``LOCAL_WORLD_SIZE``) each have one; else ``gloo``."""
    if device.type != "cuda":
        return "gloo"
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if ranks <= torch.cuda.device_count() else "gloo"


def initialize_multihost(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    mesh_size: int | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """Start this process's rank of the world, unless one is started.

    ``init_method`` (``file://...`` or ``tcp://host:port``) with
    ``world_size`` and ``rank`` start it explicitly; else the environment
    ``python -m torch.distributed.run`` sets (``MASTER_ADDR``, ``RANK``, ...)
    starts it; else, when a mesh of one is asked for (``mesh_size`` 1), a
    world of one in this process; else nothing happens, as the reference's
    does without coordination settings. The backend follows ``device``
    (``backend_for``; by default ``local_device()``, this rank's card,
    which raises without one: CPU ranks pass ``device="cpu"``). Returns
    whether a world was started here."""
    if dist.is_initialized():
        return False
    device = _indexed(local_device() if device is None else device)
    timeout = datetime.timedelta(seconds=INIT_TIMEOUT_S)
    alone = init_method is None and not all(k in os.environ for k in _LAUNCH_ENV)
    if alone and mesh_size != 1:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if alone:
        dist.init_process_group(backend_for(device), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return True
    dist.init_process_group(backend_for(device), init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, timeout=timeout)
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the mesh. ``shape`` maps each axis name to its
    size (as a JAX mesh's ``shape`` does); ``member`` is False on a rank of
    the world beyond the mesh's ranks, which must not run on it."""

    shape: dict
    axis_names: tuple
    rank: int
    member: bool
    coords: dict  # axis -> this rank's index on it
    groups: dict  # axis -> process group of that axis; "mesh" -> every rank of the mesh
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_root(self) -> bool:
        """The rank that writes files and prints: the mesh's first."""
        return self.rank == 0

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        if self.backend == "nccl":
            dist.barrier(group=self.groups["mesh"], device_ids=[self.device.index])
        else:
            dist.barrier(group=self.groups["mesh"])

    def all_gather(self, t: torch.Tensor, axis: str) -> list:
        """The ``t`` of every rank on ``axis``, in the axis's order (one
        ``dist.all_gather``; a host copy under gloo for a CUDA tensor)."""
        stage = self.backend == "gloo" and t.is_cuda
        src = t.cpu() if stage else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(out, src, group=self.groups[axis])
        return [o.to(t.device) for o in out] if stage else out

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks on ``axis`` (one
        ``dist.all_reduce``; a host copy under gloo for a CUDA tensor)."""
        stage = self.backend == "gloo" and t.is_cuda
        out = t.cpu() if stage else t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return out.to(t.device) if stage else out


def make_mesh(
    shape: Sequence[int] | None = None,
    axis_names: Sequence[str] = (POP_AXIS,),
    *,
    device: str | torch.device | None = None,
) -> Mesh:
    """The population-sharding mesh over the world's first ``prod(shape)``
    ranks (default: every rank on one ``pop`` axis), on ``device`` (by
    default ``local_device()``: this rank's card, which raises without one;
    CPU ranks pass ``device="cpu"``).
    Every rank of the world calls it, in the same order as the others
    (``dist.new_group`` is collective). Without a world, a mesh of one
    starts a world of one in this process (``initialize_multihost``).
    Raises ``ValueError`` when ``shape`` needs more ranks than the world
    has."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = tuple(int(s) for s in shape) if shape else (world,)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the world has {world}")
    names = tuple(axis_names[: len(shape)])
    if len(names) != len(shape):
        raise ValueError(f"mesh shape {shape} needs {len(shape)} axis names, got {names}")
    device = _indexed(local_device() if device is None else device)
    if not dist.is_initialized():
        initialize_multihost(mesh_size=1, device=device)
    rank = dist.get_rank()
    grid = torch.arange(n).reshape(shape)
    member = rank < n
    coords = {}
    if member:
        at = (grid == rank).nonzero()[0].tolist()
        coords = dict(zip(names, at))
    groups = {"mesh": dist.new_group(list(range(n)))}
    for ax, name in enumerate(names):
        # every line of ranks along this axis, each a group: created on
        # every rank, kept where this rank lies on it
        lines = grid.movedim(ax, -1).reshape(-1, shape[ax])
        for line in lines.tolist():
            g = dist.new_group(line)
            if rank in line:
                groups[name] = g
    return Mesh(shape=dict(zip(names, shape)), axis_names=names, rank=rank, member=member,
                coords=coords, groups=groups, device=device, backend=dist.get_backend())

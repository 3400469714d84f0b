"""Process groups for the map-parallel BA (port of
``ptam_cg_tpu.parallel.mesh`` onto ``torch.distributed``).

JAX's multi-process mode runs the same program in every process; so does
this port. A ``Mesh`` is the process group of the ranks that share one
point-sharded global BA, this rank's index in it, its device and the
axis name. Cameras are replicated on every rank, rank r owns points
``[r*Pl, (r+1)*Pl)``, and what JAX does with ``psum`` / ``all_gather``
inside ``shard_map`` the port does with the ``Mesh``'s ``all_reduce`` /
``all_gather`` (``parallel/sharded_ba.py``).

The backend is always the caller's: gloo for ranks on the CPU (and for
several ranks on one card, whose CUDA collectives gloo stages through the
host), NCCL for ranks on distinct cards. Nothing picks another backend
after a failure. A mesh without a process group (``torch.distributed``
not initialized) has one rank, and its collectives return their input.

- ``initialize_distributed``: ``dist.init_process_group`` from arguments
  or the environment (False when nothing is set)
- ``make_map_mesh``: the 1-D mesh over the first n ranks
- ``make_hybrid_mesh``: the (process, local device) grid, with a row
  group (a host's ranks) and a column group (one local index across
  hosts)
- ``pad_to_multiple``
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo",
                           timeout_s: float = 300.0) -> bool:
    """Join a process group if asked to by the arguments or the
    environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). ``coordinator`` is ``host:port``. Returns True when a group
    is active. ``backend`` goes to ``init_process_group`` as given
    ("gloo" or "nccl"); a collective that waits longer than ``timeout_s``
    raises instead of hanging the rank."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


@dataclasses.dataclass(eq=False)
class Mesh:
    """One axis of ranks: ``group`` (None without ``torch.distributed``),
    ``size`` ranks, this rank's ``rank`` in it, its ``device`` and the
    ``axis`` name. ``shape`` maps the axis to its size, as a JAX mesh's
    does."""

    group: Optional[object]
    size: int
    rank: int
    device: torch.device
    axis: str = "mp"

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}

    @property
    def backend(self) -> str:
        return "none" if self.group is None else dist.get_backend(self.group)

    def all_reduce(self, t: Tensor, op=dist.ReduceOp.SUM) -> Tensor:
        """The reduction of ``t`` over the ranks, on every rank (a new
        tensor; ``t`` is left as it is)."""
        out = t.clone()
        if self.group is not None:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_gather(self, t: Tensor) -> Tensor:
        """The ranks' ``t`` concatenated along dim 0, in rank order (every
        rank passes the same shape)."""
        if self.group is None:
            return t.clone()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def agree(self, value: float, op=dist.ReduceOp.MAX) -> float:
        """A host value every rank shares: ``op`` over the ranks' values
        (one collective on a host tensor of the group's device type)."""
        if self.group is None or self.size == 1:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self._collective_device())
        dist.all_reduce(t, op=op, group=self.group)
        return float(t.item())

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def _collective_device(self) -> torch.device:
        # NCCL reduces only CUDA tensors; gloo takes host tensors.
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_map_mesh(n_devices: Optional[int] = None, axis: str = "mp",
                  device="cuda") -> Optional[Mesh]:
    """The 1-D mesh over the first ``n_devices`` ranks (all by default):
    the map-parallel axis of the sharded global BA. Every rank of the
    default group must call it (``dist.new_group``); a rank outside the
    first ``n_devices`` gets None. Without ``torch.distributed`` the mesh
    has this process alone. ``device``: this rank's device (the card
    unless the caller asks for the CPU)."""
    dev = torch.device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a {n_devices}-rank mesh needs "
                             "torch.distributed (initialize_distributed)")
        return Mesh(None, 1, 0, dev, axis)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"{n} ranks asked of a world of {world}")
    group = (dist.group.WORLD if n == world
             else dist.new_group(ranks=list(range(n))))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, n, rank, dev, axis)


@dataclasses.dataclass(eq=False)
class HybridMesh:
    """The (process, local device) grid of ranks: ``grid[h, c]`` is the
    global rank of local index c on host h. ``meshes`` maps each axis to
    this rank's 1-D ``Mesh`` along it: the first axis ("host") joins one
    local index across hosts, the second ("chip") a host's ranks."""

    grid: np.ndarray
    axes: Tuple[str, str]
    meshes: dict


def make_hybrid_mesh(axes: Tuple[str, str] = ("host", "chip"),
                     local_size: Optional[int] = None,
                     device="cuda") -> HybridMesh:
    """The 2-D (host, chip) mesh: a reduction along "chip" stays within a
    host, one along "host" crosses hosts. ``local_size``: ranks a host
    (default ``LOCAL_WORLD_SIZE``, else the whole world: one host). Every
    rank must call it (it makes every row and column group)."""
    if not dist.is_initialized():
        raise ValueError("make_hybrid_mesh needs torch.distributed "
                         "(initialize_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_size:
        raise ValueError(f"world {world} is not a whole number of hosts "
                         f"of {local_size} ranks")
    grid = np.arange(world).reshape(world // local_size, local_size)
    dev = torch.device(device)
    h, c = divmod(rank, local_size)
    meshes = {}
    # Every rank creates every group, in the same order.
    for j in range(grid.shape[1]):
        g = dist.new_group(ranks=grid[:, j].tolist())
        if j == c:
            meshes[axes[0]] = Mesh(g, grid.shape[0], h, dev, axes[0])
    for i in range(grid.shape[0]):
        g = dist.new_group(ranks=grid[i].tolist())
        if i == h:
            meshes[axes[1]] = Mesh(g, grid.shape[1], c, dev, axes[1])
    return HybridMesh(grid, tuple(axes), meshes)


def pad_to_multiple(n: int, devices: int) -> int:
    """Round ``n`` up to a multiple of ``devices`` (a capacity the shards
    divide)."""
    return ((n + devices - 1) // devices) * devices

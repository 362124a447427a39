"""The rank group: the port's counterpart of the JAX package's device mesh.

The JAX package sweeps Gram tiles with ``shard_map`` over a 1-D
``jax.sharding.Mesh`` and lets GSPMD insert the collectives.  The torch
idiom is one process per GPU, so the "mesh" here is a small frozen
object: the ``torch.distributed`` process group this process belongs to,
its ``rank`` and ``size``, and the rank's ``device``.  The modules that
need collectives (``gram_sharded``, ``solve_dist``) call them on
``mesh.group``: NCCL on the card, gloo on the CPU.  Without an
initialised process group the mesh is a world of one that makes no
collective call.

JAX's ``replicated`` / ``row_sharded`` shardings have no counterpart: a
rank holds a replicated tensor as a full copy and its rows of a
row-sharded one as a slice, and ``row_span`` gives that slice.

The collectives below are the few the row-sharded factor and its solvers
need.  Each is a no-op in a world of one with no group.  A value that
decides whether a collective runs must be the same on every rank, or the
ranks deadlock: ``broadcast_array`` and ``agree`` hand rank 0's value to
every rank, and ``any_rank`` tells every rank whether one of them saw a
failure.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import resolve_device

__all__ = ["Mesh", "make_mesh", "TILE_AXIS", "row_span", "local_device",
           "all_gather_rows", "all_reduce_sum_", "any_rank", "broadcast_",
           "broadcast_array", "agree", "barrier", "is_root"]

TILE_AXIS = "tiles"   # the JAX mesh's axis name; the rank group has one


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D group of ranks.  ``group`` is None for a
    world of one, which makes no collective call."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def is_root(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes files and prints summaries: rank 0 of
    ``mesh``, or the only process when there is no mesh."""
    return mesh is None or mesh.rank == 0


def local_device(device="cuda", rank: int = 0) -> torch.device:
    """The rank's device: ``device`` as given if it names a CUDA index or
    the CPU, else ``cuda:{local rank}``.  The local rank is torchrun's
    ``LOCAL_RANK``, else the global rank modulo the cards of this host.
    Asking for CUDA where there is none raises."""
    device = resolve_device(str(device))
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    local = int(local) if local is not None else (
        rank % torch.cuda.device_count())
    return torch.device("cuda", local)


def make_mesh(n_devices: Optional[int] = None, *, device=None,
              group=None) -> Mesh:
    """The rank group of this process: ``group``, else the default process
    group when ``torch.distributed`` is initialised, else a world of one.

    The device is ``cuda:{local rank}`` unless ``device`` says otherwise
    (``"cpu"``); without CUDA that raises.  ``n_devices``, when given,
    must equal the group's size.  A group's backend must match the
    device: NCCL takes card tensors and gloo CPU tensors, and card
    tensors are never staged through the CPU to reach gloo."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size = 0, 1
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"need {n_devices} ranks, the group has {size}; start one "
            f"process per rank (torchrun --nproc_per_node={n_devices}, or "
            f"multihost.initialize)")
    dev = local_device("cuda" if device is None else device, rank)
    if group is not None:
        backend = dist.get_backend(group)
        if (backend == "nccl") != (dev.type == "cuda"):
            raise ValueError(
                f"a {backend} group cannot carry {dev.type} tensors: use "
                f"nccl on the card and gloo on the CPU")
    return Mesh(group, rank, size, dev)


def row_span(n_pad: int, mesh: Mesh) -> Tuple[int, int]:
    """[r0, r1) of this rank's rows of a row-sharded [n_pad, ...] array
    (n_pad a multiple of the group's size)."""
    if n_pad % mesh.size:
        raise ValueError(f"{n_pad} rows do not split over {mesh.size} "
                         f"ranks")
    per = n_pad // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def _src(mesh: Mesh) -> int:
    """The global rank of the group's rank 0."""
    return dist.get_global_rank(mesh.group, 0)


# one output buffer, no per-rank parts to concatenate (the newer name
# where this torch has it)
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` [rows, ...] stacked in rank order: the
    [size * rows, ...] tensor on every rank, gathered into one buffer."""
    if mesh.group is None:
        return t
    out = t.new_empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather_single(out, t.contiguous(), group=mesh.group)
    return out


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when ``flag`` is True on one of them."""
    if mesh.group is None:
        return bool(flag)
    v = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=mesh.device)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(v.item())


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place (``t`` contiguous, the same
    shape and dtype on every rank)."""
    if mesh.group is not None:
        dist.broadcast(t, _src(mesh), group=mesh.group)
    return t


def broadcast_array(a, mesh: Mesh):
    """Rank 0's numpy array (or None) on every rank; what the other ranks
    pass is ignored and may be None.  Its shape and dtype travel first."""
    if mesh.group is None:
        return a
    meta = [None if a is None else (np.shape(a), np.asarray(a).dtype.str)]
    if mesh.rank != 0:
        meta = [None]
    dist.broadcast_object_list(meta, _src(mesh), group=mesh.group,
                               device=mesh.device)
    if meta[0] is None:
        return None
    shape, dtype = meta[0]
    dtype = np.dtype(dtype)
    if mesh.rank == 0:
        t = torch.from_numpy(np.asarray(a, dtype, order="C")).to(
            mesh.device)
    else:
        t = torch.empty(shape, dtype=torch.from_numpy(
            np.zeros(0, dtype)).dtype, device=mesh.device)
    dist.broadcast(t, _src(mesh), group=mesh.group)
    return t.cpu().numpy()


def agree(value, mesh: Mesh):
    """Rank 0's picklable ``value`` (a float, an int, a string or None) on
    every rank."""
    if mesh.group is None:
        return value
    obj = [value if mesh.rank == 0 else None]
    dist.broadcast_object_list(obj, _src(mesh), group=mesh.group,
                               device=mesh.device)
    return obj[0]


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the group."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)

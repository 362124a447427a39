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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils import resolve_device

__all__ = ["Mesh", "make_mesh", "TILE_AXIS", "row_span", "local_device"]

TILE_AXIS = "tiles"   # the JAX mesh's axis name; the rank group has one


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D group of ranks.  ``group`` is None for a
    world of one, which makes no collective call."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device


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

"""Multi-process wiring.

PyTorch counterpart of ``cnn_gp_tpu/parallel/multihost.py``.  The
reference coordinates workers by flags and a shared filesystem; here each
process joins a ``torch.distributed`` process group, derives its worker
identity from its rank, and the contiguous-span tile partition
(``parallel/scheduler.py``) plus the NaN-merge store (or one shared Zarr
store) assemble the Gram with no other communication.

Launch recipe (wired into ``exp_mnist_resnet/save_kernel.py``):

    # torchrun sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT:
    torchrun --nproc_per_node=4 \\
        -m cnn_gp_tpu_torch.exp_mnist_resnet.save_kernel \\
        --coordinator_address=env --store_backend=zarr --out_path=out/k ...
    # explicit fleets, one line per process:
    python -m cnn_gp_tpu_torch.exp_mnist_resnet.save_kernel \\
        --coordinator_address=host0:12345 --num_processes=4 --process_id=$I \\
        --out_path=out/$(printf %02d $I)_nw04.h5 ...
    # then merge the shards and classify as run.bash does.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import is_root, local_device

__all__ = ["initialize", "worker_identity", "shutdown", "add_group_flags",
           "join_from_flags", "grouped", "is_root"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               timeout: Optional[datetime.timedelta] = None
               ) -> torch.device:
    """Join the process group and return this rank's device (a no-op for
    ``num_processes <= 1``, which returns the device alone).

    The backend is NCCL when the rank's device is CUDA and gloo on the
    CPU; the rank's card is made current before the group starts.  With
    the three arguments None (or ``coordinator_address="env"``) the
    rendezvous is ``env://``, torchrun's variables: the counterpart of
    JAX's auto-discovery on pods."""
    if num_processes is not None and num_processes <= 1:
        return local_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    if coordinator_address in (None, "env"):
        init, rank = "env://", None
    else:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id (or use torchrun and "
                             "--coordinator_address=env)")
        init, rank = f"tcp://{coordinator_address}", process_id
        kw.update(world_size=num_processes, rank=process_id)
    dev = local_device(device, int(os.environ.get("RANK", 0))
                       if rank is None else rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, **kw)
    return dev


def worker_identity() -> Tuple[int, int]:
    """(worker_rank, n_workers) for the tile partition, from the process
    group; (0, 1) when none is initialised, the reference flags'
    defaults."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def add_group_flags(p) -> None:
    """The flags that join a driver to a process group (``save_kernel``'s,
    and ``--device``'s meaning stays the rank's device)."""
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of the torch.distributed rendezvous (or "
                        "'env' under torchrun); when set, the factor is "
                        "row-sharded over the group's ranks")
    p.add_argument("--num_processes", type=int, default=None,
                   help="process count of the group")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in the group")


def join_from_flags(a):
    """``(device, mesh)`` for a driver's parsed flags: without
    ``--coordinator_address`` the device ``a.device`` names and no mesh;
    with it, the rank's device and the group's mesh (a world of one too,
    so the sharded factor runs)."""
    from ..utils import resolve_device
    from .mesh import make_mesh
    if not a.coordinator_address:
        return resolve_device(a.device), None
    device = initialize(a.coordinator_address, a.num_processes,
                        a.process_id, device=a.device)
    return device, make_mesh(device=device)


@contextlib.contextmanager
def grouped(a):
    """``join_from_flags(a)`` for a driver's body: yields ``(device,
    mesh)`` and leaves the group when the body ends, however it ends.
    Inside, ``is_root(mesh)`` says whether this process writes files and
    prints the summary."""
    device, mesh = join_from_flags(a)
    try:
        yield device, mesh
    finally:
        shutdown()

"""Gram assembly with the tile grid dealt over a rank group.

PyTorch counterpart of ``cnn_gp_tpu/parallel/gram_sharded.py``.  JAX
sweeps the tiles with ``shard_map`` over a device mesh; here each rank is
one process (``parallel/mesh.py``) and the same call runs on every rank:

* every rank holds the whole dataset on its device (MNIST-scale inputs
  are small) and deals the same contiguous tile manifest;
* the manifest is cut into rounds of ``size * tiles_per_round_per_device``
  tiles, padded to a multiple of ``size`` by repeating tile 0, and dealt
  round-robin: rank d computes ``chunk[d::size]``, each tile with
  ``gram._tile_body`` on the route ``gram.tile_spec`` chooses (the CUDA
  megakernel or the full covariance on the card), on maps from one
  pre-pass per image set on each rank;
* each tile is copied into a [b, b] slot of the round's send buffer (an
  edge tile is short: the block is padded, never the data, since a zero
  image has zero variance and its arccos is 0/0), and one ``all_gather``
  per round brings every rank's blocks to every rank;
* every rank reassembles the same ``out``; rank 0 alone reads and writes
  the store.  Its keep-mask reaches every rank in one collective, so every
  rank deals the same tiles (ranks that filtered on their own reads could
  wait in different collectives);
* a round's host work (the copy, the finiteness check, the writes) runs
  while the card computes the next round.  Every rank checks the same
  gathered blocks, so a non-finite value stops every rank in the same
  round;
* spans (``utils/timing.py``): the call's ``gram.call``, its
  ``gram.prepass``, and per round a ``gram.round`` holding its
  ``gram.tile``s, its ``gram.all_gather`` (attr ``bytes``, the gathered
  bytes) and the previous round's ``gram.wait`` (for its copy to the
  host) and ``gram.write``; ``progress`` prints rank 0's from them.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import timing
from ..utils.timing import print_timings
from . import gram, scheduler
from .mesh import Mesh, make_mesh

__all__ = ["compute_gram_sharded"]


def _agree(mesh: Mesh, keep: np.ndarray, has_store: bool, want_out: bool):
    """Rank 0's keep-mask and store flag, and whether a rank other than 0
    wants resumed tiles in its ``out``: the same answer on every rank, from
    one all-reduce (rank 0 alone fills the mask and the flag, the other
    ranks their wish)."""
    if mesh.group is None:
        return keep, has_store, False
    v = torch.zeros(len(keep) + 2, dtype=torch.int32)
    if mesh.rank == 0:
        v[:-2] = torch.from_numpy(keep.astype(np.int32))
        v[-2] = int(has_store)
    else:
        v[-1] = int(want_out)
    v = v.to(mesh.device)
    dist.all_reduce(v, group=mesh.group)
    v = v.cpu().numpy()
    return v[:-2] > 0, bool(v[-2]), bool(v[-1])


# entries of one broadcast block of the resumed values (64 MiB of float32)
_BACKFILL_ENTRIES = 1 << 24


def _backfill_every_rank(mesh: Mesh, stored: Optional[np.ndarray], out,
                         shape, symmetric: bool, symmetrize_out: bool):
    """``gram._backfill_out`` on every rank from rank 0's ``stored`` (None
    on the other ranks), broadcast a block of rows at a time so that a
    card holds one block, never the whole Gram.  A block carries rows
    [r0, r1) of ``stored`` and, where the out is mirrored, of its
    transpose; ranks without an ``out`` receive and drop them."""
    n1, n2 = shape
    mirror = symmetric and symmetrize_out
    rows = max(1, _BACKFILL_ENTRIES // n2)
    for r0 in range(0, n1, rows):
        r1 = min(n1, r0 + rows)
        t = torch.empty((1 + mirror, r1 - r0, n2), dtype=torch.float32,
                        device=mesh.device)
        if mesh.rank == 0:
            t[0].copy_(torch.from_numpy(stored[r0:r1]))
            if mirror:
                t[1].copy_(torch.from_numpy(stored[:, r0:r1].T))
        dist.broadcast(t, 0, group=mesh.group)
        if out is None:
            continue
        part = t.cpu().numpy()
        dst = out[r0:r1]
        have = ~np.isnan(part[0])
        dst[have] = part[0][have]
        if mirror:
            have_t = ~np.isnan(part[1]) & ~have
            dst[have_t] = part[1][have_t]


def _to_host(gathered: torch.Tensor):
    """Start the copy of a round's gathered blocks to the host: into
    pinned memory behind an event on the card, the tensor itself on the
    CPU."""
    if gathered.device.type != "cuda":
        return gathered, None
    host = torch.empty(gathered.shape, dtype=gathered.dtype,
                       pin_memory=True)
    host.copy_(gathered, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


@torch.no_grad()
def compute_gram_sharded(model, X, Z=None, *, batch_size: int = 200,
                         mesh: Optional[Mesh] = None,
                         store=None, name: Optional[str] = None,
                         out: Optional[np.ndarray] = None,
                         symmetrize_out: bool = True,
                         tiles_per_round_per_device: int = 8,
                         progress: bool = True,
                         print_interval: float = 2.0):
    """Assemble a Gram matrix with the tile grid dealt over ``mesh``.

    Call it on every rank with the same arguments.  Returns the ``out``
    array if used (NaN-free, symmetrised), else None; results also go to
    ``store[name]`` when rank 0 has a store (the other ranks' ``store`` is
    never touched and may be None).  Tiles resumed from rank 0's store
    reach the ``out`` of every rank."""
    if mesh is None:
        mesh = make_mesh()
    size, rank, device = mesh.size, mesh.rank, mesh.device

    symmetric = Z is None
    n1 = len(X)
    n2 = n1 if symmetric else len(Z)
    b = batch_size

    show = progress and rank == 0
    with (timing.recording() if show else contextlib.nullcontext()
          ) as found, gram.call_span("compute_gram_sharded", n1, n2,
                                     b) as call:
        manifest = scheduler.worker_manifest(n1, n2, b, symmetric)
        offsets = manifest[:, 1:3].astype(np.int64) * b  # [T, 2] offsets
        n_total = len(offsets)
        keep = np.ones(n_total, bool)
        has_store = rank == 0 and store is not None
        if has_store:
            assert name is not None
            store.create(name, n1, n2, b)
            done = store.done_mask(name)  # one bulk read, not T point reads
            keep = ~done[manifest[:, 1], manifest[:, 2]].astype(bool)
        keep, has_store, others_want = _agree(mesh, keep, has_store,
                                              out is not None)
        offsets = offsets[keep]
        n_tiles = len(offsets)
        call.set(tiles=n_tiles)
        if has_store and n_tiles < n_total:
            if others_want:
                _backfill_every_rank(mesh, store.read(name) if rank == 0
                                     else None, out, (n1, n2), symmetric,
                                     symmetrize_out)
            elif out is not None:
                gram._backfill_out(out, store.read(name), symmetric,
                                   symmetrize_out)
        if out is None and not has_store:
            out = np.full((n1, n2), np.nan, np.float32)
        if n_tiles == 0:
            # fully resumed (or empty): nothing to compute, nothing uploaded
            return out

        # ONE upload per set, reused by every round
        x_dev = gram._on_device(X, device)
        z_dev = x_dev if symmetric else gram._on_device(Z, device)
        spec = gram.tile_spec(model)
        # each rank's pre-pass: the maps of the sets it tiles, once per call
        maps = gram.set_maps(spec, x_dev, z_dev)

        def write(i0, j0, block):
            ni, nj = min(b, n1 - i0), min(b, n2 - j0)
            block = block[:ni, :nj]
            gram.check_block_finite(block, i0, j0)
            if rank == 0 and store is not None:
                store.write_tile(name, i0, j0, block)
            if out is not None:
                out[i0:i0 + ni, j0:j0 + nj] = block
                if symmetric and symmetrize_out and i0 != j0:
                    out[j0:j0 + nj, i0:i0 + ni] = block.T

        def drain(chunk, host, done):
            with timing.span("gram.wait"):
                if done is not None:
                    done.synchronize()
            with timing.span("gram.write"):
                # gathered[d, k] is chunk[k * size + d]: undo the deal
                blocks = host.numpy().transpose(1, 0, 2, 3).reshape(-1, b, b)
                for (i0, j0), blk in zip(chunk, blocks):
                    write(int(i0), int(j0), blk)

        round_tiles = size * tiles_per_round_per_device
        rounds = range(0, n_tiles, round_tiles)
        if show:
            rounds = print_timings(iter(list(rounds)),
                                   desc=name or "gram[ranks]",
                                   print_interval=print_interval,
                                   total=len(rounds))
        pending = None
        for r0 in rounds:
            with timing.span("gram.round", r0=int(r0)):
                chunk = offsets[r0:r0 + round_tiles]
                n_valid = len(chunk)
                # pad to a multiple of size; padded tiles recompute tile 0
                # and are dropped on write (every rank gathers the same
                # count)
                pad = (-n_valid) % size
                if pad:
                    chunk = np.concatenate([chunk,
                                            np.repeat(chunk[:1], pad, 0)])
                t_local = len(chunk) // size
                send = torch.zeros((t_local, b, b), dtype=torch.float32,
                                   device=device)
                for k, (i0, j0) in enumerate(chunk[rank::size]):
                    i0, j0 = int(i0), int(j0)
                    with timing.span("gram.tile", i0=i0, j0=j0):
                        blk = gram._tile_body(model, spec, x_dev, z_dev, i0,
                                              j0, b, symmetric, maps)
                        send[k, :blk.shape[0], :blk.shape[1]] = blk
                if mesh.group is None:
                    gathered = send[None]
                else:
                    gathered = torch.empty((size, t_local, b, b),
                                           dtype=torch.float32, device=device)
                    with timing.span("gram.all_gather",
                                     bytes=gathered.nbytes):
                        dist.all_gather(list(gathered.unbind(0)), send,
                                        group=mesh.group)
                host, done = _to_host(gathered)
                if pending is not None:
                    drain(*pending)
                pending = (chunk[:n_valid], host, done)
        drain(*pending)
    if show:
        t = timing.seconds(found, "gram.call", "gram.round")
        # a round drains the round before it; the last drain is the call's
        drained = timing.seconds(found, "gram.wait", "gram.write", parents=[
            sp.id for sp in found if sp.name == "gram.round"])
        last = timing.seconds(found, "gram.wait", "gram.write",
                              parents=[call.id])
        ph = {"dispatch": t["gram.round"] - sum(drained.values()),
              "wait": drained["gram.wait"] + last["gram.wait"],
              "write": drained["gram.write"] + last["gram.write"]}
        total = t["gram.call"]
        meps = n_tiles * b * b / max(total, 1e-9) / 1e6
        ph = ", ".join(f"{k} {v:.3f}s" for k, v in ph.items())
        print(f"[{name or 'gram[ranks]'}] {meps:.2f}M entries/s over "
              f"{size} rank(s): total {total:.3f}s ({ph})", flush=True)
    return out

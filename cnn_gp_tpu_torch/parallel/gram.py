"""Blockwise Gram-matrix assembly.

PyTorch counterpart of ``cnn_gp_tpu/parallel/gram.py``:

* The dataset is put on the compute device once; each tile is a slice of
  it, and the same-example fix-up is driven by a global-index mask, so one
  tile body serves diagonal and off-diagonal tiles.
* Models that ``ops.megakernel.match`` accepts (the paper ConvNet-GP
  family) compute every full tile with the fused megakernel, and their
  symmetric diagonal k(x_i, x_i) with its pre-pass; other models, and the
  diagonal k(x_i, z_i) of two sets, go through ``apply_kernel``.
* One tile per launch.  Launches are asynchronous; a consumer thread
  copies finished tiles to the host (on the producer's stream) and writes
  them, so device compute overlaps host writes.
* Work is split across workers with the reference's contiguous spans
  (``parallel/scheduler.py``), so shard files merge the same way, and
  tile-level resume skips completed tiles.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..kernels import apply_kernel
from ..ops import megakernel
from ..utils.timing import print_timings
from . import scheduler

__all__ = ["compute_gram", "compute_gram_diag", "save_K", "gram_in_memory",
           "check_block_finite"]


def _tile_body(model, spec, x_all, z_all, i0, j0, b, symmetric):
    x = x_all[i0:i0 + b]
    z = z_all[j0:j0 + b]
    mask = None
    if symmetric:
        rows = i0 + torch.arange(len(x), device=x.device)
        cols = j0 + torch.arange(len(z), device=z.device)
        mask = rows[:, None] == cols[None, :]
    if spec is not None:
        return megakernel.gram_tile(spec, x, z, mask)
    return apply_kernel(model, x, z, False, False, mask)


def _on_device(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def _backfill_out(out: np.ndarray, stored: np.ndarray, symmetric: bool,
                  symmetrize_out: bool) -> None:
    """Copy already-computed (non-NaN) store entries into ``out``."""
    have = ~np.isnan(stored)
    out[have] = stored[have]
    if symmetric and symmetrize_out:
        have_t = have.T & ~have
        out[have_t] = stored.T[have_t]


def check_block_finite(block: np.ndarray, i0: int, j0: int):
    """Refuse to persist NaN/Inf Gram entries: the tile stays unwritten,
    so a rerun recomputes exactly the bad tile."""
    if not np.isfinite(block).all():
        bad = np.argwhere(~np.isfinite(block))[0]
        raise FloatingPointError(
            f"non-finite kernel value at Gram element "
            f"({i0 + bad[0]}, {j0 + bad[1]}); tile ({i0}, {j0}) not "
            f"written. Check var_weight/var_bias scales or input data.")


class _WriteQueue:
    """Bounded queue of in-flight device tiles, drained by a consumer
    thread that copies each tile to the host, refuses non-finite values
    and writes it.

    The copies run on the producer's CUDA stream (``stream``; None on the
    CPU), so they are ordered after the launches that made the tiles.  The
    consumer owns all store/out writes.  A failure re-raises in the
    producer at the next ``push``/``flush``.  ``phases`` accumulates
    per-leg wall seconds (fetch / scan / write, and the producer's blocked
    time)."""

    def __init__(self, write, stream=None, depth: int = 2):
        self.write = write
        self.stream = stream
        self.phases = {"fetch": 0.0, "scan": 0.0, "write": 0.0,
                       "blocked": 0.0}
        self._q = queue.Queue(maxsize=depth)
        self._err = []
        self._t = threading.Thread(target=self._consume, daemon=True)
        self._t.start()

    def _consume(self):
        with torch.cuda.stream(self.stream):
            while True:
                item = self._q.get()
                if item is None:
                    return
                try:
                    self._drain_one(item)
                except Exception as e:     # surfaced at next push/flush
                    self._err.append(e)
                    return

    def _drain_one(self, item):
        i0, j0, dev_block = item
        t0 = time.perf_counter()
        block = dev_block.cpu().numpy()
        t1 = time.perf_counter()
        check_block_finite(block, i0, j0)
        t2 = time.perf_counter()
        self.write(i0, j0, block)
        self.phases["fetch"] += t1 - t0
        self.phases["scan"] += t2 - t1
        self.phases["write"] += time.perf_counter() - t2

    def push(self, i0, j0, dev_block):
        t0 = time.perf_counter()
        self._put((i0, j0, dev_block))     # blocks at depth
        self.phases["blocked"] += time.perf_counter() - t0

    def _put(self, item):
        # a consumer that errored stops draining, so a plain put could
        # block forever with the failure never surfacing
        while True:
            if self._err:
                raise self._err[0]
            try:
                self._q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def flush(self):
        """Stop the consumer after the queued tiles (also after a producer
        failure) and re-raise its failure, if any."""
        t0 = time.perf_counter()
        while self._t.is_alive():
            try:
                self._q.put(None, timeout=1.0)
                break
            except queue.Full:
                continue
        self._t.join()
        self.phases["blocked"] += time.perf_counter() - t0
        if self._err:
            raise self._err[0]


@torch.no_grad()
def compute_gram(model, X, Z=None, *, device, batch_size: int = 200,
                 store=None, name: Optional[str] = None,
                 worker_rank: int = 0, n_workers: int = 1,
                 out: Optional[np.ndarray] = None,
                 symmetrize_out: bool = True, progress: bool = True,
                 print_interval: float = 2.0, desc: Optional[str] = None):
    """Assemble a Gram matrix blockwise on ``device``.

    Z=None computes the symmetric upper triangle of K(X, X).  Results go
    to ``store[name]`` (HDF5, resumable) and/or an in-memory ``out``
    array.  Returns the ``out`` array if one was used, else None.
    """
    symmetric = Z is None
    n1 = len(X)
    n2 = n1 if symmetric else len(Z)
    b = batch_size

    manifest = scheduler.worker_manifest(n1, n2, b, symmetric, worker_rank,
                                         n_workers)
    if store is not None:
        assert name is not None
        store.create(name, n1, n2, b)
        n_before = len(manifest)
        done = store.done_mask(name)  # one bulk read, not T point reads
        manifest = manifest[~done[manifest[:, 1], manifest[:, 2]]
                            .astype(bool)]
        if out is not None and len(manifest) < n_before:
            # resume with an in-memory output: backfill the skipped tiles
            _backfill_out(out, store.read(name), symmetric, symmetrize_out)
    if out is None and store is None:
        out = np.full((n1, n2), np.nan, np.float32)

    device = torch.device(device)
    x_all = _on_device(X, device)
    z_all = x_all if symmetric else _on_device(Z, device)
    spec = megakernel.match(model)

    def write(i0, j0, block):
        if store is not None:
            store.write_tile(name, i0, j0, block)
        if out is not None:
            out[i0:i0 + block.shape[0], j0:j0 + block.shape[1]] = block
            if symmetric and symmetrize_out and i0 != j0:
                out[j0:j0 + block.shape[1], i0:i0 + block.shape[0]] = block.T

    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    wq = _WriteQueue(write, stream)
    offsets = manifest[:, 1:3].astype(np.int64) * b
    it = iter(offsets)
    if progress:
        it = print_timings(it, desc=desc or name or "gram",
                           print_interval=print_interval, total=len(offsets))
    t_all = time.perf_counter()
    t_dispatch = 0.0
    entries = 0
    try:
        for i0, j0 in it:
            i0, j0 = int(i0), int(j0)
            t0 = time.perf_counter()
            dev = _tile_body(model, spec, x_all, z_all, i0, j0, b, symmetric)
            t_dispatch += time.perf_counter() - t0
            entries += dev.numel()
            wq.push(i0, j0, dev)
    finally:
        wq.flush()
    if progress and manifest.size:
        ph = {k: round(v, 1) for k, v in wq.phases.items()}
        total = time.perf_counter() - t_all
        meps = entries / max(total, 1e-9) / 1e6
        print(f"[{desc or name or 'gram'}] {meps:.2f}M entries/s: total "
              f"{total:.1f}s  dispatch {t_dispatch:.1f}s  consumer {ph}",
              flush=True)
    return out


@torch.no_grad()
def compute_gram_diag(model, X, Z=None, *, device, batch_size: int = 200,
                      store=None, name: Optional[str] = None,
                      progress: bool = True, print_interval: float = 2.0):
    """Diagonal-only kernel k(x_i, z_i).  For Z None and a model that
    ``megakernel.match`` accepts, k(x_i, x_i) is the readout of the last
    halved pre-ReLU diagonal map, ``megakernel.diag_maps`` (the pre-pass
    kernel on the card, its plain version on the CPU); otherwise
    ``apply_kernel`` with ``diag=True``."""
    symmetric = Z is None
    n = len(X)
    b = min(batch_size, n)
    device = torch.device(device)
    x_all = _on_device(X, device)
    z_all = x_all if symmetric else _on_device(Z, device)
    if store is not None:
        assert name is not None
        store.create(name, n, None, b, diag=True)
    offsets = [i for i in range(0, n, b)
               if store is None or not store.tile_done(name, i, None)]
    # resume: start from the stored values so skipped tiles are not NaN
    n_tiles_total = len(range(0, n, b))
    out = (store.read(name)
           if store is not None and len(offsets) < n_tiles_total
           else np.full(n, np.nan, np.float32))
    if store is not None and not offsets:
        return out
    if progress:
        offsets = print_timings(iter(list(offsets)), desc=name or "diag",
                                print_interval=print_interval,
                                total=len(offsets))
    spec = megakernel.match(model) if symmetric else None
    for i0 in offsets:
        if spec is not None:
            dev = megakernel.diag_readout(spec, x_all[i0:i0 + b])
        else:
            dev = apply_kernel(model, x_all[i0:i0 + b], z_all[i0:i0 + b],
                               symmetric, True)
        block = dev.cpu().numpy()
        check_block_finite(block[:, None], i0, 0)
        out[i0:i0 + len(block)] = block
        if store is not None:
            store.write_tile(name, i0, None, block)
    return out


def save_K(store, model, name: str, X, X2, diag: bool, batch_size: int,
           device, worker_rank: int = 0, n_workers: int = 1,
           print_interval: float = 2.0):
    """Script-level helper with the reference's ``save_K`` signature plus
    ``device``, with tile-level resume."""
    x = X.images if hasattr(X, "images") else X
    x2 = X2.images if (X2 is not None and hasattr(X2, "images")) else X2
    if diag:
        compute_gram_diag(model, x, x2, device=device,
                          batch_size=batch_size, store=store, name=name,
                          print_interval=print_interval)
    else:
        compute_gram(model, x, x2, device=device, batch_size=batch_size,
                     store=store, name=name, worker_rank=worker_rank,
                     n_workers=n_workers, print_interval=print_interval,
                     desc=f"{name} (worker {worker_rank}/{n_workers})")


def gram_in_memory(model, X, Z=None, *, device, **kw) -> np.ndarray:
    """Convenience: full (symmetrised) Gram as a numpy array."""
    x = X.images if hasattr(X, "images") else X
    z = Z.images if (Z is not None and hasattr(Z, "images")) else Z
    n1 = len(x)
    n2 = n1 if z is None else len(z)
    out = np.full((n1, n2), np.nan, np.float32)
    compute_gram(model, x, z, device=device, out=out, **kw)
    return out

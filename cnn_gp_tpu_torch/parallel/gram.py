"""Blockwise Gram-matrix assembly.

PyTorch counterpart of ``cnn_gp_tpu/parallel/gram.py``:

* The dataset is put on the compute device once; each tile is a slice of
  it, and the same-example fix-up is driven by a global-index mask, so one
  tile body serves diagonal and off-diagonal tiles.
* ``tile_spec`` is every Gram-level caller's one choice of route: the
  megakernel's spec (the paper ConvNet-GP family), the full covariance's
  (a model with an ``AvgPool2d``), or None.  A spec's pre-pass runs once
  per image set per call (``set_maps``) and each tile reads its rows of
  those maps.  Other models, and the diagonal k(x_i, z_i) of two sets, go
  through ``apply_kernel``.
* One tile per launch.  Launches are asynchronous; a consumer thread
  copies finished tiles to the host (on the producer's stream) and writes
  them, so device compute overlaps host writes.
* Work is split across workers with the reference's contiguous spans
  (``parallel/scheduler.py``), so shard files merge the same way, and
  tile-level resume skips completed tiles.
* Each Gram-level call is a ``gram.call`` span (``call_span``) over a
  ``gram.prepass`` and one ``gram.tile`` per tile (``utils/timing.py``);
  the ``progress`` printout is read from them.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..kernels import apply_kernel
from ..ops import arccos, boxfilter, fullcov, megakernel
from ..utils import timing
from ..utils.timing import print_timings
from . import scheduler

__all__ = ["compute_gram", "compute_gram_diag", "save_K", "gram_in_memory",
           "check_block_finite", "set_maps", "tile_spec", "call_span"]

# the kernel modules whose ``COUNTERS`` a Gram call's span reports
_COUNTERS = (megakernel, boxfilter, arccos, fullcov)


def _launch_counts() -> dict:
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{c}": getattr(m, c)
            for m in _COUNTERS for c in m.COUNTERS}


@contextlib.contextmanager
def call_span(entry: str, n1: int, n2: int, b: int):
    """The ``gram.call`` span of one Gram-level call (``entry``, the
    sizes; the caller ``set``s ``tiles``), with each launch counter's
    change over the call as an attr (``megakernel.launches`` and so on).
    Yields the span, or the do-nothing one when spans do not record."""
    if not timing.on():
        yield timing.span("gram.call")
        return
    before = _launch_counts()
    with timing.span("gram.call", entry=entry, n1=n1, n2=n2, b=b) as s:
        yield s
        s.set(**{k: v - before[k] for k, v in _launch_counts().items()})


def tile_spec(model):
    """The one choice of a Gram tile's route: the megakernel's spec
    (``megakernel.match``), the full covariance's for a model with a pool
    (``fullcov.match``: also an ``NTK``'s), or None (``apply_kernel`` per
    tile).  A spec's ``maps``, ``rows``, ``tile``, ``readout``, ``sizes``
    and ``fields`` (1, or 2 with an NTK's tangent) are the route;
    only its module knows how its maps are laid out."""
    spec = megakernel.match(model)
    return spec if spec is not None else fullcov.match(model)


def set_maps(spec, x_all, z_all=None):
    """The pre-pass maps of the image sets a Gram-level call tiles, each
    computed once, in one ``gram.prepass`` span: ``(dx, dz)``, ``spec.maps``
    of ``x_all`` and of ``z_all`` (``dz`` is ``dx`` when ``z_all`` is
    ``x_all`` or None); None when ``spec`` is None.  Maps depend on the
    hyperparameters, so a new spec needs new maps."""
    if spec is None:
        return None
    with timing.span("gram.prepass") as s:
        sets = [x_all] if z_all is None or z_all is x_all else [x_all, z_all]
        maps = [spec.maps(x) for x in sets]
        s.set(sets=len(sets), images=sum(len(x) for x in sets),
              maps=spec.sizes(maps[0]), fields=spec.fields,
              bytes=sum(m.nbytes for m in maps))
    return maps[0], maps[-1]


def _tile_body(model, spec, x_all, z_all, i0, j0, b, symmetric, maps):
    """The [<=b, <=b] tile of K(x_all, z_all) at (i0, j0), with the
    global-index same-example mask when ``symmetric``: ``spec.tile`` on
    the tile's rows of ``maps`` (``set_maps``), or ``apply_kernel``."""
    x = x_all[i0:i0 + b]
    z = z_all[j0:j0 + b]
    mask = None
    if symmetric:
        rows = i0 + torch.arange(len(x), device=x.device)
        cols = j0 + torch.arange(len(z), device=z.device)
        mask = rows[:, None] == cols[None, :]
    if spec is None:
        return apply_kernel(model, x, z, False, False, mask)
    dx, dz = maps
    return spec.tile(x, z, spec.rows(dx, i0, b), spec.rows(dz, j0, b), mask)


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
    producer at the next ``push``/``flush``.  Spans: per tile the
    consumer's ``gram.fetch``, ``gram.scan`` and ``gram.write``, children
    of the span open where the queue was made (the call's ``gram.call``),
    and the producer's ``gram.blocked`` waits."""

    def __init__(self, write, stream=None, depth: int = 2):
        self.write = write
        self.stream = stream
        self._parent = timing.current()
        self._q = queue.Queue(maxsize=depth)
        self._err = []
        self._t = threading.Thread(target=self._consume, daemon=True)
        self._t.start()

    def _consume(self):
        with torch.cuda.stream(self.stream), timing.attached(self._parent):
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
        with timing.span("gram.fetch"):
            block = dev_block.cpu().numpy()
        with timing.span("gram.scan"):
            check_block_finite(block, i0, j0)
        with timing.span("gram.write"):
            self.write(i0, j0, block)

    def push(self, i0, j0, dev_block):
        with timing.span("gram.blocked"):
            self._put((i0, j0, dev_block))     # blocks at depth

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
        with timing.span("gram.blocked"):
            while self._t.is_alive():
                try:
                    self._q.put(None, timeout=1.0)
                    break
                except queue.Full:
                    continue
            self._t.join()
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
    ``progress`` prints the progress line and, at the end, the call's
    rate and host seconds from its spans.
    """
    symmetric = Z is None
    n1 = len(X)
    n2 = n1 if symmetric else len(Z)
    b = batch_size
    with (timing.recording() if progress else contextlib.nullcontext()
          ) as found, call_span("compute_gram", n1, n2, b) as call:
        manifest = scheduler.worker_manifest(n1, n2, b, symmetric,
                                             worker_rank, n_workers)
        if store is not None:
            assert name is not None
            store.create(name, n1, n2, b)
            n_before = len(manifest)
            done = store.done_mask(name)  # one bulk read, not T point reads
            manifest = manifest[~done[manifest[:, 1], manifest[:, 2]]
                                .astype(bool)]
            if out is not None and len(manifest) < n_before:
                # resume with an in-memory output: backfill the skipped
                # tiles
                _backfill_out(out, store.read(name), symmetric,
                              symmetrize_out)
        if out is None and store is None:
            out = np.full((n1, n2), np.nan, np.float32)

        device = torch.device(device)
        x_all = _on_device(X, device)
        z_all = x_all if symmetric else _on_device(Z, device)
        spec = tile_spec(model)

        def write(i0, j0, block):
            if store is not None:
                store.write_tile(name, i0, j0, block)
            if out is not None:
                out[i0:i0 + block.shape[0], j0:j0 + block.shape[1]] = block
                if symmetric and symmetrize_out and i0 != j0:
                    out[j0:j0 + block.shape[1],
                        i0:i0 + block.shape[0]] = block.T

        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)
        offsets = manifest[:, 1:3].astype(np.int64) * b
        call.set(tiles=len(offsets))
        wq = _WriteQueue(write, stream)
        it = iter(offsets)
        if progress:
            it = print_timings(it, desc=desc or name or "gram",
                               print_interval=print_interval,
                               total=len(offsets))
        # one pre-pass per image set (none when a resume left nothing to do)
        maps = set_maps(spec, x_all, z_all) if len(offsets) else None
        try:
            for i0, j0 in it:
                i0, j0 = int(i0), int(j0)
                with timing.span("gram.tile", i0=i0, j0=j0):
                    dev = _tile_body(model, spec, x_all, z_all, i0, j0, b,
                                     symmetric, maps)
                wq.push(i0, j0, dev)
        finally:
            wq.flush()
    if progress and len(offsets):
        t = timing.seconds(found, "gram.call", "gram.tile", "gram.fetch",
                           "gram.scan", "gram.write", "gram.blocked")
        entries = sum(min(b, n1 - i0) * min(b, n2 - j0)
                      for i0, j0 in offsets)
        total = t.pop("gram.call")
        dispatch = t.pop("gram.tile")
        ph = {k.split(".")[1]: round(v, 1) for k, v in t.items()}
        print(f"[{desc or name or 'gram'}] "
              f"{entries / max(total, 1e-9) / 1e6:.2f}M entries/s: total "
              f"{total:.1f}s  dispatch {dispatch:.1f}s  consumer {ph}",
              flush=True)
    return out


@torch.no_grad()
def compute_gram_diag(model, X, Z=None, *, device, batch_size: int = 200,
                      store=None, name: Optional[str] = None,
                      progress: bool = True, print_interval: float = 2.0):
    """Diagonal-only kernel k(x_i, z_i).  For Z None and a model with a
    ``tile_spec``, k(x_i, x_i) is the spec's ``readout``, read out of
    each batch's pre-pass (the kernels on the card, their plain versions
    on the CPU); otherwise ``apply_kernel`` with ``diag=True``."""
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
    spec = tile_spec(model) if symmetric else None
    for i0 in offsets:
        x = x_all[i0:i0 + b]
        dev = (spec.readout(x) if spec is not None else
               apply_kernel(model, x, z_all[i0:i0 + b], symmetric, True))
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

"""Iterator-style views of the tile schedule (API compatibility).

A copy of ``cnn_gp_tpu/data/iterators.py`` over the port's
``parallel/scheduler.py``.  The reference exposes its Gram schedule as
Python iterators yielding ``(same_block, (i_offset, x_batch), (j_offset,
z_batch))``; the port's engine consumes static manifests instead, and
these thin views keep user code written against the iterator API working
(e.g. custom save loops that call a kernel per yielded pair).  Batches
are sliced from the array that is given, so there is no DataLoader
restart machinery.
"""

from __future__ import annotations

import numpy as np

from ..parallel import scheduler

__all__ = ["ProductIterator", "DiagIterator"]


def _arrays(x):
    """(images, labels) from an ArrayDataset or a bare image array."""
    if hasattr(x, "images"):
        return x.images, x.labels
    x = np.asarray(x)
    return x, None


class _Batcher:
    def __init__(self, images, labels):
        self.images = images
        self.labels = labels

    def batch(self, i0, b):
        """(images, labels) batch -- the same pair a reference DataLoader
        yields, so ``(i, (x, _y))`` unpacking keeps working."""
        lbl = None if self.labels is None else self.labels[i0:i0 + b]
        return (self.images[i0:i0 + b], lbl)


class ProductIterator:
    """Yields this worker's Gram block pairs in reference order
    (reference: cnn_gp/data.py:36-96)."""

    def __init__(self, batch_size: int, X, X2=None, worker_rank: int = 0,
                 n_workers: int = 1):
        self.x = _Batcher(*_arrays(X))
        self.same = X2 is None
        self.z = self.x if self.same else _Batcher(*_arrays(X2))
        self.batch_size = batch_size
        self.manifest = scheduler.worker_manifest(
            len(self.x.images), len(self.z.images), batch_size, self.same,
            worker_rank, n_workers)
        self._pos = 0

    def __len__(self):
        return len(self.manifest)

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.manifest):
            raise StopIteration
        is_diag, ti, tj = (int(v) for v in self.manifest[self._pos])
        self._pos += 1
        b = self.batch_size
        i0, j0 = ti * b, tj * b
        return (bool(is_diag),
                (i0, self.x.batch(i0, b)),
                (j0, self.z.batch(j0, b)))


class DiagIterator:
    """Yields aligned diagonal batches (reference: cnn_gp/data.py:99-126)."""

    def __init__(self, batch_size: int, X, X2=None):
        self.x = _Batcher(*_arrays(X))
        self.same = X2 is None
        self.z = self.x if self.same else _Batcher(*_arrays(X2))
        self.batch_size = batch_size
        n = min(len(self.x.images), len(self.z.images))
        self.offsets = list(range(0, n, batch_size))
        self._pos = 0

    def __len__(self):
        return len(self.offsets)

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self.offsets):
            raise StopIteration
        i0 = self.offsets[self._pos]
        self._pos += 1
        b = self.batch_size
        return (self.same, (i0, self.x.batch(i0, b)),
                (i0, self.z.batch(i0, b)))

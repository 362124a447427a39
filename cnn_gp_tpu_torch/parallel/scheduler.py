"""Gram-tile scheduling: static manifests of (i, j) tile coordinates.

A copy of ``cnn_gp_tpu/parallel/scheduler.py``: the same enumeration
order and the same contiguous worker spans, so shard files written by
either package merge the same way.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils import round_up_div

__all__ = ["n_tiles", "tile_manifest", "worker_span", "worker_manifest",
           "tile_offsets", "round_up_div"]


def n_tiles(n1_batches: int, n2_batches: int, symmetric: bool) -> int:
    """Tiles of the manifest over ``n1_batches`` x ``n2_batches`` batches
    (the upper triangle when symmetric, at least one tile, as the
    reference counts)."""
    if symmetric:
        return max(1, n1_batches * (n1_batches + 1) // 2)
    return n1_batches * n2_batches


def tile_manifest(n1_batches: int, n2_batches: int, symmetric: bool
                  ) -> np.ndarray:
    """[T, 3] int32 rows (is_diag, i, j) in the reference's enumeration
    order: for each row i, the diagonal tile first, then j > i."""
    rows = []
    for i in range(n1_batches):
        if symmetric:
            rows.append((1, i, i))
            for j in range(i + 1, n2_batches):
                rows.append((0, i, j))
        else:
            for j in range(n2_batches):
                rows.append((0, i, j))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 3)


def worker_span(total: int, worker_rank: int, n_workers: int
                ) -> Tuple[int, int]:
    """(start, count) of this worker's contiguous span; equal split with the
    remainder given to low ranks."""
    per = np.full(n_workers, total // n_workers, dtype=np.int64)
    per[:total % n_workers] += 1
    start = int(per[:worker_rank].sum())
    return start, int(per[worker_rank])


def worker_manifest(n1: int, n2, batch_size: int, symmetric: bool,
                    worker_rank: int = 0, n_workers: int = 1) -> np.ndarray:
    """This worker's contiguous [t, 3] slice of the tile manifest, the
    reference's partition."""
    n1_b = round_up_div(n1, batch_size)
    n2_b = n1_b if symmetric else round_up_div(n2, batch_size)
    manifest = tile_manifest(n1_b, n2_b, symmetric)
    start, count = worker_span(len(manifest), worker_rank, n_workers)
    return manifest[start:start + count]


def tile_offsets(n1: int, n2: int, batch_size: int, symmetric: bool):
    """(i0, j0) element offsets of the whole manifest, in its order."""
    for _, i, j in worker_manifest(n1, n2, batch_size, symmetric):
        yield int(i) * batch_size, int(j) * batch_size

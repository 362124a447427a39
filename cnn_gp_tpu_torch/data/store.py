"""Chunked HDF5 Gram store with tile-level resume.

A copy of ``cnn_gp_tpu/data/store.py`` with ``h5py`` imported only when a
store is opened, so the rest of the port runs without it.  The layout is
the same, so a file written by either package opens in the other: float32
datasets shaped ``(1, N, N2)`` (diag: ``(1, N)``), chunks ``(1, bs, bs)``,
``fillvalue=NaN``, names ``Kxx / Kxvx / Kxtx / Kv_diag / Kt_diag``, the
scheduler's tile size in the ``batch_size`` attribute, and per-tile
completion bitmaps in ``_done/<name>``.  ``merge_stores`` NaN-fills a
destination from worker shards and OR-merges the bitmaps.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from ..utils import round_up_div as _cdiv

__all__ = ["GramStore", "merge_stores"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for GramStore and "
                          "merge_stores") from e
    return h5py


def _scan_missing_tiles(shape, bs, read_diag, read_rows,
                        upper_triangle_only):
    """NaN-scan over a logical [n] / [n, n2] Gram dataset.
    ``read_diag(i, hi) -> [hi-i]``; ``read_rows(i, hi, j0) ->
    [hi-i, n2-j0]`` — the row stripe is read from column ``j0`` on, so an
    upper-triangle scan reads half the bytes."""
    missing = []
    if len(shape) == 1:
        for i in range(0, shape[0], bs):
            if np.isnan(read_diag(i, min(i + bs, shape[0]))).any():
                missing.append((i, -1))
    else:
        n, n2 = shape
        for i in range(0, n, bs):
            j0 = i if upper_triangle_only else 0
            if j0 >= n2:
                continue
            row = read_rows(i, min(i + bs, n), j0)
            for j in range(j0, n2, bs):
                if np.isnan(row[:, j - j0:j - j0 + bs]).any():
                    missing.append((i, j))
    return np.asarray(missing, dtype=np.int64).reshape(-1, 2)


class GramStore:
    """One HDF5 file of Gram datasets plus completion bitmaps."""

    def __init__(self, path: str, mode: str = "a"):
        h5py = _h5py()
        if mode == "a":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.f = h5py.File(path, mode)
        self.path = path

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- datasets ----------------------------------------------------------
    def create(self, name: str, n: int, n2: Optional[int], batch_size: int,
               diag: bool = False):
        """Create a NaN-filled dataset (idempotent for identical params).

        Reopening with a different batch_size would silently corrupt
        tile-level resume (the completion bitmap is indexed in tiles of
        the *original* size), so that is an error.
        """
        if name in self.f:
            existing_bs = self.batch_size(name)
            if existing_bs != batch_size:
                raise ValueError(
                    f"{self.path}:{name} was created with batch_size="
                    f"{existing_bs}; resuming with batch_size="
                    f"{batch_size} would corrupt tile-level resume. Use "
                    f"the original batch size or a fresh store.")
            shape = (1, n) if diag else (1, n, n if n2 is None else n2)
            if tuple(self.f[name].shape) != shape:
                raise ValueError(
                    f"{self.path}:{name} has shape {self.f[name].shape}, "
                    f"expected {shape}; dataset size changed between runs")
            return self.f[name]
        if diag:
            shape, maxshape = (1, n), (None, n)
            chunks = (1, min(batch_size, n))
            done_shape = (_cdiv(n, batch_size),)
        else:
            n2 = n if n2 is None else n2
            shape, maxshape = (1, n, n2), (None, n, n2)
            chunks = (1, min(batch_size, n), min(batch_size, n2))
            done_shape = (_cdiv(n, batch_size), _cdiv(n2, batch_size))
        ds = self.f.create_dataset(name, shape=shape, dtype=np.float32,
                                   fillvalue=np.nan, chunks=chunks,
                                   maxshape=maxshape)
        # the SCHEDULER's tile size (unclamped): the completion bitmap is
        # indexed in these units; chunks are clamped per dimension purely
        # as a storage detail
        ds.attrs["batch_size"] = batch_size
        self.f.create_dataset(f"_done/{name}", shape=done_shape,
                              dtype=np.uint8, fillvalue=0)
        return ds

    def batch_size(self, name: str) -> int:
        return int(self.f[name].attrs.get(
            "batch_size", self.f[name].chunks[-1]))

    # -- tile IO -----------------------------------------------------------
    def write_tile(self, name: str, i: int, j: Optional[int],
                   block: np.ndarray):
        """Write one tile at element offsets (i, j); marks it complete."""
        ds = self.f[name]
        bs = self.batch_size(name)
        if j is None:  # diag
            ds[0, i:i + len(block)] = block
            self._done(name)[i // bs] = 1
        else:
            ds[0, i:i + block.shape[0], j:j + block.shape[1]] = block
            self._done(name)[i // bs, j // bs] = 1

    def tile_done(self, name: str, i: int, j: Optional[int]) -> bool:
        bs = self.batch_size(name)
        d = self._done(name)
        return bool(d[i // bs] if j is None else d[i // bs, j // bs])

    def done_mask(self, name: str) -> np.ndarray:
        """Whole completion bitmap in one read."""
        return np.asarray(self._done(name))

    def _done(self, name: str):
        key = f"_done/{name}"
        if key not in self.f:  # file written by the reference tooling
            ds = self.f[name]
            shape = tuple(_cdiv(s, self.batch_size(name))
                          for s in ds.shape[1:])
            if self.f.mode == "r":
                # read-only consumer of a foreign file: nothing is done
                # as far as the bitmap knows (the NaN scan is the real
                # integrity check); lazily creating would raise
                return np.zeros(shape, np.uint8)
            self.f.create_dataset(key, shape=shape, dtype=np.uint8,
                                  fillvalue=0)
        return self.f[key]

    # -- reading -----------------------------------------------------------
    def read(self, name: str, dtype=np.float32) -> np.ndarray:
        ds = self.f[name]
        out = np.empty(ds.shape[1:], dtype=np.float32)
        ds.read_direct(out, source_sel=np.s_[0, ...])
        return out.astype(dtype, copy=False)

    def shape(self, name: str) -> tuple:
        """Dataset shape without the leading resume dimension."""
        return tuple(self.f[name].shape[1:])

    def read_rows(self, name: str, r0: int, r1: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
        """Row-block read [r0:r1) straight into ``out`` (float32): the
        producer side of ``parallel.chol_dist.chol_solve_stream_from_store``."""
        ds = self.f[name]
        if out is None:
            out = np.empty((r1 - r0,) + ds.shape[2:], np.float32)
        ds.read_direct(out, source_sel=np.s_[0, r0:r1])
        return out

    def dataset_names(self) -> Iterable[str]:
        return [k for k in self.f.keys() if k != "_done"]

    # -- integrity ---------------------------------------------------------
    def missing_tiles(self, name: str,
                      upper_triangle_only: bool = False) -> np.ndarray:
        """[M, 2] element offsets of tiles containing NaN (scan-based, so it
        also validates files from other writers)."""
        ds = self.f[name]
        bs = self.batch_size(name)
        return _scan_missing_tiles(
            ds.shape[1:], bs,
            lambda i, hi: ds[0, i:hi],
            lambda i, hi, j0: ds[0, i:hi, j0:],
            upper_triangle_only)

    def assert_complete(self, name: str, upper_triangle_only: bool = False):
        miss = self.missing_tiles(name, upper_triangle_only)
        if len(miss):
            raise RuntimeError(
                f"{self.path}:{name} has {len(miss)} incomplete tiles, "
                f"first at element offset {tuple(miss[0])}; rerun assembly "
                f"to fill them (tile-level resume will skip finished ones)")


def merge_stores(dest_path: str, src_paths: Iterable[str],
                 row_block: int = 4096):
    """NaN-fill merge of worker shard files into ``dest_path``.  Entries
    of ``dest`` that are NaN take the corresponding ``src`` values.

    Streams ``row_block`` rows at a time, so peak memory is
    3 * row_block * N2 * 4 bytes rather than whole [N, N2] slabs."""
    h5py = _h5py()
    with h5py.File(dest_path, "a") as dest:
        for path in src_paths:
            with h5py.File(path, "r") as src:
                for k in dest.keys():
                    if k == "_done" or k not in src:
                        continue
                    dd, sd = dest[k], src[k]
                    for i in range(dd.shape[0]):
                        for r0 in range(0, dd.shape[1], row_block):
                            sel = np.s_[i, r0:r0 + row_block, ...]
                            d = dd[sel]
                            hole = np.isnan(d)
                            if not hole.any():
                                continue
                            d[hole] = sd[sel][hole]
                            dd[sel] = d
                    # merge completion bitmaps when both sides have them
                    dk = f"_done/{k}"
                    if dk in dest and dk in src:
                        dest[dk][...] = np.maximum(dest[dk][...],
                                                   src[dk][...])


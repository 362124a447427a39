"""TensorStore/Zarr Gram store: the chunked, lock-free storage backend.

A copy of ``cnn_gp_tpu/data/store_ts.py`` with ``tensorstore`` imported
only when a store is opened (without it, opening raises ``ImportError``),
and the same on-disk layout, so a store written by either package opens
in the other.  Unlike the JAX copy, ``.zattrs`` is written to a temporary
file and renamed into place, so a worker that loses a creation race never
reads it half written, and a loser that finds no attributes yet holds the
array's chunk grid to its own (``tests/test_torch_store_race.py``).
Same interface as ``GramStore`` (``data/store.py``), but a Zarr store is
a directory of independent chunk objects, so:

* concurrent writers on a shared filesystem or object store need no file
  locking (each tile touches only its own chunks), which replaces the
  reference's one-file-per-worker + post-hoc NaN merge with direct
  concurrent assembly into ONE store;
* it works against object stores (gs://, s3://) through URL paths.

Zarr v2 arrays keep the reference's logical layout (names Kxx/Kxvx/...,
NaN fill, [bs, bs] chunks, tensorstore's default blosc compressor); the
leading singleton dim of the HDF5 layout is dropped.  ``.zattrs`` holds
the scheduler's ``batch_size``, and ``_done/<name>`` is a ``|u1``
completion bitmap with one chunk per bit.  ``open_store`` picks the
backend from the path (".h5" => HDF5).
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..utils import round_up_div as _cdiv
from .store import GramStore, _scan_missing_tiles

__all__ = ["TensorStoreGramStore", "open_store"]


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("tensorstore is required for the zarr "
                          "backend") from e
    return tensorstore


class TensorStoreGramStore:
    """Directory of Zarr arrays, one per Gram dataset, plus completion
    bitmaps under ``_done/``."""

    def __init__(self, path: str, mode: str = "a"):
        self._ts = _tensorstore()
        self.path = path.rstrip("/")
        self.mode = mode
        self._open = {}
        self._attrs_cache = {}
        if mode == "w":
            # match the h5 backend: 'w' truncates (a stale _done bitmap
            # would otherwise silently skip ALL work on the new run and
            # serve the previous run's kernel values as this run's result)
            if "://" in self.path:
                kv = self._ts.KvStore.open(f"{self.path}/").result()
                fut = kv.delete_range(self._ts.KvStore.KeyRange())
                if fut is not None:      # await the deletion commit
                    fut.result()
            else:
                import shutil
                shutil.rmtree(self.path, ignore_errors=True)

    def _check_writable(self):
        if self.mode == "r":
            raise PermissionError(
                f"store {self.path} was opened read-only (mode='r')")

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        self._open.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _spec(self, name: str, create: bool = False, shape=None,
              chunks=None, dtype="<f4", fill=float("nan"),
              open_existing: bool = True):
        if "://" in self.path:
            # object-store / URL form (gs://bucket/..., s3://..., memory://)
            kvstore = f"{self.path}/{name}/"
        else:
            kvstore = {"driver": "file", "path": f"{self.path}/{name}"}
        spec = {
            "driver": "zarr",
            "kvstore": kvstore,
        }
        if create:
            spec["metadata"] = {"shape": list(shape),
                                "chunks": list(chunks),
                                "dtype": dtype,
                                "fill_value": fill}
            spec["create"] = True
            # open=False gives create-only semantics (ALREADY_EXISTS on a
            # pre-existing array), so _open_or_create can tell winning the
            # creation race from opening someone else's array
            spec["open"] = open_existing
        return spec

    def _get(self, name: str):
        if name not in self._open:
            self._open[name] = self._ts.open(self._spec(name)).result()
        return self._open[name]

    # -- datasets ----------------------------------------------------------
    def create(self, name: str, n: int, n2: Optional[int], batch_size: int,
               diag: bool = False):
        self._check_writable()
        if diag:
            shape, chunks = (n,), (min(batch_size, n),)
            done_shape = (_cdiv(n, batch_size),)
            done_chunks = (1,)
        else:
            n2 = n if n2 is None else n2
            shape = (n, n2)
            chunks = (min(batch_size, n), min(batch_size, n2))
            done_shape = (_cdiv(n, batch_size), _cdiv(n2, batch_size))
            done_chunks = (1, 1)
        # one chunk PER done-bit: concurrent workers then never
        # read-modify-write a shared object (the lock-free design claim)
        arr, created = self._open_or_create(name, shape, chunks, "<f4",
                                            float("nan"))
        self._open[name] = arr
        if created:
            self._write_attrs(name, {"batch_size": batch_size})
        else:
            # pre-existing array (resume, or a concurrent creator won the
            # race): NEVER overwrite its attrs — a batch-size mismatch
            # means the shared done bitmap is indexed in different units
            # and tile-level resume would silently corrupt.  Checked
            # before the bitmap open so the clear error wins.  Without
            # attrs (another tool's store, or a concurrent creator that
            # has made the array and not yet written them) the chunk grid
            # this call would create must be the array's.
            attrs = self._read_attrs(name)
            if "batch_size" in attrs:
                existing_bs = int(attrs["batch_size"])
                same = existing_bs == batch_size
            else:
                grid = tuple(arr.chunk_layout.read_chunk.shape)
                existing_bs, same = grid[-1], grid == chunks
            if not same:
                raise ValueError(
                    f"{self.path}/{name} was created with batch_size="
                    f"{existing_bs}; resuming with batch_size={batch_size} "
                    f"would corrupt tile-level resume")
        done, _ = self._open_or_create(f"_done/{name}", done_shape,
                                       done_chunks, "|u1", 0)
        self._open[f"_done/{name}"] = done
        return arr

    def _attrs_path(self, name: str) -> str:
        # standard zarr attributes file alongside the array metadata
        return f"{self.path}/{name}/.zattrs"

    def _attrs_kvstore(self, name: str):
        # URL-form stores (gs://, s3://, memory://) must go through the
        # tensorstore kvstore -- plain open() would create a literal local
        # directory named e.g. "memory:/".
        return self._ts.KvStore.open(f"{self.path}/{name}/").result()

    def _write_attrs(self, name: str, attrs: dict):
        import json
        payload = json.dumps(attrs)
        if "://" in self.path:
            # .result() the future: an unawaited write can fail silently
            # or land after the process exits, leaving consumers on the
            # clamped-chunk batch_size fallback (wrong bitmap units)
            self._attrs_kvstore(name).write(".zattrs",
                                            payload.encode()).result()
        else:
            # written whole or not at all: a concurrent worker that lost
            # the creation race reads them at once, and must never see a
            # file opened but not yet written
            import os
            import tempfile
            path = self._attrs_path(name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                       prefix=".zattrs.")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                os.replace(tmp, path)
            except BaseException:
                os.unlink(tmp)
                raise
        self._attrs_cache[name] = attrs

    def _read_attrs(self, name: str) -> dict:
        import json
        if name in self._attrs_cache:
            return self._attrs_cache[name]
        try:
            if "://" in self.path:
                raw = self._attrs_kvstore(name).read(".zattrs").result()
                if raw.state != "value":
                    raise OSError(f"no .zattrs in {self.path}/{name}")
                attrs = json.loads(bytes(raw.value).decode())
            else:
                with open(self._attrs_path(name)) as f:
                    attrs = json.load(f)
        except OSError:
            # not cached: a concurrent creator writes them after the array
            return {}
        self._attrs_cache[name] = attrs
        return attrs

    def _open_or_create(self, name, shape, chunks, dtype, fill):
        """Race-tolerant open-or-create: concurrent workers may both try
        to create the same array; the loser opens the winner's -- but only
        if it matches the requested geometry (a mismatch means the store
        holds a *different* dataset and must not be silently reused).
        Returns ``(array, created)`` so callers can distinguish winning
        the creation from opening someone else's array."""
        try:
            arr = self._ts.open(self._spec(
                name, create=True, shape=shape, chunks=chunks, dtype=dtype,
                fill=fill, open_existing=False)).result()
            return arr, True
        except Exception as create_err:
            try:
                arr = self._ts.open(self._spec(name)).result()
            except Exception:
                raise create_err
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"{self.path}/{name} exists with shape "
                    f"{tuple(arr.shape)}, expected {tuple(shape)}"
                ) from create_err
            return arr, False

    def has(self, name: str) -> bool:
        try:
            self._get(name)
            return True
        except Exception:
            return False

    def batch_size(self, name: str) -> int:
        """The scheduler tile size; the chunk grid is a clamped fallback
        for stores written by other tools."""
        attrs = self._read_attrs(name)
        if "batch_size" in attrs:
            return int(attrs["batch_size"])
        return int(self._get(name).chunk_layout.read_chunk.shape[-1])

    def _done_arr(self, name: str):
        """The completion bitmap, lazily created for stores whose array
        exists without one (foreign zarr tooling, or a crash between the
        array create and the bitmap create) — mirrors ``GramStore._done``.
        Returns None for a read-only store lacking the bitmap (nothing is
        done as far as it knows; the NaN scan is the real check)."""
        key = f"_done/{name}"
        if key in self._open:
            return self._open[key]
        try:
            done = self._get(key)
        except Exception:
            if self.mode == "r":
                return None
            arr = self._get(name)
            bs = self.batch_size(name)
            done_shape = tuple(_cdiv(s, bs) for s in arr.shape)
            done, _ = self._open_or_create(key, done_shape,
                                           (1,) * len(done_shape),
                                           "|u1", 0)
            self._open[key] = done
        return done

    # -- tile IO -----------------------------------------------------------
    def write_tile(self, name: str, i: int, j: Optional[int],
                   block: np.ndarray):
        self._check_writable()
        arr = self._get(name)
        bs = self.batch_size(name)
        done = self._done_arr(name)
        if j is None:
            arr[i:i + len(block)] = np.asarray(block, np.float32)
            done[i // bs] = np.uint8(1)
        else:
            arr[i:i + block.shape[0], j:j + block.shape[1]] = \
                np.asarray(block, np.float32)
            done[i // bs, j // bs] = np.uint8(1)

    def tile_done(self, name: str, i: int, j: Optional[int]) -> bool:
        bs = self.batch_size(name)
        done = self._done_arr(name)
        if done is None:
            return False
        if j is None:
            return bool(done[i // bs].read().result())
        return bool(done[i // bs, j // bs].read().result())

    def done_mask(self, name: str) -> np.ndarray:
        """Whole completion bitmap in one read (resume filtering over T
        tiles must not issue T point reads)."""
        done = self._done_arr(name)
        if done is None:
            arr = self._get(name)
            bs = self.batch_size(name)
            return np.zeros(tuple(_cdiv(s, bs) for s in arr.shape),
                            np.uint8)
        return np.asarray(done.read().result())

    # -- reading -----------------------------------------------------------
    def read(self, name: str, dtype=np.float32) -> np.ndarray:
        return np.asarray(self._get(name).read().result(), dtype)

    def shape(self, name: str) -> tuple:
        return tuple(self._get(name).shape)

    def read_rows(self, name: str, r0: int, r1: int,
                  out=None) -> np.ndarray:
        """Row-block read [r0:r1) (float32) — same contract as
        `GramStore.read_rows`, so the streamed classify path works
        against either backend."""
        arr = self._get(name)[r0:r1].read().result()
        if out is None:
            return np.asarray(arr, np.float32)
        out[...] = arr
        return out

    def dataset_names(self) -> Iterable[str]:
        if "://" in self.path:
            # object-store form: list through the kvstore (there is no
            # local directory to os.listdir)
            kv = self._ts.KvStore.open(f"{self.path}/").result()
            names = {k.decode().split("/", 1)[0] for k in kv.list().result()}
            return sorted(n for n in names if n and n != "_done")
        import os
        return [d for d in os.listdir(self.path)
                if d != "_done" and
                os.path.isdir(os.path.join(self.path, d))]

    # -- integrity ---------------------------------------------------------
    def missing_tiles(self, name: str,
                      upper_triangle_only: bool = False) -> np.ndarray:
        arr = self._get(name)
        bs = self.batch_size(name)
        # tensorstore slices do not clamp to the domain like numpy, hence
        # the explicit hi in the shared scanner's callbacks
        return _scan_missing_tiles(
            tuple(arr.shape), bs,
            lambda i, hi: np.asarray(arr[i:hi].read().result()),
            lambda i, hi, j0: np.asarray(arr[i:hi, j0:].read().result()),
            upper_triangle_only)

    def assert_complete(self, name: str, upper_triangle_only: bool = False):
        miss = self.missing_tiles(name, upper_triangle_only)
        if len(miss):
            raise RuntimeError(
                f"{self.path}:{name} has {len(miss)} incomplete tiles, "
                f"first at element offset {tuple(miss[0])}; rerun assembly "
                f"to fill them (tile-level resume will skip finished ones)")


def open_store(path: str, mode: str = "a", backend: str = "auto"):
    """Open a Gram store; backend from extension unless given
    ("h5" | "zarr")."""
    if backend == "auto":
        backend = "h5" if path.endswith((".h5", ".hdf5")) else "zarr"
    if backend == "h5":
        return GramStore(path, mode)
    if backend == "zarr":
        return TensorStoreGramStore(path, mode)
    raise ValueError(f"unknown store backend {backend!r}")


"""Dataset loading with the reference's concat-then-split semantics.

A numpy copy of ``cnn_gp_tpu/data/datasets.py`` (importing that module
would import jax through ``cnn_gp_tpu/__init__.py``).  Raw-format readers
for MNIST (IDX) and CIFAR-10 (python pickle batches) produce
``[N, C, W, H]`` float32 arrays (uint8/255, channels-first); train and
test sets are concatenated into one pool and re-split by the config's
index ranges.  ``synthetic_arrays`` draws the same numpy stream as the
JAX package, so both packages see identical synthetic data.

There is no download path; files must already exist under
``datasets_path`` in the standard torchvision layout:

    {datasets_path}/MNIST/MNIST/raw/train-images-idx3-ubyte[.gz] ...
    {datasets_path}/CIFAR10/cifar-10-batches-py/data_batch_1 ...
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Tuple

import numpy as np

__all__ = ["ArrayDataset", "DatasetFromConfig", "load_mnist_arrays",
           "load_cifar10_arrays", "synthetic_arrays"]


class ArrayDataset:
    """A materialised dataset: images [N, C, W, H] float32, labels [N]."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert images.ndim == 4 and len(images) == len(labels)
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def subset(self, indices) -> "ArrayDataset":
        idx = np.asarray(list(indices), dtype=np.int64)
        # config split ranges are contiguous (reference: configs/*.py) —
        # return views then, like the reference's torch Subset, instead
        # of fancy-indexed copies that would roughly double dataset RAM
        # (pool + 3 split copies)
        if len(idx) and np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            return ArrayDataset(self.images[sl], self.labels[sl])
        return ArrayDataset(self.images[idx], self.labels[idx])


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(f"{path}[.gz] not found")


def _read_idx(path: str) -> np.ndarray:
    """Read an IDX file (the raw MNIST format)."""
    with _open_maybe_gz(path) as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        assert zero == 0, f"bad IDX magic in {path}"
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                 0x0C: np.int32, 0x0D: np.float32,
                 0x0E: np.float64}[dtype_code]
        data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
    return data.reshape(dims)


def _find_dir(root: str, *candidates: str) -> str:
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.isdir(p):
            return p
    raise FileNotFoundError(
        f"none of {candidates} found under {root}; place raw dataset files "
        f"there (no download path exists in this environment)")


def _validate_split(name: str, x: np.ndarray, y: np.ndarray,
                    img_shape: Tuple[int, ...], n_classes: int = 10) -> None:
    """Fail loudly on malformed dataset files (truncated download, wrong
    format) instead of producing garbage Grams downstream."""
    if x.shape[1:] != img_shape:
        raise ValueError(f"{name}: images have shape {x.shape[1:]}, "
                         f"expected {img_shape}")
    if len(x) != len(y):
        raise ValueError(f"{name}: {len(x)} images but {len(y)} labels — "
                         f"files are inconsistent/truncated")
    if len(y) and not (0 <= y.min() and y.max() < n_classes):
        raise ValueError(f"{name}: labels outside [0, {n_classes}) — "
                         f"corrupt label file (range {y.min()}..{y.max()})")


def load_mnist_arrays(root: str) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]:
    """(train_x, train_y, test_x, test_y); x: [N, 1, 28, 28] float32/255."""
    raw = _find_dir(root, os.path.join("MNIST", "raw"),
                    os.path.join("MNIST", "MNIST", "raw"), "raw", "")
    def imgs(name):
        a = _read_idx(os.path.join(raw, name))
        return (a.astype(np.float32) / 255.0)[:, None, :, :]
    def labels(name):
        return _read_idx(os.path.join(raw, name)).astype(np.int64)
    tr_x, tr_y = imgs("train-images-idx3-ubyte"), \
        labels("train-labels-idx1-ubyte")
    te_x, te_y = imgs("t10k-images-idx3-ubyte"), \
        labels("t10k-labels-idx1-ubyte")
    _validate_split("MNIST train", tr_x, tr_y, (1, 28, 28))
    _validate_split("MNIST test", te_x, te_y, (1, 28, 28))
    return tr_x, tr_y, te_x, te_y


def load_cifar10_arrays(root: str):
    """(train_x, train_y, test_x, test_y); x: [N, 3, 32, 32] float32/255."""
    d = _find_dir(root, "cifar-10-batches-py",
                  os.path.join("CIFAR10", "cifar-10-batches-py"))

    def batch(name):
        with open(os.path.join(d, name), "rb") as f:
            entry = pickle.load(f, encoding="latin1")
        x = entry["data"].reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        y = np.asarray(entry["labels"], dtype=np.int64)
        return x, y

    xs, ys = zip(*(batch(f"data_batch_{i}") for i in range(1, 6)))
    tx, ty = batch("test_batch")
    tr_x, tr_y = np.concatenate(xs), np.concatenate(ys)
    _validate_split("CIFAR10 train", tr_x, tr_y, (3, 32, 32))
    _validate_split("CIFAR10 test", tx, ty, (3, 32, 32))
    return tr_x, tr_y, tx, ty


def synthetic_arrays(n_train: int = 640, n_test: int = 128,
                     n_classes: int = 10, shape=(1, 28, 28), seed: int = 0):
    """Deterministic 'prototype + noise' classification problem."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, *shape).astype(np.float32)

    def make(n, salt):
        r = np.random.RandomState(seed + salt)
        y = np.arange(n, dtype=np.int64) % n_classes
        x = protos[y] + 0.7 * r.randn(n, *shape).astype(np.float32)
        perm = r.permutation(n)
        return x[perm].astype(np.float32), y[perm]

    train_x, train_y = make(n_train, 1)
    test_x, test_y = make(n_test, 2)
    return train_x, train_y, test_x, test_y


def _load_pool(datasets_path: str, config) -> ArrayDataset:
    name = config.dataset_name
    if name == "MNIST":
        tr_x, tr_y, te_x, te_y = load_mnist_arrays(
            os.path.join(datasets_path, "MNIST"))
    elif name == "CIFAR10":
        tr_x, tr_y, te_x, te_y = load_cifar10_arrays(
            os.path.join(datasets_path, "CIFAR10"))
    elif name == "synthetic":
        n_needed = max(max(config.train_range, default=0),
                       max(config.validation_range, default=0),
                       max(config.test_range, default=0)) + 1
        shape = (config.in_channels, 28, 28)
        tr_x, tr_y, te_x, te_y = synthetic_arrays(
            n_train=n_needed, n_test=0, shape=shape)
        te_x = te_x.reshape((0,) + shape)
    else:
        raise ValueError(f"unknown dataset_name {name!r}")
    # Concatenate train+test into one pool, then re-split by ranges
    # (reference: cnn_gp/data.py:147-158).
    x = np.concatenate([tr_x, te_x])
    y = np.concatenate([tr_y, te_y])
    # The reference composes transforms per image (reference:
    # cnn_gp/data.py:143-145), and that is the default here too: a
    # batch-shape-preserving guess is NOT evidence of batch-awareness
    # (e.g. ``lambda img: img[::-1]`` flips channels per image but
    # silently reverses the image ORDER when handed the pool).  A
    # callable that genuinely vectorises over the leading batch dim can
    # opt in with ``t.vectorized = True`` and will get the whole pool.
    for t in getattr(config, "transforms", []):
        if getattr(t, "vectorized", False):
            xt = np.asarray(t(x))
            if xt.shape[:1] != x.shape[:1]:
                raise ValueError(
                    f"vectorized transform {t!r} changed the batch dim "
                    f"{x.shape[:1]} -> {xt.shape[:1]}")
        else:
            xt = np.stack([np.asarray(t(img)) for img in x])
        x = xt.astype(np.float32, copy=False)
    return ArrayDataset(x, y)


class DatasetFromConfig:
    """Train/validation/test splits built from a config module
    (reference: cnn_gp/data.py:129-162)."""

    def __init__(self, datasets_path: str, config):
        self.config = config
        pool = _load_pool(datasets_path, config)
        self.data_full = pool
        self.train = pool.subset(config.train_range)
        self.validation = pool.subset(config.validation_range)
        self.test = pool.subset(config.test_range)

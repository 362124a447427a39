"""The hard, non-separable MNIST-like task of the fit scripts.

A copy of ``scripts/make_fake_dataset.py::_digits`` and of
``scripts/fit_paper_scale.py::hard_mnist``, in numpy with the same draws,
so the same seeds give the same bytes in either package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["digits", "hard_mnist"]


def digits(n, side, seed, proto_seed=None, hard=False, flip_frac=0.05):
    """Digit-like uint8 images: class prototype blobs plus noise, and
    int64 labels.

    The prototypes come from ``proto_seed`` (default ``seed``), so a train
    and a test split that share it are one task.  ``hard`` blends every
    image with a confuser class's prototype under heavier noise and flips
    a ``flip_frac`` fraction of the labels (the draws are the same for any
    ``flip_frac``, so 0 gives the same images without label noise)."""
    proto_rng = np.random.RandomState(
        seed if proto_seed is None else proto_seed)
    protos = (proto_rng.rand(10, side, side) ** 2 * 255).astype(np.float32)
    rng = np.random.RandomState(seed)
    rng.rand(10, side, side)  # the original's stream skips these draws
    y = rng.randint(0, 10, n)
    x = protos[y] * (0.6 + 0.4 * rng.rand(n, 1, 1))
    if hard:
        other = (y + rng.randint(1, 10, n)) % 10   # confuser class
        blend = rng.uniform(0.15, 0.5, (n, 1, 1)).astype(np.float32)
        x = x * (1 - blend) + protos[other] * blend * (
            0.6 + 0.4 * rng.rand(n, 1, 1))
        x += 45 * rng.randn(n, side, side)
        flip = rng.rand(n) < flip_frac
        y = np.where(flip, rng.randint(0, 10, n), y)
    else:
        x += 30 * rng.randn(n, side, side)
    return np.clip(x, 0, 255).astype(np.uint8), y.astype(np.int64)


def hard_mnist(n_train, n_test, flip_frac=0.05):
    """Train (seed 1) and held-out (seed 2, seed 1's prototypes) splits of
    the hard 28x28 task as float32 NCHW in [0, 1], the loaders' pixel
    scaling: ``(train_x, train_y, test_x, test_y)``."""
    tr_x, tr_y = digits(n_train, 28, seed=1, hard=True, flip_frac=flip_frac)
    te_x, te_y = digits(n_test, 28, seed=2, proto_seed=1, hard=True,
                        flip_frac=flip_frac)

    def as_f32(a):
        return a[:, None].astype(np.float32) / 255.0
    return as_f32(tr_x), tr_y, as_f32(te_x), te_y

"""Write synthetic datasets in the real on-disk formats.

A copy of ``scripts/make_fake_dataset.py``: for the same arguments it
writes the same bytes.  With no network there are no real MNIST or
CIFAR-10 files, so this writes synthetic data in the formats the loaders
read (MNIST IDX, CIFAR-10 pickle batches), and the real-format pipeline
(IDX parsing, concat-then-split, the paper configs, Gram assembly, solve)
can be driven end to end at any scale.

    python -m cnn_gp_tpu_torch.scripts.make_fake_dataset mnist <datasets_path> [n_train n_test]
    python -m cnn_gp_tpu_torch.scripts.make_fake_dataset cifar10 <datasets_path> [n_train n_test]

``--hard`` (both kinds) makes the task non-separable (blended prototypes,
heavy noise, 5% label flips), so accuracies are well below 100%.  The
images come from ``data.hard_mnist.digits`` (the original's ``_digits``,
with its ``flip_frac``).
"""

from __future__ import annotations

import argparse
import os
import pickle
import struct

import numpy as np

from ..data.hard_mnist import digits as _digits


def _idx_images(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 3))
        f.write(struct.pack(">III", *arr.shape))
        f.write(arr.tobytes())


def _idx_labels(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, 1))
        f.write(struct.pack(">I", len(arr)))
        f.write(arr.astype(np.uint8).tobytes())


def make_mnist(root, n_train=60000, n_test=10000, hard=False):
    raw = os.path.join(root, "MNIST", "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    tr_x, tr_y = _digits(n_train, 28, seed=1, hard=hard)
    te_x, te_y = _digits(n_test, 28, seed=2, proto_seed=1, hard=hard)
    _idx_images(os.path.join(raw, "train-images-idx3-ubyte"), tr_x)
    _idx_labels(os.path.join(raw, "train-labels-idx1-ubyte"), tr_y)
    _idx_images(os.path.join(raw, "t10k-images-idx3-ubyte"), te_x)
    _idx_labels(os.path.join(raw, "t10k-labels-idx1-ubyte"), te_y)
    print(f"wrote fake MNIST ({n_train}+{n_test}"
          f"{', hard' if hard else ''}) under {raw}")


def make_cifar10(root, n_train=50000, n_test=10000, hard=False):
    d = os.path.join(root, "CIFAR10", "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    per = [n_train // 5] * 5                 # the loader wants 5 batches
    per[0] += n_train - sum(per)
    # one prototype set shared by every batch, so train and test are one
    # task
    for i in range(1, 6):
        x, y = _digits(per[i - 1], 32, seed=10 + i, proto_seed=10,
                       hard=hard)
        # an explicit width: reshape(len(x), -1) cannot infer -1 for an
        # empty batch (n_train < 5 leaves later batches with no rows)
        data = np.repeat(x[:, None], 3, axis=1).reshape(len(x), 3 * 32 * 32)
        with open(os.path.join(d, f"data_batch_{i}"), "wb") as f:
            pickle.dump({"data": data, "labels": y.tolist()}, f)
    x, y = _digits(n_test, 32, seed=99, proto_seed=10, hard=hard)
    data = np.repeat(x[:, None], 3, axis=1).reshape(len(x), 3 * 32 * 32)
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump({"data": data, "labels": y.tolist()}, f)
    print(f"wrote fake CIFAR-10 ({n_train}+{n_test}"
          f"{', hard' if hard else ''}) under {d}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", choices=("mnist", "cifar10"))
    p.add_argument("root")
    p.add_argument("n_train", nargs="?", type=int)
    p.add_argument("n_test", nargs="?", type=int)
    p.add_argument("--hard", action="store_true")
    a = p.parse_args(argv)
    make = make_mnist if a.kind == "mnist" else make_cifar10
    kw = {k: v for k, v in (("n_train", a.n_train), ("n_test", a.n_test))
          if v is not None}
    make(a.root, hard=a.hard, **kw)


if __name__ == "__main__":
    main()

"""Given a pre-computed kernel and a data set, compute accuracy.

PyTorch counterpart of ``exp_mnist_resnet/classify_gp.py``, with the same
flag names plus ``--device``: loads the (upper-triangle) train Gram, adds
``--jitter`` to the diagonal, solves Kxx^-1 Y with +-1 one-hot targets and
reports validation/test accuracy.  ``--solver=scipy`` is the float64 host
oracle; ``--solver=chol`` is a float64 Cholesky on ``--device``.
``--variances/--evidence/--lpd`` are not ported yet (ROADMAP.md).

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp \\
        --config=mnist_paper_convnet_gp --in_path=k.h5 --solver=chol
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.data import DatasetFromConfig, GramStore
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.utils import resolve_device


def _checked(name, arr):
    """Refuse a Gram with NaN or Inf entries (an incomplete or unmerged
    assembly) instead of turning it into a garbage accuracy."""
    if not np.isfinite(np.asarray(arr)).all():
        raise RuntimeError(
            f"{name} has non-finite entries (incomplete or unmerged "
            f"assembly?); rerun assembly — tile-level resume will skip "
            f"finished tiles")
    return arr


def run(config, in_path: str, *, datasets_path: str, device=None,
        jitter: float = 0.0, solver: str = "scipy") -> dict:
    """Solve on the stored Kxx and score both splits.  Returns
    ``{"validation": (accuracy, predictions), "test": (...)}``."""
    t = [time.perf_counter()]

    def tick(name):
        now = time.perf_counter()
        print(f"[classify_gp] {name}: {now - t[0]:.1f}s", flush=True)
        t[0] = now

    dataset = DatasetFromConfig(datasets_path, config)
    y_1hot = solve.one_hot_targets(dataset.train.labels)
    with GramStore(in_path, "r") as f:
        kxx = _checked("Kxx", solve.symmetrize_from_upper(
            f.read("Kxx", dtype=np.float64)))
        kxvx = _checked("Kxvx", f.read("Kxvx"))
        kxtx = _checked("Kxtx", f.read("Kxtx"))
    tick("read")
    a = solve.solve_gp(kxx, y_1hot, jitter=jitter, method=solver,
                       device=device)
    del kxx
    tick("solve")
    results = {}
    for split, kzx, labels in (("validation", kxvx, dataset.validation),
                               ("test", kxtx, dataset.test)):
        pred = solve.predict(kzx, a)
        acc = solve.accuracy(pred, labels.labels)
        print(f"{split} accuracy: {acc * 100}%")
        results[split] = (acc, pred)
    tick("predict")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--config", default="mnist",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--in_path", default=None,
                   help="path of h5 file to load kernels from")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="add to the diagonal")
    p.add_argument("--store_backend", default="auto", choices=["auto", "h5"],
                   help="HDF5 only; the TensorStore backend is not ported")
    p.add_argument("--solver", default="scipy", choices=["scipy", "chol"],
                   help="scipy (float64 LAPACK on the host) | chol "
                        "(float64 Cholesky on --device)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --solver=chol")
    a = p.parse_args(argv)
    if a.in_path is None:
        p.error("--in_path is required")
    run(configs.load(a.config), a.in_path, datasets_path=a.datasets_path,
        device=resolve_device(a.device), jitter=a.jitter, solver=a.solver)


if __name__ == "__main__":
    main()

"""GP classification solvers: Kxx^-1 Y and accuracy reporting.

PyTorch counterpart of ``cnn_gp_tpu/ops/solve.py``: targets are +-1
one-hot, the train Gram gets ``jitter`` added to its diagonal,
``A = Kxx^-1 Y`` is solved once, and predictions are ``argmax(Kzx @ A)``.
``symmetrize_from_upper`` mirrors the stored upper triangle first.

Methods:

* ``scipy`` -- float64 LAPACK ``posv`` on the host: the oracle.
* ``chol``  -- float64 ``torch.linalg.cholesky`` + ``cholesky_solve`` on
  the given device (the card has native FP64).

``chol_ir``, ``chol_dist`` and the posterior variance / evidence / LPD
functions are not ported yet (``ROADMAP.md``, Queue 1) and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["one_hot_targets", "diag_add", "symmetrize_from_upper",
           "solve_gp", "predict", "accuracy", "predictive_variance",
           "log_marginal_likelihood", "gaussian_lpd",
           "log_predictive_density", "solve_gp_stats"]


def one_hot_targets(labels: np.ndarray, n_classes: Optional[int] = None,
                    dtype=np.float64) -> np.ndarray:
    """+-1 one-hot targets."""
    labels = np.asarray(labels)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    y = -np.ones((len(labels), n_classes), dtype=dtype)
    y[np.arange(len(labels)), labels] = 1.0
    return y


def diag_add(k: np.ndarray, jitter: float) -> None:
    """In-place diagonal jitter."""
    k.flat[:: k.shape[-1] + 1] += jitter


def symmetrize_from_upper(k: np.ndarray, block: int = 4096) -> np.ndarray:
    """Mirror the upper triangle into the lower (in place, NaN-aware),
    blockwise so no O(N^2) index arrays are built."""
    n = k.shape[0]
    iu_full = np.triu_indices(min(block, n), 1)
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        iu = (iu_full if i1 - i0 == min(block, n)
              else np.triu_indices(i1 - i0, 1))
        diag_blk = k[i0:i1, i0:i1]
        diag_blk[iu[1], iu[0]] = diag_blk[iu]
        for j0 in range(i1, n, block):
            j1 = min(j0 + block, n)
            k[j0:j1, i0:i1] = k[i0:i1, j0:j1].T
    return k


def _solve_scipy(kxx: np.ndarray, y: np.ndarray) -> np.ndarray:
    import scipy.linalg
    assert kxx.dtype == np.float64 and y.dtype == np.float64, (
        "Kxx and Y must be float64 for the inversion, even if they were "
        "float32 when computed; this makes the solve far less likely to "
        "fail as singular")
    return scipy.linalg.solve(kxx, y, overwrite_a=True, overwrite_b=False,
                              check_finite=False, assume_a="pos",
                              lower=False)


def _solve_chol(kxx: np.ndarray, y: np.ndarray, device) -> np.ndarray:
    k = torch.as_tensor(np.asarray(kxx, np.float64), device=device)
    rhs = torch.as_tensor(np.asarray(y, np.float64), device=device)
    chol, info = torch.linalg.cholesky_ex(k)
    a = torch.cholesky_solve(rhs, chol).cpu().numpy()
    if int(info) != 0 or not np.all(np.isfinite(a)):
        raise np.linalg.LinAlgError(
            "Cholesky solve produced non-finite solutions (matrix "
            "not positive-definite?); add jitter or use method='scipy'")
    return a


def solve_gp(kxx: np.ndarray, y: np.ndarray, jitter: float = 0.0,
             method: str = "auto", device=None) -> np.ndarray:
    """Solve (Kxx + jitter*I) A = Y.  Consumes ``kxx`` (jitter in place).

    ``method="chol"`` runs on ``device``, which must be given."""
    if jitter != 0.0:
        diag_add(kxx, jitter)
    if method == "auto":
        method = "scipy"
    if method == "scipy":
        return _solve_scipy(np.asarray(kxx, np.float64),
                            np.asarray(y, np.float64))
    if method == "chol":
        if device is None:
            raise ValueError("method='chol' needs an explicit device")
        return _solve_chol(kxx, y, device)
    if method in ("chol_ir", "chol_dist"):
        raise NotImplementedError(
            f"solve method {method!r} is not ported yet (ROADMAP.md, "
            f"Queue 1); use 'scipy' or 'chol'")
    raise ValueError(f"unknown solve method {method!r}")


def predict(kzx: np.ndarray, a: np.ndarray) -> np.ndarray:
    """argmax(Kzx @ A) class predictions."""
    return np.argmax(np.asarray(kzx, a.dtype) @ a, axis=1)


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.asarray(pred) == np.asarray(labels)))


def _not_ported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md, Queue 1: slice 3); the "
            f"JAX package's cnn_gp_tpu.ops.solve.{name} computes it")
    fn.__name__ = name
    return fn


predictive_variance = _not_ported("predictive_variance")
log_marginal_likelihood = _not_ported("log_marginal_likelihood")
gaussian_lpd = _not_ported("gaussian_lpd")
log_predictive_density = _not_ported("log_predictive_density")
solve_gp_stats = _not_ported("solve_gp_stats")

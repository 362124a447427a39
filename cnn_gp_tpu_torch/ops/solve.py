"""GP classification solvers: Kxx^-1 Y and accuracy reporting.

PyTorch counterpart of ``cnn_gp_tpu/ops/solve.py``: targets are +-1
one-hot, the train Gram gets ``jitter`` added to its diagonal,
``A = Kxx^-1 Y`` is solved once, and predictions are ``argmax(Kzx @ A)``.
``symmetrize_from_upper`` mirrors the stored upper triangle first.

Methods:

* ``scipy`` -- float64 LAPACK ``posv`` on the host: the oracle.
* ``chol``  -- float64 ``torch.linalg.cholesky`` + ``cholesky_solve`` on
  the given device (the card has native FP64).
* ``chol_ir`` -- a float32 Cholesky of the whole matrix on the given device
  plus ``refine_iters`` rounds of iterative refinement with float64
  residuals on the host (``refine_with_factor``).
* ``chol_dist`` -- the Jacobi-equilibrated blocked float32 factor of
  ``parallel/chol_dist.py`` on the given device, refined in float64 to
  its tolerance.

The posterior statistics
(``predictive_variance``, ``gaussian_lpd``, ``log_predictive_density``,
``log_marginal_likelihood``, ``solve_gp_stats``) are the JAX package's
float64 host oracles, the same numpy/scipy code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import settings

__all__ = ["one_hot_targets", "diag_add", "symmetrize_from_upper",
           "solve_gp", "predict", "accuracy", "refine_with_factor",
           "predictive_variance",
           "log_marginal_likelihood", "gaussian_lpd",
           "log_predictive_density", "solve_gp_stats", "classify"]


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


def refine_with_factor(chol: torch.Tensor, kxx64: np.ndarray, y: np.ndarray,
                       iters: int = 3) -> np.ndarray:
    """Iteratively refine against a float32 Cholesky factor ``chol`` (a
    lower-triangular tensor on its device): float64 residuals on the host,
    correction solves through the factor."""
    settings.check_precision_on(chol.device)

    def cho_solve32(rhs):
        b = torch.as_tensor(np.asarray(rhs, np.float32), device=chol.device)
        return torch.cholesky_solve(b, chol).cpu().numpy().astype(np.float64)

    y64 = np.asarray(y, np.float64)
    a = cho_solve32(y)
    if not np.all(np.isfinite(a)):
        raise np.linalg.LinAlgError(
            "float32 Cholesky of the Gram produced non-finite solutions "
            "(matrix not positive-definite at float32?); add jitter or "
            "use method='scipy'")
    for _ in range(iters):
        r = y64 - kxx64 @ a                     # float64 residual on host
        a = a + cho_solve32(r)
    return a


def _solve_chol_ir(kxx: np.ndarray, y: np.ndarray, device,
                   iters: int = 3) -> np.ndarray:
    """float32 factorisation on ``device`` + float64 host refinement."""
    chol, info = torch.linalg.cholesky_ex(torch.as_tensor(
        np.asarray(kxx, np.float32), device=device))
    if int(info) != 0:         # a partial factor would solve to garbage
        chol.fill_(float("nan"))
    return refine_with_factor(chol, np.asarray(kxx, np.float64), y,
                              iters=iters)


def solve_gp(kxx: np.ndarray, y: np.ndarray, jitter: float = 0.0,
             method: str = "auto", refine_iters: int = 3,
             device=None) -> np.ndarray:
    """Solve (Kxx + jitter*I) A = Y.  Consumes ``kxx`` (jitter in place).

    ``chol``, ``chol_ir`` and ``chol_dist`` run on ``device``, which must be
    given.  ``refine_iters`` is the number of refinement rounds of
    ``chol_ir``."""
    if jitter != 0.0:
        diag_add(kxx, jitter)
    if method == "auto":
        method = "scipy"
    if method == "scipy":
        return _solve_scipy(np.asarray(kxx, np.float64),
                            np.asarray(y, np.float64))
    if method in ("chol", "chol_ir", "chol_dist") and device is None:
        raise ValueError(f"method={method!r} needs an explicit device")
    if method == "chol":
        return _solve_chol(kxx, y, device)
    if method == "chol_ir":
        return _solve_chol_ir(kxx, y, device, iters=refine_iters)
    if method == "chol_dist":
        from ..parallel.chol_dist import chol_solve_dist
        a, rel, _ = chol_solve_dist(kxx, y, device=device)  # jitter applied
        if rel > 1e-6:
            print(f"chol_dist: refinement stagnated at rel residual {rel:.2e}"
                  " — consider a larger --jitter")
        return a
    raise ValueError(f"unknown solve method {method!r}")


def predict(kzx: np.ndarray, a: np.ndarray) -> np.ndarray:
    """argmax(Kzx @ A) class predictions."""
    return np.argmax(np.asarray(kzx, a.dtype) @ a, axis=1)


def accuracy(pred: np.ndarray, labels: np.ndarray) -> float:
    return float(np.mean(np.asarray(pred) == np.asarray(labels)))


def predictive_variance(kxx: np.ndarray, kzx: np.ndarray,
                        kzz_diag: np.ndarray,
                        jitter: float = 0.0) -> np.ndarray:
    """GP posterior variance per test point:
    ``var_z = k_zz - k_zx (Kxx + jitter I)^-1 k_xz``, ``jitter`` ABSOLUTE.

    float64 host oracle via one Cholesky and a triangular solve; clipped
    at 0 (round-off can land epsilon-negative for nearly-interpolated
    points)."""
    import scipy.linalg
    kxx = np.array(kxx, np.float64)       # a private copy, factored in place
    if jitter:
        diag_add(kxx, jitter)
    c, low = scipy.linalg.cho_factor(kxx, lower=True, check_finite=False,
                                     overwrite_a=True)
    v = scipy.linalg.solve_triangular(c, np.asarray(kzx, np.float64).T,
                                      lower=low, check_finite=False)
    return np.maximum(np.asarray(kzz_diag, np.float64) - (v * v).sum(0),
                      0.0)


def gaussian_lpd(scores: np.ndarray, variances: np.ndarray,
                 labels: np.ndarray, noise: float,
                 n_classes: Optional[int] = None):
    """Held-out log predictive density of +-1 one-hot targets under the
    GP's Gaussian predictive: per test point
    ``sum_c log N(y_c | mu_c, var + noise)``, the posterior variance shared
    across classes and the observation noise equal to the jitter the solve
    added.  Returns ``(mean, se, per_point)``."""
    scores = np.asarray(scores, np.float64)
    var = np.asarray(variances, np.float64) + float(noise)
    if np.any(var <= 0):
        raise ValueError("non-positive predictive variance + noise")
    y = one_hot_targets(np.asarray(labels), n_classes=n_classes
                        if n_classes is not None else scores.shape[1])
    if y.shape != scores.shape:
        raise ValueError(f"labels imply {y.shape}, scores {scores.shape}")
    c = scores.shape[1]
    per_point = (-0.5 * np.sum((y - scores) ** 2, axis=1) / var
                 - 0.5 * c * (np.log(2.0 * np.pi) + np.log(var)))
    mean = float(per_point.mean())
    se = float(per_point.std(ddof=1) / np.sqrt(len(per_point))) \
        if len(per_point) > 1 else 0.0
    return mean, se, per_point


def log_predictive_density(kxx: np.ndarray, kzx: np.ndarray,
                           kzz_diag: np.ndarray, train_labels: np.ndarray,
                           test_labels: np.ndarray,
                           jitter_rel: float = 0.0,
                           n_classes: Optional[int] = None):
    """float64 host oracle for held-out LPD: one Cholesky of
    ``K + jitter_rel * mean(diag K) * I`` gives means, variances and the
    density.  Returns ``(mean, se, per_point)`` as :func:`gaussian_lpd`."""
    import scipy.linalg
    kxx = np.array(kxx, np.float64)
    jr = jitter_rel * float(np.mean(np.diagonal(kxx)))
    if jr:
        diag_add(kxx, jr)
    y = one_hot_targets(np.asarray(train_labels), n_classes=n_classes)
    c, low = scipy.linalg.cho_factor(kxx, lower=True, check_finite=False,
                                     overwrite_a=True)
    alpha = scipy.linalg.cho_solve((c, low), y, check_finite=False)
    scores = np.asarray(kzx, np.float64) @ alpha
    v = scipy.linalg.solve_triangular(c, np.asarray(kzx, np.float64).T,
                                      lower=low, check_finite=False)
    var = np.maximum(np.asarray(kzz_diag, np.float64) - (v * v).sum(0),
                     0.0)
    return gaussian_lpd(scores, var, test_labels, jr,
                        n_classes=y.shape[1])


def log_marginal_likelihood(kxx: np.ndarray, y: np.ndarray,
                            jitter_rel: float = 0.0) -> float:
    """float64 GP log evidence ``log p(y | X)`` summed over target dims:
    ``-1/2 tr(Y^T K'^-1 Y) - C/2 logdet K' - n C/2 log 2pi`` with
    ``K' = K + jitter_rel * mean(diag K) * I``.

    The jitter is RELATIVE here (hence the name), as in
    ``parallel.classify_device`` and ``classify_e2e --jitter``;
    ``solve_gp``, ``predictive_variance`` and ``solve_gp_stats`` take it
    ABSOLUTE.  On a ~1e12-diagonal NNGP Gram the same number means wildly
    different regularisation under the two conventions."""
    import scipy.linalg
    kxx = np.array(kxx, np.float64)
    y = np.asarray(y, np.float64)
    if jitter_rel:
        diag_add(kxx, jitter_rel * float(np.mean(np.diagonal(kxx))))
    c, low = scipy.linalg.cho_factor(kxx, lower=True, check_finite=False,
                                     overwrite_a=True)
    alpha = scipy.linalg.cho_solve((c, low), y, check_finite=False)
    logdet = 2.0 * float(np.sum(np.log(np.diagonal(c))))
    n, n_cls = y.shape
    return float(-0.5 * np.sum(y * alpha) - 0.5 * n_cls * logdet
                 - 0.5 * n * n_cls * np.log(2.0 * np.pi))


def solve_gp_stats(kxx: np.ndarray, y: np.ndarray, jitter: float = 0.0,
                   splits=()) -> dict:
    """ONE float64 Cholesky serving the solve, per-split posterior
    variances and the GP log evidence (``classify_gp --variances``).

    ``kxx`` is the full symmetrised matrix, CONSUMED (jitter added and
    factored in place); ``jitter`` is ABSOLUTE; ``splits`` is a sequence of
    ``(kzx [nz, n], kzz_diag [nz])`` pairs.  Returns
    ``{"alpha", "variances", "log_evidence"}``."""
    import scipy.linalg
    kxx = np.asarray(kxx, np.float64)
    if jitter:
        diag_add(kxx, jitter)
    c, low = scipy.linalg.cho_factor(kxx, lower=True, check_finite=False,
                                     overwrite_a=True)
    y64 = np.asarray(y, np.float64)
    alpha = scipy.linalg.cho_solve((c, low), y64, check_finite=False)
    logdet = 2.0 * float(np.sum(np.log(np.diagonal(c))))
    n, n_cls = y64.shape
    ev = float(-0.5 * np.sum(y64 * alpha) - 0.5 * n_cls * logdet
               - 0.5 * n * n_cls * np.log(2.0 * np.pi))
    variances = []
    for kzx, kzz in splits:
        v = scipy.linalg.solve_triangular(
            c, np.asarray(kzx, np.float64).T, lower=low,
            check_finite=False)
        variances.append(np.maximum(
            np.asarray(kzz, np.float64) - (v * v).sum(0), 0.0))
    return {"alpha": alpha, "variances": variances, "log_evidence": ev}


def classify(kxx: np.ndarray, train_labels: np.ndarray, jitter: float = 0.0,
             method: str = "auto", device=None,
             **splits: Tuple[np.ndarray, np.ndarray]) -> dict:
    """Full GP classification: solve on Kxx, report accuracy per split.

    ``splits`` maps name -> (Kzx, labels).  Kxx may be upper-triangle-only.
    ``device`` is passed to :func:`solve_gp` (needed by the card methods).
    """
    kxx = symmetrize_from_upper(np.asarray(kxx, np.float64))
    a = solve_gp(kxx, one_hot_targets(train_labels), jitter=jitter,
                 method=method, device=device)
    return {name: accuracy(predict(kzx, a), labels)
            for name, (kzx, labels) in splits.items()}

"""Cholesky factor of the equilibrated GP system, resident on one card.

The first piece of the port of ``cnn_gp_tpu/parallel/chol_dist.py``: the
lower factor L of ``M = D^-1/2 (K + jr I) D^-1/2`` (unit diagonal), held
as one float32 tensor, with the three operations the serving path needs.
The JAX package shards the factor over a mesh and factors it in bounded
block steps; on one card ``torch.linalg.cholesky`` (cuSOLVER) factors the
whole matrix in one call, so this object has no mesh, no blocked steps
and no ``extend`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["CardFactor"]


class CardFactor:
    """The lower Cholesky factor of an SPD matrix on one device."""

    def __init__(self, m: torch.Tensor):
        """Factor ``m`` ([n, n], only its lower triangle is read).  Raises
        ``LinAlgError`` where the matrix is not positive-definite at its
        precision (never a silent NaN factor)."""
        l, info = torch.linalg.cholesky_ex(m)
        if int(info) != 0:
            raise np.linalg.LinAlgError(
                f"Cholesky of the {tuple(m.shape)} {m.dtype} system failed "
                f"at minor {int(info)} (not positive-definite at this "
                f"precision); add jitter")
        self.l = l
        self.n = m.shape[0]

    def forward_sumsq(self, w: torch.Tensor) -> torch.Tensor:
        """``sum((L^-1 W) ** 2, axis=0)`` for ``W`` [n, m] on the factor's
        device: the squared whitened cross-covariance column norms that
        predictive variance subtracts."""
        v = torch.linalg.solve_triangular(self.l, w, upper=False)
        return (v * v).sum(0)

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """``(L L^T)^-1 rhs`` for host ``rhs`` [n, nrhs], in the factor's
        precision."""
        b = torch.as_tensor(np.asarray(rhs), dtype=self.l.dtype,
                            device=self.l.device)
        return torch.cholesky_solve(b, self.l).cpu().numpy()

    def log_diag_sum(self) -> float:
        """``sum(log(diag(L)))``, accumulated in float64 on the host (the
        log-determinant term of the GP evidence is twice this)."""
        d = self.l.diagonal().cpu().numpy().astype(np.float64)
        return float(np.sum(np.log(d)))

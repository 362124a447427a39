"""Distributed GP solve: preconditioned conjugate gradients over ranks.

PyTorch counterpart of ``cnn_gp_tpu/parallel/solve_dist.py``: matrix-free
block CG (the GPyTorch/BBMM recipe) with a Jacobi preconditioner, which
tames the huge diagonal scale of NNGP Grams (paper configs reach ~1e12).
All right-hand sides (the 10 one-hot columns) are solved together, with
a step size per column, so the math is exactly column-independent CG.

The Gram is row-sharded over the rank group (``parallel/mesh.py``): each
rank holds its rows of K on its device, and each iteration runs the local
product ``K_loc @ p`` and one ``all_gather`` to the full ``K p``.
Everything else is replicated, so every rank takes the same stopping
decision from the same numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import settings
from .mesh import Mesh, make_mesh, row_span

__all__ = ["cg_solve_sharded"]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _local_rows(kxx: np.ndarray, n_pad: int, r0: int, r1: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Rows [r0, r1) of kxx extended to [n_pad, n_pad] by the identity
    (the padding rows and columns), so rows shard evenly and the solution
    is unaffected."""
    n = kxx.shape[0]
    rows = torch.zeros((r1 - r0, n_pad), dtype=dtype)
    hi = min(r1, n)
    if hi > r0:
        rows[:hi - r0, :n] = torch.from_numpy(np.asarray(kxx[r0:hi]))
    for i in range(max(r0, n), r1):
        rows[i - r0, i] = 1.0
    return rows


@torch.no_grad()
def cg_solve_sharded(kxx: np.ndarray, y: np.ndarray, jitter: float = 0.0,
                     mesh: Optional[Mesh] = None, tol: float = 1e-6,
                     maxiter: int = 2000, dtype=None):
    """Solve (Kxx + jitter*I) A = Y with row-sharded CG on every rank.

    ``kxx`` must be the full (symmetrised) matrix; each rank uploads only
    its rows.  ``dtype`` None is float32, the JAX package's default;
    float64 is accepted.  The product runs in full float32 (TF32 is turned
    off): reduced-precision accumulation stalls CG on NNGP Grams.  Returns
    (A, rel_residual, iterations) on every rank."""
    if mesh is None:
        mesh = make_mesh()
    dtype = torch.float32 if dtype is None else _torch_dtype(dtype)
    settings.disable_tf32()
    dev = mesh.device
    n = kxx.shape[0]
    n_pad = n + (-n) % mesh.size
    r0, r1 = row_span(n_pad, mesh)
    k_loc = _local_rows(kxx, n_pad, r0, r1, dtype).to(dev)
    diag = np.ones(n_pad)
    diag[:n] = np.diagonal(kxx)
    y_pad = np.zeros((n_pad,) + np.shape(y)[1:])
    y_pad[:n] = y
    y_d = torch.as_tensor(y_pad, dtype=dtype, device=dev)
    jit = torch.as_tensor(jitter, dtype=dtype, device=dev)
    minv = (1.0 / (torch.as_tensor(diag, dtype=dtype, device=dev)
                   + jit))[:, None]

    def mv(v):
        local = k_loc @ v + jit * v[r0:r1]
        if mesh.group is None:
            return local
        parts = [torch.empty_like(local) for _ in range(mesh.size)]
        dist.all_gather(parts, local, group=mesh.group)
        return torch.cat(parts)

    x = torch.zeros_like(y_d)
    r = y_d
    z = minv * r
    p = z
    rz = torch.sum(r * z, dim=0)
    y_norm = torch.linalg.norm(y_d, dim=0)
    tol_d = torch.as_tensor(tol, dtype=dtype, device=dev)
    iters = 0
    while iters < maxiter and bool(
            torch.max(torch.linalg.norm(r, dim=0) / y_norm) > tol_d):
        kp = mv(p)
        alpha = rz / torch.sum(p * kp, dim=0)
        x = x + alpha * p
        r = r - alpha * kp
        z = minv * r
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        iters += 1
    rel = torch.max(torch.linalg.norm(r, dim=0) / y_norm)
    return x[:n].cpu().numpy(), float(rel), iters

"""Tile-regeneration sweeps and the equilibrated factor, for serving.

The subset of ``cnn_gp_tpu/parallel/device_large.py`` that
``serving.GPPredictor`` needs, on one card:

* ``make_scores_fn`` / ``scores_regen``: ``K(Z, X) @ a`` by regenerating
  Gram tiles and contracting each at once; only [len(Z), C] is resident.
* ``gram_matvec_regen``: ``K(X, X) @ a`` the same way (the raw, unscaled
  form).
* ``rebuild_factor``: the equilibrated system
  ``M = D^-1/2 (K + jr I) D^-1/2`` (unit diagonal, fixed by the Jacobi
  scalings) assembled tile by tile into one card tensor and factored
  there (``chol_dist.CardFactor``), with no solve.
* ``variances_from_factor``: posterior variances through that factor,
  the scaled cross-covariance built per bounded column block.

Every tile goes through ``parallel.gram._tile_body``, so the tiles of a
ConvNet-GP model run on the CUDA megakernel.  Nothing is padded (the JAX
package pads to a multiple of the tile size for XLA's static shapes):
ragged edge tiles are sliced, and the kernel takes any shape.  The large-N
classifier ``classify_device_large`` and its sampled-residual estimator
are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import settings
from ..ops import megakernel
from . import scheduler
from .chol_dist import CardFactor
from .gram import _on_device, _tile_body, compute_gram_diag

__all__ = ["gram_matvec_regen", "scores_regen", "make_scores_fn",
           "rebuild_factor", "variances_from_factor"]

_CROSS_BLOCK = 512    # query columns per whitened cross-covariance block


def _scaled_tile(model, spec, x_all, s, i0, j0, b):
    """One tile of M: K scaled by s_i * s_j, its diagonal pinned to exactly
    1 last (the +jitter in scaled space).  With no padding there is
    nothing outside [n) to zero."""
    blk = _tile_body(model, spec, x_all, x_all, i0, j0, b, True)
    bi, bj = blk.shape
    blk = blk * s[i0:i0 + bi, None] * s[None, j0:j0 + bj]
    if i0 == j0:
        blk.diagonal().fill_(1.0)
    return blk


def make_scores_fn(model, X, a: np.ndarray, *, batch_size: int = 128,
                   device):
    """Upload ``X`` and the weights ``a`` [len(X), nrhs] once and return
    ``scores(Z) -> [len(Z), nrhs]``, ``K(Z, X) @ a`` by tile regeneration
    (the repeated-serving form of :func:`scores_regen`)."""
    device = torch.device(device)
    x_all = _on_device(X, device)
    a_dev = torch.as_tensor(np.asarray(a, np.float32), device=device)
    spec = megakernel.match(model)
    b = batch_size

    @torch.no_grad()
    def scores(Z) -> np.ndarray:
        settings.check_precision_on(device)
        z_all = _on_device(Z, device)
        out = torch.zeros((len(z_all), a_dev.shape[1]), dtype=torch.float32,
                          device=device)
        for i0, j0 in scheduler.tile_offsets(len(z_all), len(x_all), b,
                                             False):
            blk = _tile_body(model, spec, z_all, x_all, i0, j0, b, False)
            out[i0:i0 + blk.shape[0]] += blk @ a_dev[j0:j0 + blk.shape[1]]
        return out.cpu().numpy()

    return scores


def scores_regen(model, Z, X, a: np.ndarray, *, batch_size: int = 128,
                 device) -> np.ndarray:
    """K(Z, X) @ a with tile regeneration.  One-shot form of
    :func:`make_scores_fn`."""
    return make_scores_fn(model, X, a, batch_size=batch_size,
                          device=device)(Z)


def gram_matvec_regen(model, X, a: np.ndarray, *, batch_size: int = 128,
                      s: Optional[np.ndarray] = None,
                      device) -> np.ndarray:
    """K(X, X) @ a by regenerating Gram tiles, O(N * nrhs) memory.  Only
    the raw form (``s=None``) is ported; the scaled, pinned M @ a belongs
    to the large-N refinement, which is not."""
    if s is not None:
        raise NotImplementedError(
            "gram_matvec_regen(s=...) is the refinement matvec of "
            "classify_device_large, which is not ported yet (ROADMAP.md, "
            "Queue 1)")
    return scores_regen(model, X, X, a, batch_size=batch_size,
                        device=device)


@torch.no_grad()
def rebuild_factor(model, train_x, scalings, *, batch_size: int = 128,
                   device):
    """Reassemble the equilibrated system a prior solve factored and
    refactor it: assembly and factor only, no solve.  ``scalings`` are the
    posterior's ``1/sqrt(diag K + jr)``.

    M is assembled into one float32 card tensor, each lower tile computed
    as the JAX package computes it and mirrored into the upper triangle,
    and factored on the card.  Returns ``(factor, x_all, s_dev)``, the
    triple :func:`variances_from_factor` consumes."""
    device = torch.device(device)
    settings.check_precision_on(device)
    x_all = _on_device(train_x, device)
    n, b = len(x_all), batch_size
    s = torch.as_tensor(np.asarray(scalings, np.float32), device=device)
    spec = megakernel.match(model)
    m = torch.empty((n, n), dtype=torch.float32, device=device)
    for i0, j0 in scheduler.tile_offsets(n, n, b, True):
        # the upper manifest's (i0, j0) names the lower tile (j0, i0)
        blk = _scaled_tile(model, spec, x_all, s, j0, i0, b)
        bj, bi = blk.shape
        m[j0:j0 + bj, i0:i0 + bi] = blk
        if i0 != j0:
            m[i0:i0 + bi, j0:j0 + bj] = blk.T
    factor = CardFactor(m)
    return factor, x_all, s


@torch.no_grad()
def variances_from_factor(factor: CardFactor, model, x_all: torch.Tensor,
                          s_dev: torch.Tensor, xz, b: int, n: int, snap):
    """GP posterior variances ``k_zz - || L^-1 (s * k_xz) ||^2`` for one
    query split through a live factor of M (empty-split safe).  ``k_zz``
    comes from ``apply_kernel(diag=True)`` per batch; the scaled cross
    columns are built per [n, 512] block and never exist in full.  Accuracy
    is the float32 accumulation floor, about eps32 * k_zz absolute.

    ``snap`` is the settings snapshot the factor was rebuilt under; the
    cross columns must come from the same kernel, so another snapshot is
    refused.  (The JAX function's ``a_scaled``, scores riding the cross
    blocks, serves only ``classify_device_large`` and comes with it.)"""
    if snap != settings.snapshot():
        raise ValueError(f"the factor was rebuilt under settings {snap} "
                         f"but this process now has {settings.snapshot()}")
    if not n == len(x_all) == factor.n == len(s_dev):
        raise ValueError(f"n={n} but x_all has {len(x_all)} rows, s_dev "
                         f"{len(s_dev)} and the factor {factor.n}")
    if len(xz) == 0:
        return np.zeros(0, np.float64)
    device = x_all.device
    settings.check_precision_on(device)
    z_all = _on_device(xz, device)
    mz = len(z_all)
    kzz = compute_gram_diag(model, z_all, device=device, batch_size=b,
                            progress=False).astype(np.float64)
    spec = megakernel.match(model)
    # column blocks: a multiple of the tile size, at least one tile
    cb = max(b, (_CROSS_BLOCK // b) * b)
    sumsq = torch.empty(mz, dtype=torch.float32, device=device)
    for c0 in range(0, mz, cb):
        z_blk = z_all[c0:c0 + cb]
        w = torch.empty((n, len(z_blk)), dtype=torch.float32, device=device)
        for i0, j0 in scheduler.tile_offsets(n, len(z_blk), b, False):
            blk = _tile_body(model, spec, x_all, z_blk, i0, j0, b, False)
            bi, bj = blk.shape
            w[i0:i0 + bi, j0:j0 + bj] = blk * s_dev[i0:i0 + bi, None]
        sumsq[c0:c0 + len(z_blk)] = factor.forward_sumsq(w)
    return np.maximum(kzz - sumsq.cpu().numpy(), 0.0)

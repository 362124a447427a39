"""Device-resident Gram assembly and classification.

PyTorch counterpart of ``cnn_gp_tpu/parallel/device_pipeline.py``.  The
whole Gram is assembled in one card tensor, tile by tile over the
scheduler's manifest through ``parallel.gram._tile_body`` on the route
``gram.tile_spec`` chooses (the CUDA megakernel, the full covariance's
kernels, each on one pre-pass per image set, or ``apply_kernel``), and
the solve runs on that resident tensor:

    K = gram_device(model, x, device=dev)                      # [N, N]
    acc = classify_device(model, xtr, ytr, (xte, yte), device=dev)

Nothing is padded: ``_tile_body`` slices ragged edge tiles and the kernel
takes any tile shape.  Memory: the float32 Gram is N^2 * 4 bytes (1 GB at
N = 16,384); ``refine=True`` converts it to float64 (12 N^2 bytes while
both exist) and factors that copy in place (``chol_dist.CardFactor``), so
the peak is 12 N^2 bytes plus the cross Grams.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import settings
from ..ops import solve
from ..utils import timing
from . import scheduler
from .chol_dist import CardFactor
from .gram import (_on_device, _tile_body, call_span, compute_gram_diag,
                   set_maps, tile_spec)

__all__ = ["gram_device", "classify_device"]


@torch.no_grad()
def gram_device(model, X, Z=None, *, batch_size: int = 128,
                device) -> torch.Tensor:
    """Full Gram K(X, Z) as one float32 tensor on ``device``.

    Z=None computes the upper tile triangle of K(X, X) and mirrors it:
    each off-diagonal tile is written with its transpose, and each
    diagonal tile (one launch with the same-example mask) keeps its upper
    triangle and mirrors it, as ``ops.solve.symmetrize_from_upper`` does,
    so ``K == K.T`` holds bit for bit."""
    device = torch.device(device)
    settings.check_precision_on(device)
    symmetric = Z is None
    n1, n2 = len(X), len(X if symmetric else Z)
    b = batch_size
    offsets = list(scheduler.tile_offsets(n1, n2, b, symmetric))
    with call_span("gram_device", n1, n2, b) as call:
        call.set(tiles=len(offsets))
        x_all = _on_device(X, device)
        z_all = x_all if symmetric else _on_device(Z, device)
        spec = tile_spec(model)
        maps = set_maps(spec, x_all, z_all)
        k = torch.empty((n1, n2), dtype=torch.float32, device=device)
        for i0, j0 in offsets:
            with timing.span("gram.tile", i0=i0, j0=j0):
                blk = _tile_body(model, spec, x_all, z_all, i0, j0, b,
                                 symmetric, maps)
                bi, bj = blk.shape
                if symmetric and i0 == j0:
                    blk = torch.triu(blk) + torch.triu(blk, 1).T
                k[i0:i0 + bi, j0:j0 + bj] = blk
                if symmetric and i0 != j0:
                    k[j0:j0 + bj, i0:i0 + bi] = blk.T
    return k


@torch.no_grad()
def classify_device(model, train_x, train_y, *splits,
                    batch_size: int = 128, jitter: float = 1e-6,
                    refine: bool = True, variances: bool = False, device):
    """GP classification with the Gram never leaving the card.

    ``splits`` are (x, labels) pairs; returns a list of accuracies.
    ``jitter`` is RELATIVE: the system solved is
    ``K + jitter * mean(diag K) * I``.

    * ``refine=False``: float32 on the card, the Gram normalised by its
      mean diagonal before the factorisation (the JAX package's float32
      path).
    * ``refine=True``: one float64 Cholesky of the resident Gram on the
      card.  (The JAX package factors in float32 and refines in float64 on
      the host from a downloaded Kxx; Hopper has native FP64, so nothing
      N^2 goes to the host here.)

    With ``variances=True`` returns ``(accuracies, variances)``: per-split
    GP posterior variances ``k_zz - k_zx (K + jitter*mean(diag)*I)^-1 k_xz``
    through the same factor, with ``k_zz`` from ``compute_gram_diag`` per
    batch (float64 oracle: ``ops.solve.predictive_variance``)."""
    device = torch.device(device)
    settings.check_precision_on(device)
    n_classes = int(np.max(train_y)) + 1
    y = torch.as_tensor(solve.one_hot_targets(train_y, n_classes),
                        device=device)
    kxx = gram_device(model, train_x, batch_size=batch_size, device=device)
    kzx = [gram_device(model, x, train_x, batch_size=batch_size,
                       device=device) for x, _ in splits]
    if refine:
        dtype = torch.float64
        k = kxx.to(dtype)
        del kxx
        s = 1.0           # the float64 factor needs no normalisation
        k.diagonal().add_(jitter * float(k.diagonal().mean()))
    else:
        dtype = torch.float32
        s = float(kxx.diagonal().mean())
        k = kxx.div_(s)   # scale-normalised for float32 conditioning
        k.diagonal().add_(jitter)
    factor = CardFactor.of(k)  # in place; raises rather than return NaNs
    del k
    a = factor.solve_dev(y)
    accs = []
    for kz, (_, labels) in zip(kzx, splits):
        pred = torch.argmax((kz.to(dtype) / s) @ a, dim=1).cpu().numpy()
        accs.append(solve.accuracy(pred, np.asarray(labels)))
    if not variances:
        return accs
    var = []
    for kz, (xz, _) in zip(kzx, splits):
        kzz = torch.as_tensor(compute_gram_diag(
            model, xz, device=device, batch_size=batch_size,
            progress=False), dtype=dtype, device=device)
        # K + jr I = s * (L L^T), so the quadratic form is ||L^-1 k_xz||^2/s
        # (whitened per block of 512 query columns)
        sumsq = torch.cat([factor.forward_sumsq(kz[c0:c0 + 512].T)
                           for c0 in range(0, len(kz), 512)])
        v = kzz - sumsq / s
        var.append(torch.clamp(v, min=0.0).cpu().numpy())
    return accs, var

"""Online GP classification: factor once, grow as labelled data arrives.

PyTorch counterpart of ``cnn_gp_tpu/parallel/incremental.py`` on one card.
Adding training data to the reference means recomputing the whole Gram
and re-running the whole O(N^3) solve.  Here the card-resident blocked
factor (``chol_dist.CardFactor``) grows in place (``CardFactor.extend``):
each batch of m new points costs

* the [m, N] and [m, m] cross-covariance blocks, through the same tile
  path as every Gram (``parallel.gram._tile_body``: the CUDA megakernel for
  the ConvNet-GP family),
* one m-wide blocked forward solve and an [m, m] Cholesky on the card
  (O(N^2 m), not O((N + m)^3 / 3)),
* one factor solve and float64 iterative refinement for the posterior,

and the GP log evidence is read from the live factor's diagonal after
every step.  The training images live on the card in a buffer of capacity
rows, written in place as batches arrive, in both modes.

Two host-memory modes:

* ``retain_gram=True`` (default): the raw float32 Gram is kept on the host
  for the refinement matvec, so the residuals are float64-exact (down to
  1e-10).  The [capacity, capacity] buffer is allocated once with
  ``np.zeros`` (pages are taken only as rows arrive) and extensions write
  their rows and columns in place.
* ``retain_gram=False``: nothing O(N^2) is kept on the host.  The first
  batch's equilibrated Gram is assembled on the card straight into the
  factor buffer; the float32 scalings sit beside the images in a card
  buffer of capacity size; each extension's cross blocks are assembled on
  the card and handed to ``CardFactor.extend_device``; refinement
  residuals are measured in scaled space by regenerating the scaled tiles
  (the ``classify_device_large`` arithmetic, one Gram sweep per residual
  evaluation, float32 accumulation: a floor near 1e-6 relative).

For batch (non-incremental) large-N classification use
``device_large.classify_device_large``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import serving
from ..ops import megakernel
from ..ops import solve as solve_ops
from . import scheduler
from .chol_dist import (CardFactor, _blocked_residual_fn, _ir_solve,
                        variances_from_cross_host)
from .device_large import _assemble_scaled, _matvec_scan, _scaled_tile
from .gram import _tile_body, compute_gram, compute_gram_diag, gram_in_memory

__all__ = ["IncrementalGP"]


class IncrementalGP:
    """Streaming GP classifier over a growing training set, on ``device``.

    ``capacity`` bounds the training points the factor can grow to (held
    as identity-padded rows: the factor's cost scales with the padded
    size, so reserve what will be used).  ``jitter`` is relative to the
    FIRST batch's mean Gram diagonal and stays frozen, as in
    ``classify_device_large``; each later batch gets its own diagonal and
    scalings, and the earlier scalings stay as they were.

    ``n_classes`` pins the score width: left at None it is
    ``max(labels seen) + 1``, so a class absent from the stream so far
    cannot be predicted and ``scores()`` widens when it first appears.

    ``retain_gram=False`` keeps no [capacity, capacity] Gram on the host:
    residuals come from regenerated float32 tiles (see the module
    docstring), ``tol`` is clamped to their floor and ``rel_residual`` is
    reported in scaled space; ``_resolve`` states both conventions.
    """

    def __init__(self, model, capacity: int, batch_size: int = 128,
                 block: int = 256, jitter: float = 0.0,
                 refine_iters: int = 10, tol: float = 1e-10,
                 n_classes: Optional[int] = None, retain_gram: bool = True,
                 *, device):
        self.model = model
        self.capacity = int(capacity)
        self.batch_size = batch_size
        self.block = block
        self.jitter = jitter
        self.refine_iters = refine_iters
        self.tol = tol
        self.n_classes = n_classes
        self.device = torch.device(device)
        # the raw float32 Gram at full capacity, paged in as rows arrive
        # and written in place; None when nothing O(N^2) stays on the host
        self._k32 = (np.zeros((self.capacity, self.capacity), np.float32)
                     if retain_gram else None)
        self._n = 0
        self._x_dev = None                # card [capacity, C, H, W]
        self._s_dev = None                # card [capacity] f32 (regen mode)
        self._labels = None
        self._s = None                    # float64 equilibration scalings
        self._jitter_raw = None
        self._factor: Optional[CardFactor] = None
        self._alpha = None                # float64 posterior weights
        self.rel_residual = None
        self.refinements = None
        self._timings, self._t0 = {}, 0.0

    def _tick(self, name: str) -> None:
        """Close the phase ``name`` of the current add(): wall seconds
        since the last tick, after a device synchronisation."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self._timings[name] = now - self._t0
        self._t0 = now

    @property
    def n(self) -> int:
        return self._n

    def _gram(self, x, z=None) -> np.ndarray:
        return gram_in_memory(self.model, x, z, device=self.device,
                              batch_size=self.batch_size, progress=False)

    def _diag(self, x) -> np.ndarray:
        return compute_gram_diag(self.model, x, device=self.device,
                                 batch_size=self.batch_size,
                                 progress=False).astype(np.float64)

    @torch.no_grad()
    def add(self, x, labels) -> dict:
        """Take a batch of labelled examples and refresh the posterior.

        Returns ``{"n", "rel_residual", "refinements", "log_evidence",
        "timings_s"}``; ``timings_s`` holds the wall seconds of the Gram
        blocks (``"gram"``, with the diagonal and the host scaling), the
        factorisation or extension (``"factor"``), an extension's writes
        into the retained Gram and the buffers (``"write"``) and the
        refined solve (``"solve"``).
        """
        x = np.asarray(x, np.float32)
        labels = np.asarray(labels)
        if len(x) != len(labels) or len(x) == 0:
            raise ValueError(f"add() needs a non-empty batch with one label "
                             f"per image, got {len(x)} and {len(labels)}")
        self._timings, self._t0 = {}, time.perf_counter()
        if self._factor is None:
            self._first_fit(x, labels)
        else:
            self._extend(x, labels)
        self._resolve()
        self._tick("solve")
        return {"n": self.n, "rel_residual": self.rel_residual,
                "refinements": self.refinements,
                "log_evidence": self.log_evidence(),
                "timings_s": dict(self._timings)}

    def _first_fit(self, x, labels):
        n, b = len(x), self.batch_size
        if n > self.capacity:
            raise ValueError(f"first batch {n} exceeds capacity "
                             f"{self.capacity}")
        x_dev = torch.zeros((self.capacity,) + x.shape[1:],
                            dtype=torch.float32, device=self.device)
        x_dev[:n] = torch.from_numpy(x).to(self.device)
        # pad_to=batch_size: the JAX package's factor geometry
        f = CardFactor(n, self.block, pad_to=b, capacity=self.capacity,
                       device=self.device)
        if self._k32 is not None:
            k32 = self._k32[:n, :n]         # assembled in place
            compute_gram(self.model, x_dev[:n], device=self.device,
                         batch_size=b, out=k32, progress=False)
            d64 = np.diagonal(k32).astype(np.float64)
        else:
            d64 = self._diag(x_dev[:n])
        jitter_raw = self.jitter * float(np.mean(d64))
        s = 1.0 / np.sqrt(d64 + jitter_raw)
        # with s from diag + jitter and the pinned unit diagonal, the
        # factored matrix IS the equilibrated K + jitter_raw I
        if self._k32 is not None:
            self._tick("gram")
            f.factorize_scaled(k32, s.astype(np.float32))
        else:
            s_dev = torch.ones(self.capacity, dtype=torch.float32,
                               device=self.device)
            s_dev[:n] = torch.from_numpy(s.astype(np.float32))
            k = _assemble_scaled(self.model, x_dev[:n], s_dev[:n], b, n,
                                 f.n_pad)
            self._tick("gram")
            f._factorize_dev(k)
            self._s_dev = s_dev
        self._tick("factor")
        self._x_dev, self._labels, self._n = x_dev, labels, n
        self._s, self._jitter_raw, self._factor = s, jitter_raw, f

    def _extend(self, x, labels):
        n, m = self.n, len(x)
        if n + m > self.capacity:
            raise ValueError(f"add past capacity: n={n} + m={m} > "
                             f"capacity={self.capacity}")
        z = torch.from_numpy(x).to(self.device)
        if self._k32 is not None:
            s_new = self._extend_host_blocks(z, n, m)
        else:
            s_new = self._extend_device_blocks(z, n, m)
            self._s_dev[n:n + m] = torch.from_numpy(s_new.astype(np.float32))
        self._x_dev[n:n + m] = z
        self._labels = np.concatenate([self._labels, labels])
        self._s = np.concatenate([self._s, s_new])
        self._n = n + m
        self._tick("write")

    def _extend_host_blocks(self, z, n, m):
        """Retained-Gram extension: the cross blocks go to the host (they
        must land in the retained Gram anyway), are scaled there and are
        uploaded by ``extend``."""
        b_raw = self._gram(z, self._x_dev[:n])                 # [m, n]
        c_raw = self._gram(z)                                  # [m, m]
        d_new = np.diagonal(c_raw).astype(np.float64) + self._jitter_raw
        s_new = 1.0 / np.sqrt(d_new)
        b_s = (s_new[:, None] * b_raw.astype(np.float64)
               * self._s[None, :]).astype(np.float32)
        c_s = (s_new[:, None] * (c_raw.astype(np.float64)
                                 + self._jitter_raw * np.eye(m))
               * s_new[None, :])
        np.fill_diagonal(c_s, 1.0)        # an exact unit diagonal
        self._tick("gram")
        # extend the factor FIRST: it raises (factor untouched) on a
        # non-PD extension, and then no host state has changed either
        self._factor.extend(b_s, c_s.astype(np.float32))
        self._tick("factor")
        self._k32[n:n + m, :n] = b_raw
        self._k32[:n, n:n + m] = b_raw.T
        self._k32[n:n + m, n:n + m] = c_raw
        return s_new

    def _extend_device_blocks(self, z, n, m):
        """Regen-mode extension: ``W = s_old K(x_old, z) s_new`` [n_pad, m]
        (zero past row n) and the [m, m] scaled new-new block with its
        unit diagonal are assembled on the card, tile by tile, and handed
        to ``extend_device``; only the [m] new diagonal reaches the
        host."""
        b, spec = self.batch_size, megakernel.match(self.model)
        s_new = 1.0 / np.sqrt(self._diag(z) + self._jitter_raw)
        s_z = torch.from_numpy(s_new.astype(np.float32)).to(self.device)
        x_old, s_old = self._x_dev[:n], self._s_dev[:n]
        w = torch.zeros((self._factor.n_pad, m), dtype=torch.float32,
                        device=self.device)
        for i0, j0 in scheduler.tile_offsets(n, m, b, False):
            blk = _tile_body(self.model, spec, x_old, z, i0, j0, b, False)
            bi, bj = blk.shape
            w[i0:i0 + bi, j0:j0 + bj] = (blk * s_old[i0:i0 + bi, None]
                                         * s_z[None, j0:j0 + bj])
        c_s = torch.empty((m, m), dtype=torch.float32, device=self.device)
        for i0, j0 in scheduler.tile_offsets(m, m, b, True):
            blk = _scaled_tile(self.model, spec, z, s_z, i0, j0, b)
            bi, bj = blk.shape
            c_s[i0:i0 + bi, j0:j0 + bj] = blk
            c_s[j0:j0 + bj, i0:i0 + bi] = blk.T
        self._tick("gram")
        # extend the factor FIRST: it raises (factor untouched) on a
        # non-PD extension, and then no host or card state has changed
        self._factor.extend_device(w, c_s)
        self._tick("factor")
        return s_new

    def _resolve(self):
        """Posterior weights by the float32 factor's solve and float64
        iterative refinement (the ``chol_solve_ir32`` machinery).  With the
        retained Gram the residuals are blocked float64 upcasts of the raw
        float32 matrix (raw space, scaled-space correction solves); without
        it they are measured in scaled space by regenerating the scaled
        tiles against the card-resident images and scalings, one Gram
        sweep per evaluation, with a float32-accumulation floor.

        The ``rel_residual`` convention differs by mode (the same number
        means different things): retained mode reports the RAW-space
        ``max_c ||y - (K + jr I) a||_c / ||y||_c``, regen mode the
        SCALED-space ``max_c ||S y - M a_s||_c / ||S y||_c`` of the
        equilibrated system the factor decomposed.  Both are
        scale-invariant, but compare residuals within one mode only.

        In regen mode ``tol`` is clamped to the float32 regeneration floor
        ``3 sqrt(n) eps32`` (the ``classify_device_large`` constant): the
        default 1e-10 is out of its reach, and sweeping on to stagnation
        costs one more whole Gram sweep per add()."""
        n, s = self.n, self._s
        y64 = solve_ops.one_hot_targets(self._labels, self.n_classes)
        if self._k32 is not None:
            residual = _blocked_residual_fn(self._k32[:n, :n], y64,
                                            self._jitter_raw)

            def precond(r64):
                return s[:, None] * self._factor.solve(
                    (s[:, None] * r64).astype(np.float32)
                ).astype(np.float64)

            self._alpha, self.rel_residual, self.refinements = _ir_solve(
                precond, residual, y64, self.refine_iters, self.tol)
            return

        b = self.batch_size
        x_all, s_all = self._x_dev[:n], self._s_dev[:n]
        ys = s[:, None] * y64
        y_norm = np.linalg.norm(ys, axis=0)
        y_norm[y_norm == 0] = 1.0

        def residual(a_s):
            # M a_s from regenerated scaled tiles (their pinned unit
            # diagonal IS the jitter in scaled space: the matrix the factor
            # holds); only the [n, C] iterate crosses to the card
            a_dev = torch.from_numpy(a_s.astype(np.float32)).to(self.device)
            ma = _matvec_scan(self.model, x_all, s_all, a_dev, b,
                              n).cpu().numpy().astype(np.float64)
            r = ys - ma
            return r, float(np.max(np.linalg.norm(r, axis=0) / y_norm))

        def precond(r64):
            return self._factor.solve(
                r64.astype(np.float32)).astype(np.float64)

        tol_eff = max(self.tol,
                      3.0 * np.sqrt(n) * float(np.finfo(np.float32).eps))
        a_s, self.rel_residual, self.refinements = _ir_solve(
            precond, residual, ys, self.refine_iters, tol_eff)
        self._alpha = s[:, None] * a_s

    def log_evidence(self) -> float:
        """GP log marginal likelihood of the current training set, read
        from the live factor (float64 oracle:
        ``ops.solve.log_marginal_likelihood``)."""
        self._require_data()
        logdet = (2.0 * self._factor.log_diag_sum()
                  - 2.0 * float(np.sum(np.log(self._s))))
        y64 = solve_ops.one_hot_targets(self._labels, self.n_classes)
        n_cls = y64.shape[1]
        return (-0.5 * float(np.sum(y64 * self._alpha))
                - 0.5 * n_cls * logdet
                - 0.5 * self.n * n_cls * np.log(2.0 * np.pi))

    def _require_data(self):
        if self._alpha is None:
            raise RuntimeError("add() labelled data before predicting")

    def save_posterior(self, path, config_name: str = "") -> str:
        """Save the CURRENT posterior as the O(N) serving artifact
        (``serving.save_posterior``): a ``GPPredictor`` over the file
        serves this object's predictions and, after its solve-free factor
        rebuild, its variances.  Returns the final path."""
        self._require_data()
        return serving.save_posterior(
            path, train_x=self._x_dev[:self.n].cpu().numpy(),
            alpha=self._alpha, scalings=self._s,
            jitter_raw=self._jitter_raw, config_name=config_name)

    @torch.no_grad()
    def scores(self, x) -> np.ndarray:
        """Posterior mean scores ``K(x, X_train) @ alpha`` per class."""
        self._require_data()
        x = np.asarray(x, np.float32)
        if len(x) == 0:
            return np.zeros((0, self._alpha.shape[1]), np.float64)
        kzx = self._gram(x, self._x_dev[:self.n])
        return kzx.astype(np.float64) @ self._alpha

    def classify(self, x) -> np.ndarray:
        return np.argmax(self.scores(x), axis=1)

    @torch.no_grad()
    def predict(self, x, chunk: int = 512):
        """``(scores, variances)`` for one query batch from ONE [nz, n]
        cross-covariance sweep (``classify`` then ``variances`` would
        compute it twice, and the sweep is the dominant cost)."""
        self._require_data()
        x = np.asarray(x, np.float32)
        if len(x) == 0:
            return (np.zeros((0, self._alpha.shape[1]), np.float64),
                    np.zeros(0, np.float64))
        kzx = self._gram(x, self._x_dev[:self.n])
        return (kzx.astype(np.float64) @ self._alpha,
                variances_from_cross_host(self._factor, self._s, kzx,
                                          self._diag(x), chunk=chunk))

    @torch.no_grad()
    def variances(self, x, chunk: int = 512) -> np.ndarray:
        """GP posterior variances ``k_zz - k_zx (K + jr I)^-1 k_xz``
        through the live factor (valid across extensions: it is always the
        factor of the whole current system).  Use :meth:`predict` when the
        scores are needed too.  Float32 floor ~eps32 * k_zz; float64
        oracle: ``ops.solve.predictive_variance``."""
        self._require_data()
        x = np.asarray(x, np.float32)
        if len(x) == 0:
            return np.zeros(0, np.float64)
        kzx = self._gram(x, self._x_dev[:self.n])
        return variances_from_cross_host(self._factor, self._s, kzx,
                                         self._diag(x), chunk=chunk)

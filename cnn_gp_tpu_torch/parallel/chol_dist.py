"""Blocked in-place Cholesky of the equilibrated GP system on one card, and
the solvers built on it.

PyTorch counterpart of the single-card subset of
``cnn_gp_tpu/parallel/chol_dist.py``.  NNGP Grams of the paper configs
have diagonals ~1e12, so the solvers factor the Jacobi-equilibrated
system ``D^-1/2 (K + jitter I) D^-1/2`` (unit diagonal) in float32 on the
card and recover float64-quality solutions by iterative refinement:
float64 residuals on the host, float32 correction solves through the
card-resident factor.

``CardFactor`` holds the factor as ONE [n_pad, n_pad] card tensor,
factored in place by a blocked right-looking loop over ``block``: each
step takes ``cholesky_ex`` of the diagonal block, a triangular solve of
the panel below it, and a matmul update of the trailing lower part, one
column block at a time.  The peak is that one buffer plus an
[n_pad, block] panel (a whole-matrix ``torch.linalg.cholesky`` would
return a second N^2 buffer).  Only the lower triangle is read; the upper
triangle comes out zero.  Rows ``[n, n_pad)`` are identity padding, so
the padded factor embeds the factor of the true system, and the geometry
(``n_pad``, ``block``) is the JAX package's on a one-device mesh.

``capacity=`` reserves identity-padded rows past ``n``, and ``extend`` /
``extend_device`` grow the factored system into them in place (online data
addition, ``parallel/incremental.py``).

``ShardedFactor`` is the same factor row-sharded over a rank group
(``parallel/mesh.py``): a rank holds ``l_loc``, its rows
``row_span(n_pad, mesh)`` of the [n_pad, n_pad] factor, and ``diags``, the
replicated [n_pad / block, block, block] stack of diagonal blocks.  Each
block step gathers the panel column (one ``all_gather``), factors the
diagonal block on every rank, solves the rank's panel rows
(``solve_triangular``; the JAX package multiplies by an explicit inverse
only to dodge an XLA memory fault), gathers the solved panel (a second
``all_gather``) and updates the rank's trailing rows one column block at a
time.  The solves take one ``all_gather`` of [rows_local, nrhs] per
forward block step and one ``all_reduce`` of [block, nrhs] per backward
step; no rank ever holds the whole factor.  Every collective solve uses
rank 0's right-hand side, and every decision that controls a collective
is taken from values that every rank holds bit for bit: the failed
diagonal block, the positive-definiteness gate of ``extend`` and the
refinement stops of the solvers.

Passing ``mesh=`` to a solver below selects the sharded factor, even for a
world of one; ``mesh=None`` keeps ``CardFactor``.  With a group, only
rank 0's host matrix is read: each rank receives its rows in chunks of
``io_rows``, and rank 0 computes the float64 refinement residuals and
broadcasts them.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import settings
from .mesh import (Mesh, agree, all_gather_rows, all_reduce_sum_, any_rank,
                   is_root,
                   broadcast_, broadcast_array, make_mesh, row_span)

__all__ = ["CardFactor", "ShardedFactor", "cholesky_sharded",
           "cholesky_solve_sharded", "chol_solve_dist", "chol_solve_ir32",
           "chol_solve_dist_from_store", "chol_solve_stream_from_store",
           "variances_from_cross_host", "evidence_from_factor"]


def _chunk_starts(total: int, size: int):
    """Fixed-size chunk starts covering [0, total) with a slid-back tail:
    the last chunk starts at ``total - size`` (overlapping rewrites must
    be idempotent at the call site).  Requires ``size <= total``."""
    assert 0 < size <= total, (size, total)
    return list(range(0, total - size, size)) + [total - size]


def _pad_size(n: int, block: int, n_dev: int = 1, pad_to: int = 1) -> int:
    """Smallest N_pad >= n divisible by ``block``, ``n_dev`` and ``pad_to``
    (the JAX package's factor geometry)."""
    step = int(np.lcm(np.lcm(block, n_dev), pad_to))
    return int(-(-n // step) * step)


def _blocked_residual_fn(k, y64: np.ndarray, jitter: float,
                         io_rows: int = 8192):
    """Residual closure ``a -> (Y - (K + jitter I) a, max rel norm)`` with
    the float64 upcast done in bounded row blocks (never a second
    whole-matrix host copy).  ``k`` is the [n, n] host matrix."""
    n = k.shape[0]
    y_norm = np.linalg.norm(y64, axis=0)
    y_norm[y_norm == 0] = 1.0

    def residual(a):
        r = np.empty_like(y64)
        for i0 in range(0, n, io_rows):
            i1 = min(i0 + io_rows, n)
            r[i0:i1] = y64[i0:i1] - k[i0:i1].astype(np.float64) @ a
        if jitter:
            r -= jitter * a
        return r, float(np.max(np.linalg.norm(r, axis=0) / y_norm))

    return residual


def _ir_solve(precond, residual, y64: np.ndarray, refine_iters: int,
              tol: float):
    """Float64 iterative refinement against a float32 factor: ``precond``
    maps a float64 residual to a correction (one factor solve),
    ``residual`` is a `_blocked_residual_fn`-style closure.  Keeps the best
    iterate and stops on ``tol`` or stagnation (a sweep that shrinks the
    best residual by less than 10%).  Returns ``(best_a, best_rel,
    iters)``."""
    a = precond(y64)
    r, rel = residual(a)
    best_a, best_rel = a, rel
    iters = 0
    while iters < refine_iters and best_rel > tol:
        iters += 1
        a = a + precond(r)
        r, rel = residual(a)
        prev_best = best_rel
        if rel < best_rel:
            best_a, best_rel = a, rel
        if rel > 0.9 * prev_best:            # <10% progress: stagnated at
            break                            # the factor's floor
    return best_a, best_rel, iters


class CardFactor:
    """The lower Cholesky factor of an SPD system, held in one
    [n_pad, n_pad] card tensor ``l`` and factored there in place."""

    def __init__(self, n: int, block: int = 1024, pad_to: int = 1,
                 capacity: Optional[int] = None, *, device,
                 dtype=torch.float32):
        """``capacity`` reserves identity-padded rows past ``n``, so the
        factored system can later grow in place (:meth:`extend`).  The
        factor's cost scales with the padded size, identity rows included,
        so reserve only what will be used."""
        self.n = int(n)
        self.block = int(block)
        self.n_pad = _pad_size(max(self.n, int(capacity or self.n)),
                               self.block, 1, pad_to)
        self.device = torch.device(device)
        self.dtype = dtype
        self.l: Optional[torch.Tensor] = None

    @classmethod
    def of(cls, m: torch.Tensor, block: int = 1024) -> "CardFactor":
        """Factor the square card tensor ``m`` in place, unpadded (a ragged
        last block): ``m`` becomes the factor."""
        f = cls(m.shape[0], min(block, max(1, m.shape[0])),
                device=m.device, dtype=m.dtype)
        f.n_pad = f.n
        f._factorize_dev(m)
        return f

    def release(self) -> None:
        """Drop the factor (its card memory goes back to the allocator)."""
        self.l = None

    def _new_buffer(self) -> torch.Tensor:
        return torch.zeros((self.n_pad, self.n_pad), dtype=self.dtype,
                           device=self.device)

    def _upload_rows(self, make_rows, io_rows: int = 4096) -> torch.Tensor:
        """The [n_pad, n_pad] card buffer built in bounded row chunks
        (never a second whole-matrix host copy): ``make_rows(r0, r1)``
        returns rows [r0, r1) as a float32 [r1 - r0, n_pad] host array."""
        k = self._new_buffer()
        for r0 in range(0, self.n_pad, io_rows):
            r1 = min(r0 + io_rows, self.n_pad)
            rows = np.require(make_rows(r0, r1), np.float32, ["C", "W"])
            k[r0:r1] = torch.from_numpy(rows).to(self.device, self.dtype)
        return k

    def factorize(self, ks32: np.ndarray) -> None:
        """Upload (identity-padded) and factor in place."""
        n = self.n

        def make_rows(r0, r1):
            out = np.zeros((r1 - r0, self.n_pad), np.float32)
            if r0 < n:
                out[:n - r0, :n] = ks32[r0:min(r1, n)]
            pad = np.arange(max(r0, n), r1)   # identity padding leaves the
            out[pad - r0, pad] = 1.0          # factor of K intact
            return out

        self._factorize_dev(self._upload_rows(make_rows))

    def factorize_scaled(self, k32: np.ndarray, s32: np.ndarray) -> None:
        """Factor diag(s) K diag(s) without materialising the scaled matrix
        on the host: each row chunk is scaled during upload, and the scaled
        diagonal is pinned to exactly 1 (Jacobi equilibration)."""
        n = self.n

        def make_rows(r0, r1):
            out = np.zeros((r1 - r0, self.n_pad), np.float32)
            if r0 < n:
                hi = min(r1, n)
                out[:hi - r0, :n] = (k32[r0:hi] * s32[r0:hi, None]
                                     * s32[None, :])
            diag = np.arange(r0, r1)          # unit diagonal (rows >= n:
            out[diag - r0, diag] = 1.0        # identity padding)
            return out

        self._factorize_dev(self._upload_rows(make_rows))

    def factorize_device(self, k_dev: torch.Tensor, s32=None) -> None:
        """Factor a Gram that already lives on the card ([n, n] float32),
        with no host round trip; optionally Jacobi-scaled by ``s32`` (host
        [n] float32) with the scaled diagonal pinned to 1.  ``k_dev`` is
        consumed: when ``n_pad == n`` it becomes the factor, else it is
        copied into the padded buffer (peak n^2 + n_pad^2)."""
        n = self.n
        if s32 is not None:
            s = torch.as_tensor(np.asarray(s32, np.float32),
                                device=k_dev.device)
            k_dev.mul_(s[:, None]).mul_(s[None, :])
        if self.n_pad == n:
            k = k_dev
        else:
            k = self._new_buffer()
            k[:n, :n] = k_dev
            k.diagonal()[n:] = 1.0
        if s32 is not None:
            k.diagonal()[:n] = 1.0
        self._factorize_dev(k)

    def factorize_padded_scaled(self, k_dev: torch.Tensor,
                                s32: np.ndarray) -> None:
        """Scale an already padded [n_pad, n_pad] card buffer to
        diag(s) K diag(s) in place (``k * (s_i * s_j)``, row chunk by row
        chunk: no second N^2 buffer), pin the diagonal to 1 and factor.
        For the streamed upload, where the scalings are known only once
        the whole diagonal has streamed past."""
        s_pad = np.ones(self.n_pad, np.float32)
        s_pad[:self.n] = s32
        s = torch.as_tensor(s_pad, device=k_dev.device)
        for r0 in range(0, self.n_pad, 4096):
            r1 = min(r0 + 4096, self.n_pad)
            k_dev[r0:r1].mul_(s[r0:r1, None] * s[None, :])
        k_dev.diagonal().fill_(1.0)
        self._factorize_dev(k_dev)

    @torch.no_grad()
    def _factorize_dev(self, k: torch.Tensor) -> None:
        """Blocked right-looking Cholesky of ``k`` in place (lower triangle
        read, upper triangle zeroed).  Raises ``LinAlgError`` where the
        system is not positive-definite at its precision."""
        settings.check_precision_on(k.device)
        n_pad, bs = k.shape[0], self.block
        infos = []
        for c0 in range(0, n_pad, bs):
            c1 = min(c0 + bs, n_pad)
            lkk, info = torch.linalg.cholesky_ex(k[c0:c1, c0:c1])
            infos.append(info)
            k[c0:c1, c0:c1] = lkk
            k[:c0, c0:c1] = 0.0
            if c1 == n_pad:
                break
            # panel: X Lkk^T = K[c1:, c0:c1]
            x = torch.linalg.solve_triangular(lkk.mT, k[c1:, c0:c1],
                                              upper=True, left=False)
            k[c1:, c0:c1] = x
            # trailing lower part, one column block at a time
            for d0 in range(c1, n_pad, bs):
                d1 = min(d0 + bs, n_pad)
                k[d0:, d0:d1].addmm_(x[d0 - c1:], x[d0 - c1:d1 - c1].T,
                                     alpha=-1.0)
            del x
        bad = torch.nonzero(torch.stack(infos)).flatten()
        if len(bad):
            kb = int(bad[0])
            raise np.linalg.LinAlgError(
                f"Cholesky of the {n_pad}x{n_pad} {k.dtype} system failed in "
                f"diagonal block {kb} at minor {int(infos[kb])} (not "
                f"positive-definite at this precision); add jitter")
        self.l = k

    def _forward(self, b: torch.Tensor) -> torch.Tensor:
        """``L^-1 b`` in place for ``b`` [r, m], r in [n, n_pad]: the factor
        is block-diagonal with an identity pad block, so the leading r
        rows suffice."""
        l, bs, r = self.l, self.block, b.shape[0]
        for c0 in range(0, r, bs):
            c1 = min(c0 + bs, r)
            yk = torch.linalg.solve_triangular(l[c0:c1, c0:c1], b[c0:c1],
                                               upper=False)
            b[c0:c1] = yk
            if c1 < r:
                b[c1:].addmm_(l[c1:r, c0:c1], yk, alpha=-1.0)
        return b

    def _backward(self, y: torch.Tensor) -> torch.Tensor:
        """``L^-T y`` in place for ``y`` [r, m]."""
        l, bs, r = self.l, self.block, y.shape[0]
        for c0 in reversed(range(0, r, bs)):
            c1 = min(c0 + bs, r)
            if c1 < r:
                y[c0:c1].addmm_(l[c1:r, c0:c1].T, y[c1:], alpha=-1.0)
            y[c0:c1] = torch.linalg.solve_triangular(
                l[c0:c1, c0:c1].mT, y[c0:c1], upper=True)
        return y

    @torch.no_grad()
    def solve_dev(self, b: torch.Tensor) -> torch.Tensor:
        """``(L L^T)^-1 b`` for a card tensor ``b`` [r, m] (a new tensor in
        the factor's dtype)."""
        settings.check_precision_on(self.device)
        return self._backward(self._forward(
            b.to(self.dtype, copy=True).contiguous()))

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """``(L L^T)^-1 rhs`` for host ``rhs`` [n, nrhs], in the factor's
        precision."""
        b = torch.as_tensor(np.asarray(rhs), device=self.device)
        return self.solve_dev(b).cpu().numpy()

    @torch.no_grad()
    def forward_sumsq(self, w: torch.Tensor) -> torch.Tensor:
        """``sum((L^-1 W) ** 2, axis=0)`` for ``W`` [n, m] (or [n_pad, m])
        on the factor's device: the squared whitened cross-covariance
        column norms that predictive variance subtracts."""
        settings.check_precision_on(self.device)
        v = self._forward(w.to(self.dtype, copy=True).contiguous())
        return (v * v).sum(0)

    def log_diag_sum(self) -> float:
        """``sum(log(diag(L)))`` over the padded factor, accumulated in
        float64 on the host; identity pad rows contribute exactly 0."""
        if self.l is None:
            raise RuntimeError("factorize before log_diag_sum")
        d = self.l.diagonal().cpu().numpy().astype(np.float64)
        return float(np.sum(np.log(d)))

    def diag_blocks(self) -> torch.Tensor:
        """The [n_pad / block, block, block] diagonal blocks of the factor
        (the JAX package's ``diags`` stack), read from the live buffer: an
        extension leaves nothing else to refresh."""
        nb, bs = self.n_pad // self.block, self.block
        return torch.stack([self.l[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs]
                            for i in range(nb)])

    def _check_factored(self) -> None:
        if self.l is None:
            raise RuntimeError("factorize before extend")

    def _check_capacity(self, m: int) -> None:
        if self.n + m > self.n_pad:
            raise ValueError(
                f"extend past capacity: n={self.n} + m={m} > "
                f"n_pad={self.n_pad}; construct with capacity>={self.n + m}")

    def extend(self, b_scaled: np.ndarray, c_scaled: np.ndarray) -> None:
        """Grow the factored system by ``m`` rows in place (online data
        addition): O(N^2 m) work instead of an O((N + m)^3 / 3) refactor,
        and no second N^2 buffer.

        The new rows fill identity-padded rows the factor already holds
        (``capacity=``).  For ``M2 = [[M, B^T], [B, C]]``: ``L21 = B L^-T``
        by one blocked forward solve with ``B^T`` as its right-hand side,
        ``L22 = chol(C - L21 L21^T)`` (one [m, m] Cholesky; chain calls
        for a large m), and rows [n, n + m) of the buffer are overwritten.

        ``b_scaled`` [m, n] and ``c_scaled`` [m, m] (host arrays) must be in
        the factored matrix's scaled space: for an equilibrated factor
        ``s_new[:, None] * K_new_old * s_old[None, :]`` and
        ``s_new[:, None] * K_new_new * s_new[None, :]``, the old scalings
        frozen.  A non positive-definite extension raises ``ValueError``
        and leaves the factor as it was, bit for bit."""
        self._check_factored()
        b_scaled = np.asarray(b_scaled, np.float32)
        c_scaled = np.asarray(c_scaled, np.float32)
        m, nb_cols = b_scaled.shape
        if nb_cols != self.n or c_scaled.shape != (m, m):
            raise ValueError((b_scaled.shape, c_scaled.shape, self.n))
        self._check_capacity(m)
        # uploaded as it lies and transposed on the device: a host
        # transpose of an [m, n] block costs more than the extension
        rhs = torch.from_numpy(np.ascontiguousarray(b_scaled)).to(
            self.device, self.dtype).T.contiguous()
        self._extend_core(rhs, torch.from_numpy(c_scaled).to(
            self.device, self.dtype))

    def extend_device(self, w: torch.Tensor, c_scaled: torch.Tensor) -> None:
        """:meth:`extend` for cross blocks already on the card: ``w`` is the
        [n_pad, m] scaled block ``B^T`` with zero rows over [n, n_pad)
        (``W[i, j] = s_old[i] K(x_i, z_j) s_new[j]``), ``c_scaled`` the
        [m, m] scaled new-new block with a unit diagonal.  Neither is
        modified."""
        self._check_factored()
        m = w.shape[1]
        if w.shape != (self.n_pad, m) or c_scaled.shape != (m, m):
            raise ValueError((tuple(w.shape), tuple(c_scaled.shape),
                              self.n_pad))
        self._check_capacity(m)
        self._extend_core(w[:self.n].to(self.dtype, copy=True).contiguous(),
                          c_scaled.to(self.dtype))

    @torch.no_grad()
    def _extend_core(self, rhs: torch.Tensor, c: torch.Tensor) -> None:
        """``rhs`` [n, m] (consumed) holds ``B^T``; ``c`` [m, m] holds C."""
        settings.check_precision_on(self.device)
        n0, m = self.n, rhs.shape[1]
        # y = L^-1 B^T over the leading n rows: the pad block is identity
        # and B^T is zero there, so the rows below n would stay zero
        y = self._forward(rhs)
        l22, info = torch.linalg.cholesky_ex(c - y.T @ y)
        # the positive-definiteness gate comes BEFORE any write: a non-PD
        # Schur complement (duplicate points at zero jitter) would
        # otherwise leave NaNs or garbage in the live factor
        d = l22.diagonal()
        if (int(info) != 0 or not bool(torch.isfinite(d).all())
                or bool((d <= 0).any())):
            raise ValueError(
                "extend: the Schur complement of the new rows is not "
                "positive-definite in float32 (duplicate or near-duplicate "
                "training points, or zero jitter?); the live factor is "
                "unchanged")
        # rows n0 + m and up stay identity, the upper triangle zero
        self.l[n0:n0 + m, :n0] = y.T
        self.l[n0:n0 + m, n0:n0 + m] = torch.tril(l22)
        self.n = n0 + m


class ShardedFactor:
    """The lower Cholesky factor of an SPD system, row-sharded over the
    rank group ``mesh``: ``l_loc`` holds this rank's rows
    ``[r0, r1) = row_span(n_pad, mesh)`` of the [n_pad, n_pad] factor on
    ``mesh.device``, ``diags`` the replicated stack of its diagonal blocks.
    The surface is ``CardFactor``'s; the geometry is the JAX package's
    ``_ShardedFactor`` on a mesh of ``mesh.size`` devices."""

    def __init__(self, mesh: Mesh, n: int, block: int = 1024,
                 pad_to: int = 1, capacity: Optional[int] = None):
        """``capacity`` reserves identity-padded rows past ``n`` for
        :meth:`extend`, as in ``CardFactor``."""
        self.mesh = mesh
        self.device = mesh.device
        self.n = int(n)
        self.block = int(block)
        self.n_pad = _pad_size(max(self.n, int(capacity or self.n)),
                               self.block, mesh.size, pad_to)
        self.r0, self.r1 = row_span(self.n_pad, mesh)
        self.rows_local = self.r1 - self.r0
        self.dtype = torch.float32
        self.l_loc: Optional[torch.Tensor] = None
        self.diags: Optional[torch.Tensor] = None

    def release(self) -> None:
        """Drop the factor (its card memory goes back to the allocator)."""
        self.l_loc = self.diags = None

    def _span(self, lo: int, hi: int):
        """Local indices [a, b) of the global rows [lo, hi) this rank
        holds (a == b when it holds none)."""
        a = min(max(lo - self.r0, 0), self.rows_local)
        return a, max(a, min(max(hi - self.r0, 0), self.rows_local))

    def _new_local(self) -> torch.Tensor:
        return torch.zeros((self.rows_local, self.n_pad), dtype=self.dtype,
                           device=self.device)

    def _set_unit_diagonal(self, k_loc: torch.Tensor, lo: int = 0) -> None:
        """Ones on the global diagonal of the local rows from global row
        ``lo`` on."""
        a, b = self._span(lo, self.n_pad)
        idx = torch.arange(a, b, device=k_loc.device)
        k_loc[idx, idx + self.r0] = 1.0

    def _upload_rows(self, make_rows, io_rows: int = 4096,
                     root_only: bool = False) -> torch.Tensor:
        """This rank's [rows_local, n_pad] rows, built in bounded chunks:
        ``make_rows(g0, g1)`` returns the global rows [g0, g1) as a float32
        [g1 - g0, n_pad] host array.  Each rank makes its own rows, or,
        with ``root_only``, rank 0 makes every rank's and sends each chunk
        to its owner (the other ranks' ``make_rows`` is never called)."""
        mesh, rl = self.mesh, self.rows_local
        k = self._new_local()
        owners = range(mesh.size) if root_only else [mesh.rank]
        for owner in owners:
            g0 = owner * rl
            for a in range(0, rl, io_rows):
                b = min(a + io_rows, rl)
                if owner != 0 and root_only:
                    if mesh.rank == 0:
                        rows = np.require(make_rows(g0 + a, g0 + b),
                                          np.float32, ["C", "W"])
                        dist.send(torch.from_numpy(rows).to(self.device,
                                                            self.dtype),
                                  dist.get_global_rank(mesh.group, owner),
                                  group=mesh.group)
                    elif mesh.rank == owner:
                        dist.recv(k[a:b], dist.get_global_rank(
                            mesh.group, 0), group=mesh.group)
                    continue
                if mesh.rank != owner:
                    continue
                rows = np.require(make_rows(g0 + a, g0 + b), np.float32,
                                  ["C", "W"])
                k[a:b] = torch.from_numpy(rows).to(self.device, self.dtype)
        return k

    def factorize(self, ks32: Optional[np.ndarray],
                  root_only: bool = False) -> None:
        """Upload this rank's rows of ``ks32`` [n, n] (identity-padded) and
        factor.  With ``root_only`` only rank 0's matrix is read (the other
        ranks may pass None)."""
        n = self.n

        def make_rows(r0, r1):
            out = np.zeros((r1 - r0, self.n_pad), np.float32)
            if r0 < n:
                out[:min(r1, n) - r0, :n] = ks32[r0:min(r1, n)]
            pad = np.arange(max(r0, n), r1)   # identity padding leaves the
            out[pad - r0, pad] = 1.0          # factor of K intact
            return out

        self._factorize_dev(self._upload_rows(make_rows,
                                              root_only=root_only))

    def factorize_scaled(self, k32: Optional[np.ndarray], s32: np.ndarray,
                         root_only: bool = False) -> None:
        """Factor diag(s) K diag(s), each row chunk scaled during upload and
        the scaled diagonal pinned to 1 (``CardFactor.factorize_scaled``);
        ``root_only`` as in :meth:`factorize`."""
        n = self.n

        def make_rows(r0, r1):
            out = np.zeros((r1 - r0, self.n_pad), np.float32)
            if r0 < n:
                hi = min(r1, n)
                out[:hi - r0, :n] = (k32[r0:hi] * s32[r0:hi, None]
                                     * s32[None, :])
            diag = np.arange(r0, r1)          # unit diagonal (rows >= n:
            out[diag - r0, diag] = 1.0        # identity padding)
            return out

        self._factorize_dev(self._upload_rows(make_rows,
                                              root_only=root_only))

    def factorize_device(self, k_dev: torch.Tensor, s32=None) -> None:
        """Factor a Gram that lives on this rank's card ([n, n] float32,
        the same on every rank): the rank copies its rows into its buffer,
        Jacobi-scaled by ``s32`` (host [n] float32) with the scaled
        diagonal pinned to 1 when given.  ``k_dev`` is not modified."""
        n = self.n
        k = self._new_local()
        a, b = self._span(0, n)
        if a < b:
            rows = k_dev[self.r0 + a:self.r0 + b]
            if s32 is not None:
                s = torch.as_tensor(np.asarray(s32, np.float32),
                                    device=k_dev.device)
                rows = rows * s[self.r0 + a:self.r0 + b, None] * s[None, :]
            k[a:b, :n] = rows
        self._set_unit_diagonal(k, 0 if s32 is not None else n)
        self._factorize_dev(k)

    def factorize_padded_scaled(self, k_loc: torch.Tensor,
                                s32: np.ndarray) -> None:
        """Scale this rank's padded [rows_local, n_pad] rows to
        diag(s) K diag(s) in place, pin the diagonal to 1 and factor
        (``CardFactor.factorize_padded_scaled``)."""
        s_pad = np.ones(self.n_pad, np.float32)
        s_pad[:self.n] = s32
        s = torch.as_tensor(s_pad, device=k_loc.device)
        for a in range(0, self.rows_local, 4096):
            b = min(a + 4096, self.rows_local)
            k_loc[a:b].mul_(s[self.r0 + a:self.r0 + b, None] * s[None, :])
        self._set_unit_diagonal(k_loc)
        self._factorize_dev(k_loc)

    @torch.no_grad()
    def _factorize_dev(self, k_loc: torch.Tensor) -> None:
        """Blocked right-looking Cholesky of the row-sharded system whose
        local rows are ``k_loc``, in place (lower triangle read, upper
        triangle zeroed).  Every rank raises ``LinAlgError`` together
        where the system is not positive-definite at its precision."""
        settings.check_precision_on(k_loc.device)
        mesh, bs, n_pad = self.mesh, self.block, self.n_pad
        nb = n_pad // bs
        grow = torch.arange(self.r0, self.r1, device=k_loc.device)
        cols = torch.arange(bs, device=k_loc.device)
        diags = torch.zeros((nb, bs, bs), dtype=k_loc.dtype,
                            device=k_loc.device)
        infos = []
        for kb in range(nb):
            c0, c1 = kb * bs, (kb + 1) * bs
            # 1. the panel column, masked to its lower triangle (where,
            # not a product: above the diagonal may hold NaN), gathered
            pcol = torch.where(grow[:, None] >= c0 + cols[None, :],
                               k_loc[:, c0:c1], 0.0)
            pfull = all_gather_rows(pcol, mesh)
            del pcol
            # 2. the diagonal block on every rank, its upper half rebuilt
            # from the lower: only the lower triangle may be read
            dblk = pfull[c0:c1]
            dblk = torch.tril(dblk) + torch.tril(dblk, -1).mT
            del pfull
            lkk, info = torch.linalg.cholesky_ex(dblk)
            infos.append(info)
            diags[kb] = lkk
            # 3. this rank's rows of the column block: zero above the
            # diagonal block, lkk in it, the solved panel below it
            lo, mid = self._span(c0, c0)[0], self._span(c1, c1)[0]
            k_loc[:lo, c0:c1] = 0.0
            if lo < mid:
                k_loc[lo:mid, c0:c1] = lkk[self.r0 + lo - c0:
                                           self.r0 + mid - c0]
            if c1 == n_pad:
                break
            # the local panel rows (zero above the diagonal block's end),
            # solved into the send buffer of the gather
            x = torch.zeros((self.rows_local, bs), dtype=k_loc.dtype,
                            device=k_loc.device)
            x[mid:] = torch.linalg.solve_triangular(
                lkk.mT, k_loc[mid:, c0:c1], upper=True, left=False)
            k_loc[mid:, c0:c1] = x[mid:]
            # 4. the solved panel, gathered
            xfull = all_gather_rows(x, mesh)
            # 5. the local trailing rows, one column block at a time
            for d0 in range(c1, n_pad, bs):
                a = self._span(d0, d0)[0]
                if a < self.rows_local:
                    k_loc[a:, d0:d0 + bs].addmm_(
                        x[a:], xfull[d0:d0 + bs].mT, alpha=-1.0)
            del x, xfull
        info = torch.stack(infos)
        if mesh.group is not None:
            dist.all_reduce(info, op=dist.ReduceOp.MAX, group=mesh.group)
        bad = torch.nonzero(info).flatten()
        if len(bad):
            kb = int(bad[0])
            raise np.linalg.LinAlgError(
                f"Cholesky of the {n_pad}x{n_pad} {k_loc.dtype} system "
                f"failed in diagonal block {kb} at minor {int(info[kb])} "
                f"(not positive-definite at this precision); add jitter")
        self.l_loc, self.diags = k_loc, diags

    def _agreed_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """``b`` as a fresh contiguous tensor in the factor's dtype, holding
        rank 0's values on every rank."""
        return broadcast_(b.to(self.device, self.dtype, copy=True)
                          .contiguous(), self.mesh)

    def _forward(self, b: torch.Tensor) -> torch.Tensor:
        """``L^-1 b`` in place for a replicated ``b`` [r, m], r in
        [n, n_pad] (the leading r rows of the padded system): one
        ``all_gather`` of the ranks' [rows_local, m] contributions per
        block step."""
        bs, r, m = self.block, b.shape[0], b.shape[1]
        for c0 in range(0, r, bs):
            c1 = min(c0 + bs, r)
            d = self.diags[c0 // bs, :c1 - c0, :c1 - c0]
            yk = torch.linalg.solve_triangular(d, b[c0:c1], upper=False)
            b[c0:c1] = yk
            if c1 < r:
                lo, hi = self._span(c1, r)
                part = torch.zeros((self.rows_local, m), dtype=b.dtype,
                                   device=b.device)
                if lo < hi:
                    part[lo:hi] = self.l_loc[lo:hi, c0:c1] @ yk
                b[c1:] -= all_gather_rows(part, self.mesh)[c1:r]
        return b

    def _backward(self, y: torch.Tensor) -> torch.Tensor:
        """``L^-T y`` in place for a replicated ``y`` [r, m]: one
        ``all_reduce`` of [block, m] per block step."""
        bs, r = self.block, y.shape[0]
        for c0 in reversed(range(0, r, bs)):
            c1 = min(c0 + bs, r)
            if c1 < r:
                lo, hi = self._span(c1, r)
                part = torch.zeros((c1 - c0, y.shape[1]), dtype=y.dtype,
                                   device=y.device)
                if lo < hi:
                    part += (self.l_loc[lo:hi, c0:c1].mT
                             @ y[self.r0 + lo:self.r0 + hi])
                y[c0:c1] -= all_reduce_sum_(part, self.mesh)
            d = self.diags[c0 // bs, :c1 - c0, :c1 - c0]
            y[c0:c1] = torch.linalg.solve_triangular(d.mT, y[c0:c1],
                                                     upper=True)
        return y

    @torch.no_grad()
    def solve_dev(self, b: torch.Tensor) -> torch.Tensor:
        """``(L L^T)^-1 b`` for ``b`` [r, m] on the rank's device (rank 0's
        ``b`` on every rank); a new tensor, the same on every rank."""
        settings.check_precision_on(self.device)
        return self._backward(self._forward(self._agreed_rhs(b)))

    def solve(self, rhs: np.ndarray) -> np.ndarray:
        """``(L L^T)^-1 rhs`` for host ``rhs`` [n, nrhs] (rank 0's)."""
        b = torch.as_tensor(np.asarray(rhs), device=self.device)
        return self.solve_dev(b).cpu().numpy()

    @torch.no_grad()
    def forward_sumsq(self, w: torch.Tensor) -> torch.Tensor:
        """``sum((L^-1 W) ** 2, axis=0)`` for ``W`` [n, m] (or [n_pad, m]),
        rank 0's ``W`` on every rank."""
        settings.check_precision_on(self.device)
        v = self._forward(self._agreed_rhs(w))
        return (v * v).sum(0)

    def log_diag_sum(self) -> float:
        """``sum(log(diag(L)))`` over the padded factor, from the
        replicated diagonal blocks, accumulated in float64 on the host."""
        if self.diags is None:
            raise RuntimeError("factorize before log_diag_sum")
        d = self.diags.diagonal(dim1=1, dim2=2).cpu().numpy()
        return float(np.sum(np.log(d.astype(np.float64))))

    def diag_blocks(self) -> torch.Tensor:
        """The replicated [n_pad / block, block, block] diagonal blocks."""
        return self.diags

    def _check_factored(self) -> None:
        if self.l_loc is None:
            raise RuntimeError("factorize before extend")

    _check_capacity = CardFactor._check_capacity

    def extend(self, b_scaled: np.ndarray, c_scaled: np.ndarray) -> None:
        """``CardFactor.extend`` across the ranks (rank 0's blocks): a
        replicated forward solve gives ``y = L^-1 B^T``, every rank takes
        the [m, m] Cholesky of ``C - y^T y``, the positive-definiteness
        gate is agreed before any write (a refused extension leaves every
        rank's factor as it was, bit for bit), each rank writes the new
        rows it holds, and the diagonal blocks the new rows touch are
        rebuilt from the replicated ``y`` and ``L22`` (a block that
        straddles two ranks needs no collective)."""
        self._check_factored()
        b_scaled = np.asarray(b_scaled, np.float32)
        c_scaled = np.asarray(c_scaled, np.float32)
        m, nb_cols = b_scaled.shape
        if nb_cols != self.n or c_scaled.shape != (m, m):
            raise ValueError((b_scaled.shape, c_scaled.shape, self.n))
        self._check_capacity(m)
        rhs = torch.from_numpy(np.ascontiguousarray(b_scaled)).to(
            self.device, self.dtype).T
        self._extend_core(rhs, torch.from_numpy(c_scaled))

    def extend_device(self, w: torch.Tensor, c_scaled: torch.Tensor) -> None:
        """``CardFactor.extend_device`` across the ranks: ``w`` [n_pad, m]
        and ``c_scaled`` [m, m] on the rank's card (rank 0's are used;
        neither is modified)."""
        self._check_factored()
        m = w.shape[1]
        if w.shape != (self.n_pad, m) or c_scaled.shape != (m, m):
            raise ValueError((tuple(w.shape), tuple(c_scaled.shape),
                              self.n_pad))
        self._check_capacity(m)
        self._extend_core(w[:self.n], c_scaled)

    def _new_rows(self, y, l22, g0: int, g1: int, c0: int, c1: int):
        """The new factor rows [g0, g1) (in [n, n + m)) over the columns
        [c0, c1): ``y^T`` left of column n, ``tril(L22)`` from it."""
        n0, m = self.n, l22.shape[0]
        out = torch.zeros((g1 - g0, c1 - c0), dtype=self.dtype,
                          device=self.device)
        if c0 < n0:
            out[:, :min(c1, n0) - c0] = y[c0:min(c1, n0), g0 - n0:g1 - n0].mT
        a, e = max(c0, n0), min(c1, n0 + m)
        if a < e:
            out[:, a - c0:e - c0] = torch.tril(l22)[g0 - n0:g1 - n0,
                                                    a - n0:e - n0]
        return out

    @torch.no_grad()
    def _extend_core(self, rhs: torch.Tensor, c: torch.Tensor) -> None:
        """``rhs`` [n, m] holds ``B^T``, ``c`` [m, m] holds C."""
        settings.check_precision_on(self.device)
        n0, m, bs = self.n, rhs.shape[1], self.block
        y = self._forward(self._agreed_rhs(rhs))
        c = self._agreed_rhs(c)
        l22, info = torch.linalg.cholesky_ex(c - y.T @ y)
        d = l22.diagonal()
        bad = (int(info) != 0 or not bool(torch.isfinite(d).all())
               or bool((d <= 0).any()))
        # the gate is agreed BEFORE any write, so that every rank raises
        # with its factor untouched
        if any_rank(bad, self.mesh):
            raise ValueError(
                "extend: the Schur complement of the new rows is not "
                "positive-definite in float32 (duplicate or near-duplicate "
                "training points, or zero jitter?); the live factor is "
                "unchanged")
        a, b = self._span(n0, n0 + m)
        if a < b:
            g0 = self.r0 + a
            self.l_loc[a:b] = self._new_rows(y, l22, g0, g0 + b - a, 0,
                                             self.n_pad)
        for kb in range(n0 // bs, (n0 + m - 1) // bs + 1):
            c0 = kb * bs
            g0, g1 = max(n0, c0), min(n0 + m, c0 + bs)
            self.diags[kb, g0 - c0:g1 - c0] = self._new_rows(
                y, l22, g0, g1, c0, c0 + bs)
        self.n = n0 + m

    def gather(self) -> torch.Tensor:
        """The whole [n_pad, n_pad] factor on every rank (for tests)."""
        return all_gather_rows(self.l_loc, self.mesh)


def _mesh_device(device, mesh: Optional[Mesh]) -> torch.device:
    """The device an entry point computes on: the mesh's when one is
    passed (``device``, if given too, must be it), else ``device``."""
    if mesh is None:
        if device is None:
            raise TypeError("pass device= (or mesh= for the sharded factor)")
        return torch.device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _factor_for(n: int, block: int, device, mesh: Optional[Mesh], **kw):
    """``ShardedFactor`` on ``mesh`` when one is passed (even a world of
    one), else ``CardFactor`` on ``device``."""
    device = _mesh_device(device, mesh)
    if mesh is None:
        return CardFactor(n, block, device=device, **kw)
    return ShardedFactor(mesh, n, block, **kw)


def cholesky_sharded(k: np.ndarray, mesh: Optional[Mesh] = None,
                     block: int = 512) -> np.ndarray:
    """The lower factor of an SPD matrix by the row-sharded blocked
    Cholesky, gathered to every rank (float32, on the host).  For tests:
    the solvers keep the factor sharded."""
    mesh = make_mesh() if mesh is None else mesh
    f = ShardedFactor(mesh, k.shape[0], block)
    f.factorize(np.asarray(k, np.float32))
    n = k.shape[0]
    return np.tril(f.gather()[:n, :n].cpu().numpy())


def cholesky_solve_sharded(k: np.ndarray, rhs: np.ndarray,
                           mesh: Optional[Mesh] = None,
                           block: int = 512) -> np.ndarray:
    """One-shot float32 sharded factor and solve (no refinement).  For
    tests."""
    mesh = make_mesh() if mesh is None else mesh
    f = ShardedFactor(mesh, k.shape[0], block)
    f.factorize(np.asarray(k, np.float32))
    return f.solve(np.asarray(rhs, np.float32))


def _root_residual(residual, mesh: Optional[Mesh]):
    """``residual`` evaluated on rank 0 alone, its ``(r, rel)`` handed to
    every rank: the refinement stops are then taken from the same bits on
    every rank (a host float64 residual may differ across processes in its
    last bits).  The other ranks' ``residual`` is never called."""
    if mesh is None:
        return residual

    def agreed(a):
        r, rel = residual(a) if mesh.rank == 0 else (None, None)
        return broadcast_array(r, mesh), agree(rel, mesh)

    return agreed


def chol_solve_dist(kxx: Optional[np.ndarray], y: np.ndarray,
                    jitter: float = 0.0, block: int = 1024,
                    refine_iters: int = 20, tol: float = 1e-10, k_dev=None,
                    *, device=None, mesh: Optional[Mesh] = None):
    """Solve (Kxx + jitter I) A = Y: float32 blocked Cholesky + float64
    iterative refinement, on ``device`` (``CardFactor``) or row-sharded
    over ``mesh`` (``ShardedFactor``).

    ``kxx`` must be the full (symmetrised) matrix; it is consumed
    (equilibrated in place).  With a group only rank 0's ``kxx`` is read
    (the other ranks may pass None), each rank uploads its rows, and rank
    0 computes the residuals.  Returns ``(A, rel_residual,
    refinement_iterations)`` on every rank; ``rel_residual`` is the float64
    relative residual of the equilibrated system the factor decomposed.
    ``refine_iters`` is a cap: refinement stops at ``tol`` or when it
    stops improving."""
    y64 = np.asarray(y, np.float64)
    n = y64.shape[0]
    factor = _factor_for(n, block, device, mesh)
    s = ys = None
    if is_root(mesh):
        kxx = np.asarray(kxx)
        # Jacobi equilibration in float64, in place: D^-1/2 (K+jI) D^-1/2
        if kxx.dtype != np.float64:
            kxx = kxx.astype(np.float64)
        kxx.flat[:: n + 1] += jitter
        s = 1.0 / np.sqrt(kxx.flat[:: n + 1])
        kxx *= s[:, None]
        kxx *= s[None, :]
        ys = s[:, None] * y64
    if mesh is not None:
        s, ys = broadcast_array(s, mesh), broadcast_array(ys, mesh)

    if k_dev is not None:
        # the raw Gram already lives on the card: scale it there
        factor.factorize_device(k_dev, s32=s.astype(np.float32))
    elif mesh is None:
        factor.factorize(kxx.astype(np.float32))
    else:
        factor.factorize(kxx.astype(np.float32) if mesh.rank == 0 else None,
                         root_only=True)

    # jitter is already folded into kxx's diagonal (scaled space)
    residual = _root_residual(
        _blocked_residual_fn(kxx, ys, 0.0) if is_root(mesh) else None, mesh)

    def precond(r64):
        return factor.solve(r64.astype(np.float32)).astype(np.float64)

    best_a, best_rel, iters = _ir_solve(precond, residual, ys,
                                        refine_iters, tol)
    return s[:, None] * best_a, best_rel, iters


def variances_from_cross_host(factor, s: np.ndarray,
                              kzx: Optional[np.ndarray],
                              kzz: Optional[np.ndarray],
                              chunk: int = 512) -> np.ndarray:
    """GP posterior variances for host-resident cross covariances through
    a live equilibrated factor (``CardFactor`` or ``ShardedFactor``):
    ``var_z = k_zz - ||L^-1 (s * k_xz)||^2``, by forward substitution over
    bounded column chunks.  ``s`` is the factor's Jacobi scaling (float64
    [n]); the accuracy floor is the float32 factor (~eps32 * k_zz).  With
    a ``ShardedFactor`` only rank 0's ``kzx`` and ``kzz`` are read (the
    other ranks may pass None) and every rank returns rank 0's
    variances."""
    mesh = getattr(factor, "mesh", None)
    root = is_root(mesh)
    n = factor.n
    nz = len(kzx) if root else None
    if mesh is not None:
        nz = agree(nz, mesh)
    sums = np.empty(nz, np.float64)
    for c0 in range(0, nz, chunk):
        hi = min(c0 + chunk, nz)
        if root:
            w = torch.from_numpy((s[:, None] * np.asarray(
                kzx[c0:hi], np.float64).T).astype(np.float32))
        else:                       # the sharded solve takes rank 0's
            w = torch.empty((n, hi - c0), dtype=torch.float32)
        sums[c0:hi] = factor.forward_sumsq(w.to(factor.device)).cpu().numpy()
    var = (np.maximum(np.asarray(kzz, np.float64) - sums, 0.0) if root
           else None)
    return var if mesh is None else broadcast_array(var, mesh)


def evidence_from_factor(factor, s: np.ndarray,
                         y64: np.ndarray, alpha: np.ndarray) -> float:
    """GP log evidence from a live equilibrated factor (``CardFactor`` or
    ``ShardedFactor``): with ``M = S K' S`` (S = diag(s),
    K' = K + jitter I), ``logdet K' = 2 sum log diag(L_M) - 2 sum log s``;
    the quadratic form reuses the solved ``alpha``.  Float64 oracle:
    ``ops.solve.log_marginal_likelihood``."""
    logdet = 2.0 * factor.log_diag_sum() - 2.0 * float(np.sum(np.log(s)))
    n, n_cls = y64.shape
    return float(-0.5 * np.sum(y64 * alpha) - 0.5 * n_cls * logdet
                 - 0.5 * n * n_cls * np.log(2.0 * np.pi))


def _scaled_precond(factor, s):
    """Scaled-space correction solve: ``s * solve(s * r)``."""
    def precond(r64):
        return s[:, None] * factor.solve(
            (s[:, None] * r64).astype(np.float32)).astype(np.float64)
    return precond


def chol_solve_ir32(k32: Optional[np.ndarray], y: np.ndarray,
                    jitter: float = 0.0, block: int = 1024,
                    refine_iters: int = 20, tol: float = 1e-10,
                    io_rows: int = 8192, k_dev=None,
                    return_factor: bool = False, *, device=None,
                    mesh: Optional[Mesh] = None):
    """Memory-lean variant: solve (K + jitter I) A = Y where ``k32`` is the
    full symmetrised float32 matrix (as the Gram store holds it), on
    ``device`` or row-sharded over ``mesh``.

    Never materialises a float64 copy: the factor is built from scaled
    row-chunk uploads, and refinement residuals are computed blockwise in
    float64 upcasts of the float32 rows, so the result solves the float64
    embedding of the float32 data to ``tol``.  With a group only rank 0's
    ``k32`` is read, as in :func:`chol_solve_dist`.

    With ``return_factor=True`` returns ``(a, rel, iters, factor, s)``: the
    live factor and its float64 Jacobi scalings, for
    `variances_from_cross_host` and `evidence_from_factor`."""
    y64 = np.asarray(y, np.float64)
    n = y64.shape[0]
    factor = _factor_for(n, block, device, mesh)
    d64 = None
    if is_root(mesh):
        assert k32.dtype == np.float32, k32.dtype
        d64 = (np.ascontiguousarray(np.diagonal(k32)).astype(np.float64)
               + jitter)
    if mesh is not None:
        d64 = broadcast_array(d64, mesh)
    s = 1.0 / np.sqrt(d64)
    s32 = s.astype(np.float32)

    if k_dev is not None:
        factor.factorize_device(k_dev, s32=s32)
    elif mesh is None:
        factor.factorize_scaled(k32, s32)
    else:
        factor.factorize_scaled(k32, s32, root_only=True)

    residual = _root_residual(
        _blocked_residual_fn(k32, y64, jitter, io_rows=io_rows)
        if is_root(mesh) else None, mesh)
    a, rel, iters = _ir_solve(_scaled_precond(factor, s), residual, y64,
                              refine_iters, tol)
    if return_factor:
        return a, rel, iters, factor, s
    return a, rel, iters


def _refuse_holes(name: str):
    raise RuntimeError(
        f"{name} has NaN holes (incomplete or unmerged assembly?); rerun "
        f"assembly — tile-level resume will skip finished tiles")


def chol_solve_dist_from_store(store, name: str, y: np.ndarray,
                               jitter: float = 0.0, block: int = 1024,
                               check_finite: bool = False, *, device=None,
                               mesh: Optional[Mesh] = None, **kw):
    """Read the upper-triangle Gram from the store as float32, mirror it,
    and solve with ``chol_solve_ir32`` (the float64 Gram is never
    materialised).  Extra keyword arguments (e.g. ``return_factor=True``)
    pass through.  ``check_finite=True`` refuses a NaN-holed Gram (an
    unmerged worker shard) from the in-memory copy.  With a group, rank 0
    alone reads the store (the other ranks' ``store`` is never touched)."""
    from ..ops.solve import symmetrize_from_upper
    k32 = holes = None
    if is_root(mesh):
        k32 = symmetrize_from_upper(store.read(name))   # ONE float32 copy
        holes = bool(check_finite and np.isnan(k32).any())
    if mesh is not None:
        holes = agree(holes, mesh)
    if holes:
        _refuse_holes(name)
    return chol_solve_ir32(k32, y, jitter=jitter, block=block,
                           device=device, mesh=mesh, **kw)


_TRIL_IDX_CACHE = {}


def _mirror_rows_tiled(k32, r0: int, r1: int, ts: int = 1024) -> None:
    """Fill the lower-triangle columns of rows [r0:r1) from the upper
    triangle already resident in ``k32`` (rows [0:r1) read so far), in
    [ts, ts] transposed tiles (cache-resident runs; much faster than one
    strided ``.T`` assignment)."""
    # cross-block: [r0:r1, :r0] from [:r0, r0:r1].T
    for j0 in range(0, r0, ts):
        j1 = min(j0 + ts, r0)
        k32[r0:r1, j0:j1] = k32[j0:j1, r0:r1].T
    # in-block: strictly-lower tiles from their upper mirrors
    for i0 in range(r0, r1, ts):
        i1 = min(i0 + ts, r1)
        for j0 in range(r0, i0, ts):
            j1 = min(j0 + ts, r1)
            k32[i0:i1, j0:j1] = k32[j0:j1, i0:i1].T
        d = k32[i0:i1, i0:i1]              # diagonal tile
        m = i1 - i0
        il = _TRIL_IDX_CACHE.get(m)
        if il is None:
            il = np.tril_indices(m, -1)
            _TRIL_IDX_CACHE[m] = il
        d[il] = d.T[il]


def chol_solve_stream_from_store(store, name: str, y: np.ndarray,
                                 jitter: float = 0.0, block: int = 1024,
                                 io_rows: int = 8192,
                                 refine_iters: int = 20, tol: float = 1e-10,
                                 check_finite: bool = True,
                                 return_factor: bool = False,
                                 verbose: bool = False, *, device=None,
                                 mesh: Optional[Mesh] = None):
    """Streamed store solve: a producer thread reads row blocks out of the
    store and mirrors each block's upper triangle down as it lands (rows
    complete top to bottom), while this thread uploads completed rows into
    the factor's buffer.  The NaN refusal is one reduce over the uploaded
    buffer, and the Jacobi scaling is applied on the card once the whole
    diagonal has streamed past (``factorize_padded_scaled``).  The same
    float64 host residual and refinement loop as
    `chol_solve_dist_from_store` then drive the solution to ``tol``.  With
    a group, rank 0 alone reads the store and sends each rank its rows as
    they complete; the ranks agree on the NaN refusal.

    Returns ``(a, rel, iters)`` or, with ``return_factor``,
    ``(a, rel, iters, factor, s)`` as `chol_solve_ir32`."""
    root = is_root(mesh)
    y64 = np.asarray(y, np.float64)
    n, err = len(y64), None
    if root:
        shape = tuple(store.shape(name))
        if shape[0] != shape[1] or shape[0] != n:
            err = f"{name} is not square with {n} rows: {shape}"
    if mesh is not None:
        err = agree(err, mesh)
    if err:
        raise ValueError(err)
    factor = _factor_for(n, block, device, mesh)
    n_pad = factor.n_pad
    k32 = np.empty((n, n), np.float32) if root else None  # for residuals

    cond = threading.Condition()
    done_rows = [0]
    fail = []

    def producer():
        try:
            for r0 in range(0, n, io_rows):
                r1 = min(r0 + io_rows, n)
                store.read_rows(name, r0, r1, out=k32[r0:r1])
                _mirror_rows_tiled(k32, r0, r1)
                with cond:
                    done_rows[0] = r1
                    cond.notify_all()
        except BaseException as e:          # surfaced in the consumer
            fail.append(e)
            with cond:
                done_rows[0] = n
                cond.notify_all()

    def make_rows(r0, r1):
        need = min(r1, n)
        with cond:
            while done_rows[0] < need:
                cond.wait()
        if fail:
            raise fail[0]
        out = np.zeros((r1 - r0, n_pad), np.float32)
        if r0 < n:
            hi = min(r1, n)
            out[:hi - r0, :n] = k32[r0:hi]
        pad = np.arange(max(r0, n), r1)     # identity padding rows only:
        out[pad - r0, pad] = 1.0            # real rows scale on the card
        return out

    t0 = time.perf_counter()
    if root:
        th = threading.Thread(target=producer, daemon=True)
        th.start()
    try:
        if mesh is None:
            k_dev = factor._upload_rows(make_rows)
        else:
            k_dev = factor._upload_rows(make_rows, root_only=True)
    finally:
        if root:
            th.join()
    if fail:
        raise fail[0]
    holes = check_finite and bool(torch.isnan(k_dev).any())
    if mesh is not None:
        holes = any_rank(holes, mesh)
    if holes:
        _refuse_holes(name)
    if verbose and root:
        print(f"[stream] read+mirror+upload overlapped: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

    d64 = (np.ascontiguousarray(np.diagonal(k32)).astype(np.float64)
           + jitter) if root else None
    if mesh is not None:
        d64 = broadcast_array(d64, mesh)
    s = 1.0 / np.sqrt(d64)
    factor.factorize_padded_scaled(k_dev, s.astype(np.float32))

    residual = _root_residual(
        _blocked_residual_fn(k32, y64, jitter, io_rows=io_rows)
        if root else None, mesh)
    a, rel, iters = _ir_solve(_scaled_precond(factor, s), residual, y64,
                              refine_iters, tol)
    if return_factor:
        return a, rel, iters, factor, s
    return a, rel, iters

"""Large-N GP classification with the Gram never leaving the card.

PyTorch counterpart of ``cnn_gp_tpu/parallel/device_large.py``, on one
card:

* the Jacobi-equilibrated Gram ``M = D^-1/2 (K + jr I) D^-1/2`` (unit
  diagonal) is assembled, lower tiles only, straight into the
  [n_pad, n_pad] float32 buffer that ``chol_dist.CardFactor`` then
  factors in place: the peak is one N_pad^2 float32 plus bounded
  transients;
* iterative-refinement residuals come from a matvec against a matrix that
  is never materialised: each scaled tile is regenerated and contracted
  at once with the current solution (the tile and its mirror), so a
  refinement sweep costs one Gram pass and no memory;
* the default ``residual_check="sampled"`` measures the residual exactly
  on a seeded random sample of block-rows and pays the full sweep only
  when that estimate's upper confidence bound (or its max-row statistic)
  does not clear ``tol``;
* scores ``Kzx @ A`` and posterior variances are computed the same way,
  by tile regeneration, so the cross Grams are never resident.

Every tile goes through ``parallel.gram._tile_body``, so the tiles of a
ConvNet-GP model run on the CUDA megakernel.  Nothing is padded at the
tile level (the JAX package pads inputs to a multiple of the tile size for
XLA's static shapes): ragged edge tiles are sliced.  Only the factor
buffer carries identity pad rows, in the JAX package's geometry.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import settings
from ..ops import megakernel
from ..ops import solve as solve_ops
from . import scheduler
from .chol_dist import CardFactor
from .gram import _on_device, _tile_body, compute_gram_diag

__all__ = ["classify_device_large", "gram_matvec_regen", "scores_regen",
           "make_scores_fn", "rebuild_factor", "variances_from_factor"]

_CROSS_BLOCK = 512    # query columns per whitened cross-covariance block


def _lower_offsets(n: int, b: int):
    """(i0, j0) offsets of the lower tile triangle (i0 >= j0): all the
    blocked factor reads."""
    nt = -(-n // b)
    return [(i * b, j * b) for i in range(nt) for j in range(i + 1)]


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


def _identity(n_pad: int, device) -> torch.Tensor:
    k = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=device)
    k.diagonal().fill_(1.0)
    return k


@torch.no_grad()
def _assemble_scaled(model, x_all, s, b, n, n_pad) -> torch.Tensor:
    """The scaled, identity-padded system matrix: its lower tile triangle
    (with the diagonal) written into a fresh [n_pad, n_pad] float32 buffer
    whose rows and columns in [n, n_pad) are an exact identity block.  The
    upper triangle is not written: the factor does not read it."""
    spec = megakernel.match(model)
    k = _identity(n_pad, x_all.device)
    for i0, j0 in _lower_offsets(n, b):
        blk = _scaled_tile(model, spec, x_all, s, i0, j0, b)
        k[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
    return k


def _matvec_scan(model, x_all, s, a_dev, b, n) -> torch.Tensor:
    """M @ a by regenerating the upper tiles: each tile adds its own
    contribution and its mirror's (none on the diagonal)."""
    spec = megakernel.match(model)
    out = torch.zeros_like(a_dev)
    for i0, j0 in scheduler.tile_offsets(n, n, b, True):
        blk = _scaled_tile(model, spec, x_all, s, i0, j0, b)
        bi, bj = blk.shape
        out[i0:i0 + bi] += blk @ a_dev[j0:j0 + bj]
        if i0 != j0:
            out[j0:j0 + bj] += blk.T @ a_dev[i0:i0 + bi]
    return out


def _rows_matvec(model, x_all, s, a_dev, rows_idx, b, n) -> torch.Tensor:
    """Selected block-rows of M @ a by tile regeneration: the compacted
    [len(rows_idx) * b, nrhs] rows in the order of ``rows_idx`` (rows past
    n in a short last block stay zero).  Cost is ``len(rows_idx) / nt`` of
    a full `_matvec_scan` sweep."""
    spec = megakernel.match(model)
    out = torch.zeros((len(rows_idx) * b, a_dev.shape[1]),
                      dtype=torch.float32, device=a_dev.device)
    for pos, i in enumerate(rows_idx):
        i0 = int(i) * b
        for j0 in range(0, n, b):
            blk = _scaled_tile(model, spec, x_all, s, i0, j0, b)
            bi, bj = blk.shape
            out[pos * b:pos * b + bi] += blk @ a_dev[j0:j0 + bj]
    return out


def _sample_row_blocks(nt_n: int, k: int, seed: int) -> np.ndarray:
    """k distinct block indices out of [0, nt_n), drawn uniformly without
    replacement from the seed (numpy's ``default_rng``, so the draw equals
    the JAX package's for the same seed)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(nt_n, size=min(k, nt_n), replace=False)
                   .astype(np.int64))


def _sample_block_count(n: int, b: int, sample_rows: int) -> int:
    """Block-rows `_sampled_residual` will measure."""
    return min(-(-n // b), max(1, -(-sample_rows // b)))


def _sampled_residual(model, x_all, s, a64, ys, y_norm, b, n,
                      sample_rows: int, seed: int):
    """Row-sampled estimate of the scaled-space relative residual
    ``max_c ||ys - M a||_c / ||ys||_c``: the residual measured exactly on a
    seeded sample of block-rows, its norm scaled by ``sqrt(n /
    n_sampled)``.  Returns ``(rel, rel_ucb, max_ratio, rows_idx)``:

    * ``rel``: the point estimate;
    * ``rel_ucb``: the estimate with the across-block mean square inflated
      by 3 standard errors, the spread measured over FULL sampled blocks
      only (a short last block is a fewer-row draw); ``inf`` with fewer
      than 2 full blocks;
    * ``max_ratio``: the largest per-row squared residual over the sampled
      rows divided by their median (a localized error drives it up);
    * ``rows_idx``: the sampled block indices."""
    nt_n = -(-n // b)
    k = _sample_block_count(n, b, sample_rows)
    rows_idx = _sample_row_blocks(nt_n, k, seed)
    a_dev = torch.as_tensor(np.asarray(a64, np.float32), device=x_all.device)
    ma = _rows_matvec(model, x_all, s, a_dev, rows_idx, b, n).cpu().numpy(
    ).astype(np.float64).reshape(len(rows_idx), b, -1)
    n_j = np.minimum(b, n - rows_idx * b)              # rows per block
    r2 = np.zeros((len(rows_idx), b, ys.shape[1]), np.float64)
    for pos, (i, nr) in enumerate(zip(rows_idx, n_j)):
        i0 = int(i) * b
        r2[pos, :nr] = np.square(ys[i0:i0 + nr] - ma[pos, :nr])
    # max-per-row statistic over the sampled rows
    row_ss = np.concatenate([r2[pos, :nr].sum(axis=1)
                             for pos, nr in enumerate(n_j)])
    med = float(np.median(row_ss))
    mx = float(row_ss.max(initial=0.0))
    if med > 0.0:
        max_ratio = mx / med
    else:                       # all-zero residual rows: nothing localized
        max_ratio = float("inf") if mx > 0.0 else 1.0
    # per-block per-row mean-square residual: one draw per sampled block
    full = n_j == b
    s_jc = r2.sum(axis=1)[full] / b                    # [k_full, C]
    mu = r2.sum(axis=(0, 1)) / int(n_j.sum())          # == (scale*||r||)²/n
    rel = float(np.max(np.sqrt(n * mu) / y_norm))
    k_full = int(full.sum())
    if k_full < 2:                                     # no spread estimate
        return rel, float("inf"), max_ratio, rows_idx  # -> always escalate
    se = s_jc.std(axis=0, ddof=1) / np.sqrt(k_full)
    rel_ucb = float(np.max(np.sqrt(n * (mu + 3.0 * se)) / y_norm))
    return rel, rel_ucb, max_ratio, rows_idx


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


@torch.no_grad()
def gram_matvec_regen(model, X, a: np.ndarray, *, batch_size: int = 128,
                      s: Optional[np.ndarray] = None,
                      device) -> np.ndarray:
    """K(X, X) @ a (or the scaled, diagonal-pinned M @ a when ``s`` is
    given) by regenerating Gram tiles, O(N * nrhs) memory."""
    if s is None:  # raw kernel: unit scaling, diagonal not pinned
        return scores_regen(model, X, X, a, batch_size=batch_size,
                            device=device)
    device = torch.device(device)
    settings.check_precision_on(device)
    x_all = _on_device(X, device)
    s_dev = torch.as_tensor(np.asarray(s, np.float32), device=device)
    a_dev = torch.as_tensor(np.asarray(a, np.float32), device=device)
    return _matvec_scan(model, x_all, s_dev, a_dev, batch_size,
                        len(x_all)).cpu().numpy()


@torch.no_grad()
def rebuild_factor(model, train_x, scalings, *, batch_size: int = 128,
                   block: int = 2048, device):
    """Reassemble the equilibrated system a prior solve factored (``M``,
    unit diagonal, fixed by the Jacobi ``scalings``) straight into the
    factor buffer and refactor it: assembly and factor only, no solve.

    Returns ``(factor, x_all, s_dev)``, the triple
    :func:`variances_from_factor` consumes."""
    device = torch.device(device)
    settings.check_precision_on(device)
    x_all = _on_device(train_x, device)
    n, b = len(x_all), batch_size
    s = torch.as_tensor(np.asarray(scalings, np.float32), device=device)
    factor = CardFactor(n, block, pad_to=b, device=device)
    factor._factorize_dev(_assemble_scaled(model, x_all, s, b, n,
                                           factor.n_pad))
    return factor, x_all, s


@torch.no_grad()
def variances_from_factor(factor: CardFactor, model, x_all: torch.Tensor,
                          s_dev: torch.Tensor, xz, b: int, n: int, snap,
                          a_scaled: Optional[np.ndarray] = None):
    """GP posterior variances ``k_zz - || L^-1 (s * k_xz) ||^2`` for one
    query split through a live factor of M (empty-split safe).  ``k_zz``
    comes from ``compute_gram_diag`` per batch; the scaled cross
    columns are built per [n, 512] block and never exist in full.  Accuracy
    is the float32 accumulation floor, about eps32 * k_zz absolute.

    With ``a_scaled`` (the [n, C] scaled solution ``alpha / s``), the query
    scores ``K_zx @ alpha`` ride the same cross blocks
    (``(s * K_xz)^T (alpha / s)``) and ``(variances, scores)`` is returned.

    ``snap`` is the settings snapshot the factor was built under; the cross
    columns must come from the same kernel, so another snapshot is
    refused."""
    if snap != settings.snapshot():
        raise ValueError(f"the factor was rebuilt under settings {snap} "
                         f"but this process now has {settings.snapshot()}")
    if not n == len(x_all) == factor.n == len(s_dev):
        raise ValueError(f"n={n} but x_all has {len(x_all)} rows, s_dev "
                         f"{len(s_dev)} and the factor {factor.n}")
    if len(xz) == 0:
        empty = np.zeros(0, np.float64)
        if a_scaled is None:
            return empty
        return empty, np.zeros((0, a_scaled.shape[1]), np.float32)
    device = x_all.device
    settings.check_precision_on(device)
    z_all = _on_device(xz, device)
    mz = len(z_all)
    kzz = compute_gram_diag(model, z_all, device=device, batch_size=b,
                            progress=False).astype(np.float64)
    a_dev = (None if a_scaled is None else torch.as_tensor(
        np.asarray(a_scaled, np.float32), device=device))
    spec = megakernel.match(model)
    # column blocks: a multiple of the tile size, at least one tile
    cb = max(b, (_CROSS_BLOCK // b) * b)
    sumsq = torch.empty(mz, dtype=torch.float32, device=device)
    sc = (None if a_dev is None else torch.empty(
        (mz, a_dev.shape[1]), dtype=torch.float32, device=device))
    for c0 in range(0, mz, cb):
        z_blk = z_all[c0:c0 + cb]
        w = torch.empty((n, len(z_blk)), dtype=torch.float32, device=device)
        for i0, j0 in scheduler.tile_offsets(n, len(z_blk), b, False):
            blk = _tile_body(model, spec, x_all, z_blk, i0, j0, b, False)
            bi, bj = blk.shape
            w[i0:i0 + bi, j0:j0 + bj] = blk * s_dev[i0:i0 + bi, None]
        if sc is not None:
            sc[c0:c0 + len(z_blk)] = w.T @ a_dev
        sumsq[c0:c0 + len(z_blk)] = factor.forward_sumsq(w)
        del w
    var = np.maximum(kzz - sumsq.cpu().numpy(), 0.0)
    return var if sc is None else (var, sc.cpu().numpy())


@torch.no_grad()
def classify_device_large(model, train_x, train_y, *splits,
                          batch_size: int = 128, block: int = 2048,
                          jitter: float = 0.0, refine_iters: int = 1,
                          tol: Optional[float] = None,
                          variances: bool = False,
                          residual_check: str = "sampled",
                          residual_sample_rows: int = 1024,
                          residual_accept_frac: float = 1.0,
                          residual_sample_seed: Optional[int] = None,
                          residual_max_row_gate: float = 50.0,
                          verbose: bool = True, device):
    """GP classification at scales where nothing N^2 may leave the card.

    ``splits`` are (x, labels) pairs.  Returns ``(accuracies, info)``,
    with the info keys of the JAX function: the scaled-space relative
    residual and how it was measured, the refinement count, predictions,
    scores, optional variances, the log evidence and log-determinant, the
    posterior (``alpha``, ``scalings``, ``jitter_raw``) and the phase
    timings; and one key of the port's own, ``peak_bytes``: the peak card
    memory of each timed phase (empty off the card).

    ``refine_iters`` caps the refinement sweeps (each costs one Gram
    pass); ``tol`` defaults to ``3 sqrt(N) eps32``, the measured floor of
    the float32 regeneration matvec.  ``residual_check="sampled"`` (the
    default) accepts the solve without a full sweep when the sampled
    estimate's +3-SE bound clears ``residual_accept_frac * tol`` and the
    max-row statistic stays under ``residual_max_row_gate``; otherwise it
    escalates to the exact check and the refinement loop, so corrections
    always come from exact residuals.  ``residual_check="full"`` always
    pays the exact sweep.  ``residual_sample_seed`` (None: a fresh seed,
    recorded in ``info``) fixes the sampled block-rows.  A residual
    confined to a few block-rows is caught with probability about
    ``2k / nt`` per run (k sampled of nt block-rows).

    ``jitter`` is RELATIVE to the mean Gram diagonal: the system solved is
    ``K + jitter * mean(diag K) * I``.  With ``variances=True``,
    ``info["variances"]`` holds per-split posterior variances through the
    float32 factor (float64 oracle: ``ops.solve.predictive_variance``).
    """
    if residual_check not in ("full", "sampled"):
        raise ValueError(f"residual_check must be 'full' or 'sampled', "
                         f"got {residual_check!r}")
    if not 0.0 < residual_accept_frac <= 1.0:
        raise ValueError(f"residual_accept_frac must be in (0, 1], got "
                         f"{residual_accept_frac}")
    if not residual_max_row_gate > 1.0:
        raise ValueError(f"residual_max_row_gate must be > 1, got "
                         f"{residual_max_row_gate}")
    if residual_sample_seed is None:
        residual_sample_seed = int(np.random.SeedSequence().entropy
                                   % (2 ** 32))
    residual_sample_seed = int(residual_sample_seed)
    device = torch.device(device)
    settings.check_precision_on(device)
    on_card = device.type == "cuda"
    n = len(train_x)
    b = batch_size
    if tol is None:
        tol = 3.0 * np.sqrt(n) * float(np.finfo(np.float32).eps)
    t = {"t0": time.perf_counter()}
    peaks = {}
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    def tick(name):
        peak = ""
        if on_card:
            torch.cuda.synchronize(device)
            peaks[name] = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            peak = f", peak {peaks[name] / 1e9:.3f} GB"
        now = time.perf_counter()
        t[name] = now - t["t0"]
        t["t0"] = now
        if verbose:
            print(f"[classify_device_large] {name}: {t[name]:.1f}s{peak}",
                  flush=True)

    factor = CardFactor(n, block, pad_to=b, device=device)
    n_pad = factor.n_pad
    x_all = _on_device(train_x, device)

    # 1. diagonal -> Jacobi scaling
    diag = compute_gram_diag(model, x_all, device=device, batch_size=b,
                             progress=False).astype(np.float64)
    jitter_raw = jitter * float(np.mean(diag))
    s64 = 1.0 / np.sqrt(diag + jitter_raw)
    s_dev = torch.as_tensor(s64.astype(np.float32), device=device)
    tick("diag+scale")

    # 2. scaled Gram (lower triangle) straight into the factor buffer
    k = _assemble_scaled(model, x_all, s_dev, b, n, n_pad)
    tick("assemble")

    # 3. blocked in-place Cholesky: k becomes the factor
    factor._factorize_dev(k)
    del k
    tick("factor")

    # 4. scaled-space iterative refinement with regenerated-tile matvecs
    y64 = solve_ops.one_hot_targets(train_y)
    ys = s64[:, None] * y64
    y_norm = np.linalg.norm(ys, axis=0)
    y_norm[y_norm == 0] = 1.0

    def matvec(a64):
        a_dev = torch.as_tensor(np.asarray(a64, np.float32), device=device)
        return _matvec_scan(model, x_all, s_dev, a_dev, b,
                            n).cpu().numpy().astype(np.float64)

    def sampled(a64, seed):
        return _sampled_residual(model, x_all, s_dev, a64, ys, y_norm, b, n,
                                 residual_sample_rows, seed)

    a = factor.solve(ys.astype(np.float32)).astype(np.float64)
    estimated = False
    rel_sampled = rel_ucb = maxrow_ratio = None
    sampled_blocks = None
    iters = 0
    # the gate can only accept with >= 2 FULL sampled blocks (a short last
    # block may land in the sample); otherwise skip the sampled pass
    k_full = (_sample_block_count(n, b, residual_sample_rows)
              - (1 if n % b else 0))
    if residual_check == "sampled" and k_full >= 2:
        rel_sampled, rel_ucb, maxrow_ratio, sampled_blocks = sampled(
            a, residual_sample_seed)
        if (rel_ucb <= residual_accept_frac * tol
                and maxrow_ratio <= residual_max_row_gate):
            best_a, best_rel = a, rel_sampled   # clear accept: skip
            rel_unrefined = rel_sampled         # the full sweep
            estimated = True
    if not estimated:                  # exact check (+ refinement)
        r = ys - matvec(a)
        rel = float(np.max(np.linalg.norm(r, axis=0) / y_norm))
        best_a, best_rel = a, rel
        rel_unrefined = rel
        while iters < refine_iters and best_rel > tol:
            iters += 1
            a = a + factor.solve(r.astype(np.float32)).astype(np.float64)
            if iters == refine_iters and residual_check == "sampled":
                # the residual after the last correction is only reported,
                # so the sampled estimate suffices (seed + 1: a fresh draw)
                rel, rel_ucb, maxrow_ratio, sampled_blocks = sampled(
                    a, residual_sample_seed + 1)
                rel_sampled = rel
                if rel < best_rel:
                    best_a, best_rel = a, rel
                    estimated = True
                break
            r = ys - matvec(a)
            rel = float(np.max(np.linalg.norm(r, axis=0) / y_norm))
            prev_best = best_rel
            if rel < best_rel:
                best_a, best_rel = a, rel
            if rel > 0.9 * prev_best:  # <10% progress: the f32 floor
                break
    a_final = s64[:, None] * best_a          # back to the original space

    # GP log evidence of the solved system: with M = S K' S,
    # logdet K' = 2 sum log diag(L_M) - 2 sum log s
    logdet = 2.0 * factor.log_diag_sum() - 2.0 * float(np.sum(np.log(s64)))
    n_cls = y64.shape[1]
    log_evidence = (-0.5 * float(np.sum(y64 * a_final))
                    - 0.5 * n_cls * logdet
                    - 0.5 * n * n_cls * np.log(2.0 * np.pi))
    tick("solve+refine")

    # 4b. optional predictive variances through the live factor; the query
    # scores ride the same regenerated cross blocks
    var_list = None
    split_scores = None
    if variances:
        a32 = best_a.astype(np.float32)          # scaled space: alpha / s
        snap = settings.snapshot()
        out = [variances_from_factor(factor, model, x_all, s_dev, xz, b, n,
                                     snap, a_scaled=a32)
               for xz, _ in splits]
        var_list = [v for v, _ in out]
        split_scores = [s_ for _, s_ in out]
        tick("variances+scores")

    factor.l = None                          # release ~N^2 for scoring

    # 5. per-split scores by regeneration; only [n_split, C] is fetched
    accs, preds, scores_list = [], [], []
    scores_fn = None
    for idx, (xz, labels) in enumerate(splits):
        if split_scores is not None:
            scores = split_scores[idx]
        else:
            if scores_fn is None:
                scores_fn = make_scores_fn(model, x_all,
                                           a_final.astype(np.float32),
                                           batch_size=b, device=device)
            scores = scores_fn(xz)
        scores_list.append(np.asarray(scores))
        preds.append(np.argmax(scores, axis=1))
        accs.append(solve_ops.accuracy(preds[-1], np.asarray(labels)))
    tick("predict")

    info = {"rel_residual": best_rel, "rel_residual_unrefined": rel_unrefined,
            "rel_residual_estimated": estimated,
            "rel_residual_sampled": rel_sampled,
            "rel_residual_sampled_ucb": rel_ucb,
            "rel_residual_maxrow_ratio": maxrow_ratio,
            "residual_sample_seed": residual_sample_seed,
            "residual_sampled_blocks": sampled_blocks,
            "refinements": iters,
            "n": n, "n_pad": n_pad, "block": block, "predictions": preds,
            "scores": scores_list, "variances": var_list,
            "log_evidence": log_evidence, "logdet": logdet,
            "alpha": a_final, "scalings": s64, "jitter_raw": jitter_raw,
            "timings_s": {k_: v for k_, v in t.items() if k_ != "t0"},
            "peak_bytes": peaks}
    return accs, info

"""Kernel hyperparameter learning: type-II maximum likelihood.

PyTorch counterpart of ``cnn_gp_tpu/fit.py``, with its names:

    fitted, losses = fit(model, x, y_onehot, steps=100, device=dev)

The leaves are the model's ``nn.Parameter``s (every ``Mixture.logit``, and
``var_weight`` / ``var_bias`` of ``Conv2d(learnable=True)``).  ``fit`` and
``fit_large`` return a fitted copy and leave the input model as it was.
Gradients come from ``torch.autograd`` through ``apply_kernel`` (the plain
torch path) under ``settings.grad_safe``; gradients are returned as dicts
of float32 arrays keyed as ``convert.leaf_items`` (and ``save_leaves``)
name the leaves.  Three paths to the negative marginal log-likelihood:

* ``neg_marginal_log_likelihood`` / ``fit``: the whole Gram in one
  ``apply_kernel`` call and a float32 ``torch.linalg.cholesky``: small N,
  and the oracle of the tests.
* ``nmll_value_and_grad_tiled`` / ``fit_large(grad="exact")``: the Gram
  from ``gram_in_memory`` (the CUDA megakernel for the ConvNet-GP family),
  the value and the cotangent ``dL/dK = 0.5 (C K^-1 - A A^T)`` in float64
  on the host, and the gradient as tile VJPs over the upper tile triangle
  on the device.
* ``ProbedNMLL`` / ``fit_large(grad="probed")``: the equilibrated Gram
  assembled into the ``CardFactor`` buffer, the value from the factor's
  log-diagonal, and the trace term of the cotangent estimated with
  Hutchinson probes, so that each tile's cotangent is a rank-(P + C)
  product built on the device and nothing O(N^2) leaves it.

Ragged edge tiles are sliced; the JAX package pads them with cyclic copies
of real rows whose cotangent is zero, so the sums are the same.  Nothing
here is compiled, so JAX's fixed-size tile chunks (``_weighted_chunks``,
``tiles_per_call``) have no counterpart: each tile gets one backward pass.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import settings
from .convert import leaf_items, load_leaves, save_leaves
from .kernels import apply_kernel
from .parallel import scheduler
from .parallel.chol_dist import CardFactor
from .parallel.device_large import _assemble_scaled, _matvec_scan
from .parallel.gram import _on_device, compute_gram_diag, gram_in_memory

__all__ = ["neg_marginal_log_likelihood", "fit",
           "nmll_value_and_grad_tiled", "fit_large", "ProbedNMLL",
           "save_leaves", "load_leaves"]

Grads = Dict[str, np.ndarray]

# Leaves that must stay strictly positive (the variances of
# Conv2d(learnable=True)) are optimised in log space, so an Adam step can
# never drive them negative and make the kernel indefinite.
_POSITIVE_LEAVES = ("var_weight", "var_bias")
# Exact zero (Conv2d's var_bias default) has no log; the floor is
# negligible against any kernel scale and keeps the leaf optimisable.
_POSITIVE_FLOOR = 1e-12


def _is_positive(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in _POSITIVE_LEAVES


def _leaves(model) -> List[Tuple[str, torch.nn.Parameter]]:
    items = leaf_items(model)
    if not items:
        raise ValueError("model has no array leaves to fit (construct "
                         "layers with learnable=True)")
    return items


def _to_raw(items) -> List[torch.Tensor]:
    """The optimiser's variables: log of the positive leaves (floored),
    the other leaves as they are."""
    with torch.no_grad():
        return [(torch.log(torch.clamp(p, min=_POSITIVE_FLOOR))
                 if _is_positive(k) else p.clone()).requires_grad_(True)
                for k, p in items]


def _set_primal(items, raw) -> None:
    """Write the leaves from the optimiser's variables (exp of the log
    leaves)."""
    with torch.no_grad():
        for (k, p), r in zip(items, raw):
            p.copy_(torch.exp(r) if _is_positive(k) else r)


def _set_raw_grads(items, raw, grads: Grads) -> None:
    """Chain rule through the log-space transform: d exp(r)/dr = exp(r),
    the leaf's current value."""
    for (k, p), r in zip(items, raw):
        g = torch.as_tensor(grads[k], dtype=r.dtype, device=r.device)
        r.grad = g * p.detach() if _is_positive(k) else g


def _adam(raw, lr: float) -> torch.optim.Adam:
    # optax.adam's defaults
    return torch.optim.Adam(raw, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def neg_marginal_log_likelihood(model, x, y, jitter: float = 1e-6, *,
                                device) -> torch.Tensor:
    """Negative GP marginal log-likelihood of targets ``y`` [N, C] under
    the model's kernel on inputs ``x`` [N, C, W, H] (summed over target
    dims, constants dropped), differentiable in the model's leaves.

    The Gram is normalised by ``s = mean(diag K)`` for float32 conditioning,
    with ``s`` detached, so the objective keeps its gradient with respect
    to the kernel's overall scale: up to the ``n log s`` constant it is the
    exact NMLL of ``K`` with jitter ``s * jitter``."""
    device = torch.device(device)
    settings.check_precision_on(device)
    x = _on_device(x, device)
    y = _on_device(y, device)
    with settings.override(grad_safe=True):
        k = apply_kernel(model, x, x, True, False)
    n = k.shape[0]
    s = k.diagonal().mean().detach()
    k = k / s + jitter * torch.eye(n, dtype=k.dtype, device=device)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(y, chol)
    logdet = 2.0 * torch.log(chol.diagonal()).sum() + n * torch.log(s)
    return 0.5 * (y * alpha).sum() / s + 0.5 * y.shape[1] * logdet


def fit(model, x, y, steps: int = 50, learning_rate: float = 0.1,
        jitter: float = 1e-6, loss_fn: Optional[Callable] = None, *,
        device) -> Tuple[object, np.ndarray]:
    """Optimise the model's leaves by Adam on ``loss_fn(model)`` (a scalar
    tensor), by default :func:`neg_marginal_log_likelihood` of ``x`` and
    ``y``.  Returns ``(fitted_copy, losses)``.  Positive leaves are
    optimised in log space: multiplicative steps that cannot cross
    zero."""
    device = torch.device(device)
    if loss_fn is None:
        x, y = _on_device(x, device), _on_device(y, device)

        def loss_fn(m):
            return neg_marginal_log_likelihood(m, x, y, jitter,
                                               device=device)
    fitted = copy.deepcopy(model)
    items = _leaves(fitted)
    raw = _to_raw(items)
    opt = _adam(raw, learning_rate)
    losses = []
    for _ in range(steps):
        _set_primal(items, raw)
        loss = loss_fn(fitted)
        grads = torch.autograd.grad(loss, [p for _, p in items],
                                    allow_unused=True)
        _set_raw_grads(items, raw, {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(items, grads)})
        opt.step()
        losses.append(float(loss.detach()))
    _set_primal(items, raw)
    return fitted, np.asarray(losses)


def _tile_vjp_sweep(model, x_all: torch.Tensor, tiles, cotangent,
                    b: int) -> Grads:
    """``sum_t w_t <ct_t, dK_t/dtheta>`` over ``tiles`` of (i0, j0, w):
    each [b, b] tile (ragged at the edges) is recomputed by
    ``apply_kernel`` with the global-index same-example mask where its rows
    and columns overlap, and its weighted cotangent ``cotangent(i0, j0, bi,
    bj)`` is contracted by one backward pass.  The leaves live in a copy of
    the model on ``x_all``'s device, so the float32 sums stay there until
    the end."""
    dev_model = copy.deepcopy(model).to(x_all.device)
    items = leaf_items(dev_model)
    params = [p for _, p in items]
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    with settings.override(grad_safe=True), torch.enable_grad():
        for i0, j0, w in tiles:
            i0, j0 = int(i0), int(j0)
            xi, xj = x_all[i0:i0 + b], x_all[j0:j0 + b]
            bi, bj = len(xi), len(xj)
            mask = None
            if i0 < j0 + bj and j0 < i0 + bi:
                rows = i0 + torch.arange(bi, device=x_all.device)
                cols = j0 + torch.arange(bj, device=x_all.device)
                mask = rows[:, None] == cols[None, :]
            k = apply_kernel(dev_model, xi, xj, False, False, mask)
            ct = float(w) * cotangent(i0, j0, bi, bj)
            grads = torch.autograd.grad((k * ct).sum(), params,
                                        allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a += g
    return {k: a.cpu().numpy() for (k, _), a in zip(items, acc)}


def _ticker(device, phases: dict):
    """``tick(name)`` records the wall seconds since the previous tick
    (after a sync on the card) under ``name``."""
    t = [time.perf_counter()]

    def tick(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        phases[name] = round(now - t[0], 3)
        t[0] = now
    return tick


def nmll_value_and_grad_tiled(model, x, y, jitter: float = 1e-6,
                              batch_size: int = 128, *, device,
                              phases: Optional[dict] = None
                              ) -> Tuple[float, Grads]:
    """Exact NMLL value and gradient at N past the whole-matrix path.

    The objective of :func:`neg_marginal_log_likelihood` (the NMLL of
    ``K + s jitter I``, ``s = mean(diag K)`` held constant).  The Gram is
    assembled in float32 tiles on ``device``; the value comes from a host
    float64 Cholesky; the gradient is exact through the evidence identity
    ``dL/dK = 0.5 (C K^-1 - A A^T)`` (A the [N, C] solve), contracted with
    tile VJPs over the upper tile triangle, weighted 1 on the diagonal
    and 2 above it (K and dL/dK are both symmetric).  Returns ``(loss,
    grads)``: a float64 value and float32-accumulated gradients.  A dict
    passed as ``phases`` receives the wall seconds of the Gram sweep, the
    host float64 algebra and the VJP sweep."""
    import scipy.linalg

    device = torch.device(device)
    settings.check_precision_on(device)
    tick = _ticker(device, {} if phases is None else phases)
    x_all = _on_device(x, device)
    y64 = np.asarray(y, np.float64)
    n, c = len(x_all), y64.shape[1]
    b = min(batch_size, n)

    # 1) K by the tile sweeps (the megakernel for matched models); a host
    # float64 copy, O(N^2): the ceiling of this path
    k = np.asarray(gram_in_memory(model, x_all, device=device, batch_size=b,
                                  progress=False), np.float64)
    tick("gram")
    s = float(np.mean(np.diagonal(k)))
    k.flat[:: n + 1] += s * jitter

    # 2) value and dL/dK in float64 from one Cholesky
    cho = scipy.linalg.cho_factor(k, lower=True)
    alpha = scipy.linalg.cho_solve(cho, y64)
    loss = (0.5 * float(np.sum(y64 * alpha))
            + c * float(np.sum(np.log(np.diagonal(cho[0])))))
    kinv, info = scipy.linalg.lapack.dpotri(cho[0], lower=True)
    if info != 0:
        raise np.linalg.LinAlgError(f"dpotri failed: info={info}")
    kinv = np.tril(kinv) + np.tril(kinv, -1).T
    gbar = torch.as_tensor((0.5 * (c * kinv - alpha @ alpha.T)).astype(
        np.float32), device=device)
    del k, kinv
    tick("host_f64")

    # 3) the gradient: tile VJPs against gbar over the upper triangle
    tiles = [(i0, j0, 1.0 if i0 == j0 else 2.0)
             for i0, j0 in scheduler.tile_offsets(n, n, b, True)]
    grads = _tile_vjp_sweep(
        model, x_all, tiles,
        lambda i0, j0, bi, bj: gbar[i0:i0 + bi, j0:j0 + bj], b)
    tick("grad_vjp")
    return loss, grads


class ProbedNMLL:
    """Device-resident NMLL value and gradient for one training set:
    construct once, call :meth:`value_and_grad` once per optimisation step
    (``fit_large(grad="probed")`` does).

    The objective of :func:`nmll_value_and_grad_tiled`.  The value's
    log-determinant reads the float32 factor's diagonal (equilibration
    corrected) and its quadratic form the refined solve, as the classify
    path's evidence does.  The gradient replaces the dense trace term of
    the cotangent with the Hutchinson estimator over ``probes`` Rademacher
    draws (numpy's ``default_rng(seed)``, so the draws equal the JAX
    package's): unbiased, standard error ~1/sqrt(P), a fresh seed per step.

    ``tile_fraction < 1`` samples the strictly-upper tiles per step with
    replacement, in proportion to a bound on each tile's cotangent
    Frobenius norm (from block-row norms of U, Z, A), each draw weighted
    by 2/(k p) (``default_rng((seed, 1))``): unbiased, with the variance
    where the cotangent mass is.  Diagonal tiles are always swept.
    ``refine_iters=0`` drops the solve's residual sweep."""

    def __init__(self, x, y, *, jitter: float = 1e-6, batch_size: int = 128,
                 block: int = 1024, probes: int = 16, refine_iters: int = 1,
                 tile_fraction: float = 1.0, device):
        if not 0.0 < tile_fraction <= 1.0:
            raise ValueError(f"tile_fraction must be in (0, 1], got "
                             f"{tile_fraction}")
        self.device = torch.device(device)
        settings.check_precision_on(self.device)
        self.x_all = _on_device(x, self.device)
        self.y64 = np.asarray(y, np.float64)
        self.n = n = len(self.x_all)
        self.b = b = min(batch_size, n)
        self.jitter = jitter
        self.probes = probes
        self.refine_iters = refine_iters
        self.tile_fraction = tile_fraction
        self.factor = CardFactor(n, block, pad_to=b, device=self.device)
        nt = -(-n // b)
        self.diag_tiles = np.asarray([(i * b, i * b) for i in range(nt)],
                                     np.int64)
        self.off_tiles = np.asarray(
            [(i * b, j * b) for i in range(nt) for j in range(i + 1, nt)],
            np.int64).reshape(-1, 2)
        # the measured floor of the refinement residual, as in
        # classify_device_large
        self.tol = 3.0 * np.sqrt(n) * float(np.finfo(np.float32).eps)
        # wall seconds per phase of the last value_and_grad call
        self.last_phases = {}

    def _tiles(self, u, z, alpha, cp: float, seed: int):
        """This step's (offsets [T, 2], weights [T]): every diagonal tile
        at weight 1, then every strictly-upper tile at weight 2 or an
        importance-sampled draw of them."""
        off, n_off = self.off_tiles, len(self.off_tiles)
        if self.tile_fraction < 1.0 and n_off > 1:
            n, b = self.n, self.b
            nt = -(-n // b)

            def block_norms(m):       # [nt] Frobenius norm per row block
                mp = np.concatenate([m, np.zeros((nt * b - n, m.shape[1]))])
                return np.linalg.norm(mp.reshape(nt, b, -1), axis=(1, 2))

            bu, bz, ba = block_norms(u), block_norms(z), block_norms(alpha)
            ii, jj = off[:, 0] // b, off[:, 1] // b
            bound = cp * (bu[ii] * bz[jj] + bz[ii] * bu[jj]) + ba[ii] * ba[jj]
            prob = (bound / bound.sum() if bound.sum() > 0
                    else np.full(n_off, 1.0 / n_off))
            k_t = max(1, int(round(self.tile_fraction * n_off)))
            sel = np.random.default_rng((seed, 1)).choice(
                n_off, size=k_t, replace=True, p=prob)
            off = off[sel]
            w_off = (2.0 / (k_t * prob[sel])).astype(np.float32)
        else:
            w_off = np.full(n_off, 2.0, np.float32)
        return (np.concatenate([self.diag_tiles, off]),
                np.concatenate([np.ones(len(self.diag_tiles), np.float32),
                                w_off]))

    def value_and_grad(self, model, seed: int = 0,
                       _probe_matrix: Optional[np.ndarray] = None
                       ) -> Tuple[float, Grads]:
        """One step's ``(loss, grads)``.  ``_probe_matrix`` [n, P] replaces
        the Rademacher draw (``sqrt(n) * I`` makes the estimator exact, the
        tests' check against the tiled path)."""
        n, b, dev = self.n, self.b, self.device
        self.last_phases = {}
        tick = _ticker(dev, self.last_phases)
        with torch.no_grad():
            # 1) diagonal -> jitter scale and Jacobi equilibration
            diag = compute_gram_diag(model, self.x_all, device=dev,
                                     batch_size=b, progress=False
                                     ).astype(np.float64)
            jitter_raw = self.jitter * float(np.mean(diag))
            s64 = 1.0 / np.sqrt(diag + jitter_raw)
            s_dev = torch.as_tensor(s64.astype(np.float32), device=dev)
            tick("diag")

            # 2) the scaled Gram straight into the factor buffer; the
            # previous step's factor goes first (two N_pad^2 buffers would
            # be resident otherwise)
            self.factor.l = None
            k = _assemble_scaled(model, self.x_all, s_dev, b, n,
                                 self.factor.n_pad)
            tick("assemble")
            self.factor._factorize_dev(k)
            del k
            tick("factor")

            # 3) targets and probes through one batched solve, refined by
            # tile-regeneration matvec sweeps
            c_cls = self.y64.shape[1]
            if _probe_matrix is not None:
                z = np.asarray(_probe_matrix, np.float64)
            else:
                rng = np.random.default_rng(seed)
                z = rng.integers(0, 2, size=(n, self.probes)) * 2.0 - 1.0
            p = z.shape[1]
            rs = s64[:, None] * np.concatenate([self.y64, z], axis=1)
            rnorm = np.linalg.norm(rs, axis=0)
            rnorm[rnorm == 0] = 1.0
            a_s = self.factor.solve(rs.astype(np.float32)).astype(np.float64)
            for _ in range(self.refine_iters):
                a_dev = torch.as_tensor(a_s.astype(np.float32), device=dev)
                r = rs - _matvec_scan(model, self.x_all, s_dev, a_dev, b,
                                      n).cpu().numpy().astype(np.float64)
                if float(np.max(np.linalg.norm(r, axis=0) / rnorm)) \
                        <= self.tol:
                    break
                a_s = a_s + self.factor.solve(r.astype(np.float32)).astype(
                    np.float64)
            tick("solve")
            a_raw = s64[:, None] * a_s                  # K'^-1 [y | z]
            alpha, u = a_raw[:, :c_cls], a_raw[:, c_cls:]

            # 4) value: quadratic form + the factor's log-determinant
            loss = (0.5 * float(np.sum(self.y64 * alpha))
                    + c_cls * (self.factor.log_diag_sum()
                               - float(np.sum(np.log(s64)))))

        # 5) gradient: rank-structured cotangents built per tile on the
        # device, 0.5 (cp (U_i Z_j^T + Z_i U_j^T) - A_i A_j^T)
        cp = c_cls / (2.0 * p)
        u_dev, z_dev, a_dev = (torch.as_tensor(m.astype(np.float32),
                                               device=dev)
                               for m in (u, z, alpha))

        def cotangent(i0, j0, bi, bj):
            ui, uj = u_dev[i0:i0 + bi], u_dev[j0:j0 + bj]
            zi, zj = z_dev[i0:i0 + bi], z_dev[j0:j0 + bj]
            ai, aj = a_dev[i0:i0 + bi], a_dev[j0:j0 + bj]
            return 0.5 * (cp * (ui @ zj.T + zi @ uj.T) - ai @ aj.T)

        offs, ws = self._tiles(u, z, alpha, cp, seed)
        grads = _tile_vjp_sweep(model, self.x_all,
                                [(i0, j0, w) for (i0, j0), w in zip(offs, ws)],
                                cotangent, b)
        tick("grad_vjp")
        return loss, grads


def fit_large(model, x, y, steps: int = 30,
              learning_rate: Optional[float] = None, jitter: float = 1e-6,
              batch_size: int = 128, verbose: bool = False,
              grad: str = "exact", probes: int = 16, block: int = 1024,
              seed: int = 0, tile_fraction: float = 1.0,
              refine_iters: int = 1, backtrack: bool = True,
              backtrack_factor: float = 0.5, backtrack_tol: float = 1e-3,
              min_learning_rate: float = 1e-3, *,
              device) -> Tuple[object, np.ndarray]:
    """Type-II ML at Gram-assembly scale: the :func:`fit` loop driven by
    :func:`nmll_value_and_grad_tiled` (``grad="exact"``) or by
    :class:`ProbedNMLL` (``grad="probed"``: Hutchinson cotangents through
    the card-resident factor, ``probes`` draws, seed ``seed + step``).
    Positive leaves are optimised in log space as in :func:`fit`.  Returns
    ``(fitted_copy, losses)`` with the best-loss iterate, not the last
    one: the loss is solver-exact in both modes, so keeping the argmin is
    free.

    Overshoot guard (``backtrack``): a step whose NMLL is not finite or
    exceeds the best by more than ``backtrack_tol * |best|`` is rejected:
    the iterate restarts from the best one with a fresh Adam state, and
    the learning rate is multiplied by ``backtrack_factor`` (floored at
    ``min_learning_rate``).  ``learning_rate=None`` is 0.1 for exact and
    0.05 for probed gradients.  ``verbose`` prints one line per step with
    its wall seconds and phases."""
    if grad not in ("exact", "probed"):
        raise ValueError(f"grad must be 'exact' or 'probed', got {grad!r}")
    if learning_rate is None:
        learning_rate = 0.1 if grad == "exact" else 0.05
    device = torch.device(device)
    plan = None
    if grad == "probed":
        plan = ProbedNMLL(x, y, jitter=jitter, batch_size=batch_size,
                          block=block, probes=probes,
                          tile_fraction=tile_fraction,
                          refine_iters=refine_iters, device=device)
    else:
        x = _on_device(x, device)

    fitted = copy.deepcopy(model)
    items = _leaves(fitted)
    raw = _to_raw(items)
    lr = float(learning_rate)
    opt = _adam(raw, lr)
    losses = []
    best_raw, best_loss = [r.detach().clone() for r in raw], np.inf
    for it in range(steps):
        t0 = time.perf_counter()
        _set_primal(items, raw)
        if plan is not None:
            loss, g = plan.value_and_grad(fitted, seed=seed + it)
            phases = plan.last_phases
        else:
            phases = {}
            loss, g = nmll_value_and_grad_tiled(
                fitted, x, y, jitter=jitter, batch_size=batch_size,
                device=device, phases=phases)
        losses.append(float(loss))
        if loss < best_loss:
            best_raw = [r.detach().clone() for r in raw]
            best_loss = loss
        if backtrack and (not np.isfinite(loss)
                          or loss > best_loss + backtrack_tol * abs(best_loss)):
            # drop this iterate and its gradient; restart from the best
            # one at a smaller step
            lr = max(lr * backtrack_factor, min_learning_rate)
            with torch.no_grad():
                for r, br in zip(raw, best_raw):
                    r.copy_(br)
            opt = _adam(raw, lr)
            if verbose:
                print(f"[fit_large] step {it}: nmll {loss:.4f} REJECTED "
                      f"(best {best_loss:.4f}); lr -> {lr:.4g}", flush=True)
            continue
        _set_raw_grads(items, raw, g)
        opt.step()
        if verbose:
            print(f"[fit_large] step {it}: nmll {loss:.4f} lr {lr:.4g} "
                  f"({time.perf_counter() - t0:.3f}s)  {phases}", flush=True)
    with torch.no_grad():
        for r, br in zip(raw, best_raw):
            r.copy_(br)
    _set_primal(items, raw)
    return fitted, np.asarray(losses)

"""The plain type-II maximum-likelihood steps that decide a fit cell's
``correct``.

The objective is the one the program states for ``fit_large(grad=
"exact")``: the negative log marginal likelihood of targets Y [N, C]
under K + s jitter I, with s = mean(diag K) held constant,

    L = 0.5 sum(Y * A) + C sum(log diag chol),   A = (K + s jitter I)^-1 Y,

and its gradient through dL/dK = 0.5 (C K^-1 - A A^T), contracted with
the derivative of each block of K by autograd, every block of the upper
triangle weighted 1 on the diagonal and 2 above it.  Everything here is
float64 on the images' device: the Gram from the configuration's
recursion's ``block`` (``nngp.block`` for the diagonal one), the
Cholesky, the solve and the inverse.  Each function takes that recursion
``rec`` (``recursions/<r>.py``, with its fit hooks) and its tree.

The leaves (``rec.leaves``: var_weight and var_bias of every conv) are
optimised in log space by Adam (lr 0.1, betas 0.9 / 0.999, eps 1e-8),
with the overshoot
guard the program documents: a step whose loss is not finite or exceeds
the best by more than 1e-3 of |best| is dropped, the iterate restarts from
the best one with a fresh Adam state, and the rate halves (floored at
1e-3).  ``follow`` takes the first steps of that loop.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

BETAS = (0.9, 0.999)
EPS = 1e-8
LEARNING_RATE = 0.1
BACKTRACK_FACTOR = 0.5
BACKTRACK_TOL = 1e-3
MIN_LEARNING_RATE = 1e-3


def _upper_blocks(n: int, b: int):
    return [(i0, j0) for i0 in range(0, n, b) for j0 in range(i0, n, b)]


def value_and_grad(rec, tree, x: torch.Tensor, y: np.ndarray,
                   raw: np.ndarray, jitter: float = 1e-6, b: int = 128,
                   rounding=None, dtype=torch.float64):
    """(loss, d loss / d raw) at leaves exp(raw), raw in ``rec.leaves``'
    order.  ``rounding``/``dtype`` compute the Gram as the control
    does."""
    dev = x.device
    n, c = len(x), y.shape[1]
    leaves_raw = torch.tensor(raw, dtype=torch.float64, device=dev)
    pairs = lambda lv: [(lv[2 * i], lv[2 * i + 1])          # noqa: E731
                        for i in range(len(lv) // 2)]
    idx = torch.arange(n, device=dev)
    k = torch.empty((n, n), dtype=torch.float64, device=dev)
    with torch.no_grad():
        lv = torch.exp(leaves_raw).to(dtype)
        for i0, j0 in _upper_blocks(n, b):
            r, q = idx[i0:i0 + b], idx[j0:j0 + b]
            mask = r[:, None] == q[None, :]
            blk = rec.block(tree, x[r], x[q], mask if i0 == j0 else None,
                            pairs(lv), dtype, rounding).double()
            k[i0:i0 + len(r), j0:j0 + len(q)] = blk
            k[j0:j0 + len(q), i0:i0 + len(r)] = blk.T
    s = float(k.diagonal().mean())
    k.diagonal().add_(s * jitter)
    chol = torch.linalg.cholesky(k)
    y64 = torch.as_tensor(y, dtype=torch.float64, device=dev)
    alpha = torch.cholesky_solve(y64, chol)
    loss = (0.5 * float((y64 * alpha).sum())
            + c * float(torch.log(chol.diagonal()).sum()))
    g = 0.5 * (c * torch.cholesky_inverse(chol) - alpha @ alpha.T)
    del k, chol
    raw_t = leaves_raw.clone().requires_grad_(True)
    for i0, j0 in _upper_blocks(n, b):
        r, q = idx[i0:i0 + b], idx[j0:j0 + b]
        mask = r[:, None] == q[None, :]
        lv = torch.exp(raw_t).to(dtype)
        blk = rec.block(tree, x[r], x[q], mask if i0 == j0 else None,
                        pairs(lv), dtype, rounding).double()
        w = 1.0 if i0 == j0 else 2.0
        (blk * g[i0:i0 + len(r), j0:j0 + len(q)]).sum().mul(w).backward()
    return loss, raw_t.grad.cpu().numpy()


def initial_raw(rec, tree) -> np.ndarray:
    """log of the configuration's leaves, in ``rec.leaves``' order."""
    return np.log(np.array(rec.leaves(tree), np.float64))


class _Adam:
    def __init__(self, n: int, lr: float):
        self.lr, self.t = lr, 0
        self.m, self.v = np.zeros(n), np.zeros(n)

    def step(self, raw: np.ndarray, g: np.ndarray) -> np.ndarray:
        self.t += 1
        self.m = BETAS[0] * self.m + (1 - BETAS[0]) * g
        self.v = BETAS[1] * self.v + (1 - BETAS[1]) * g * g
        bc1, bc2 = 1 - BETAS[0] ** self.t, 1 - BETAS[1] ** self.t
        denom = np.sqrt(self.v) / math.sqrt(bc2) + EPS
        return raw - (self.lr / bc1) * self.m / denom


def follow(rec, tree, x, y, steps: int = 3, jitter: float = 1e-6,
           b: int = 128, rounding=None, dtype=torch.float64,
           value_and_grad_fn=None):
    """The first ``steps`` steps of the loop from the configuration's
    leaves: a dict of the losses, the first gradient (raw space) and the
    raw leaves each step starts from (``starts[k]``, k = 0..steps)."""
    vg = value_and_grad_fn or value_and_grad
    raw = initial_raw(rec, tree)
    lr = LEARNING_RATE
    opt = _Adam(len(raw), lr)
    best, best_raw = math.inf, raw.copy()
    losses: List[float] = []
    grads: List[np.ndarray] = []
    starts = [raw.copy()]
    for _ in range(steps):
        loss, g = vg(rec, tree, x, y, raw, jitter, b, rounding, dtype)
        losses.append(loss)
        grads.append(g)
        if loss < best:
            best, best_raw = loss, raw.copy()
        if not math.isfinite(loss) or loss > best + BACKTRACK_TOL * abs(best):
            lr = max(lr * BACKTRACK_FACTOR, MIN_LEARNING_RATE)
            raw = best_raw.copy()
            opt = _Adam(len(raw), lr)
        else:
            raw = opt.step(raw, g)
        starts.append(raw.copy())
    return {"losses": np.array(losses), "grad0": grads[0],
            "starts": starts}

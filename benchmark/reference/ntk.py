"""The plain neural tangent kernel of a CNN (CNTK, Arora et al., "On Exact
Computation with an Infinitely Wide Neural Net", NeurIPS 2019, section 4)
that decides ``correct`` for a configuration with ``"recursion": "ntk"``
(``recursions/ntk.py``).

A straightforward PyTorch walk of the configuration's own tree (the
nodes of ``recursions/full.py``: conv, relu, pool, seq), in float64 by
default, on whatever device its inputs lie.  It imports nothing of the
program under test and takes nothing the program made; its conv, pool,
ReLU and diagonal are ``reference/fullcov.py``'s.  TF32 is off for every
product it computes (``torch.backends``, set on import).

A pair (x, y) of images carries two fields over every pair of positions
(p, q), [W, H, W, H]: the covariance K and the tangent Theta; each image
also carries its own two, whose K diagonal is the ReLU's variance.  With
C channels, in the NTK parameterization (v = var_weight, b = var_bias):

    input:  K0(p, q) = mean_c x_c(p) y_c(q),    Theta0 = 0
    conv:   K'(p, q) = (v / k^2) sum_d K(p + d - lo, q + d - lo) + b
            Theta'(p, q) = (v / k^2) sum_d Theta(p + d - lo, q + d - lo)
                           + K'(p, q),   a term off the map 0
    ReLU:   K'(p, q) = sqrt(Kxx(p, p) Kyy(q, q)) / (2 pi)
                       (sin theta + (pi - theta) cos theta)
            Theta'(p, q) = Theta(p, q) (pi - theta) / (2 pi),
            cos theta = K(p, q) / sqrt(Kxx(p, p) Kyy(q, q))
    pool:   both fields averaged over k x k blocks
    output: the last Theta (1 x 1 maps)

With v = 2 and b = 0 this is section 4's recursion with c_sigma = 2, up
to the one global factor of its first layer's weight variance.

Departures from the equations: cos theta is clamped to [-1, 1] before
the arccos and the sine (rounding can carry it past 1 where p = q and x
= y); the conv sums its k^2 shifted views directly (not separably) and
adds the bias to Theta's box sum as 0 (``fullcov._conv`` with no bias).
An entry whose row and column name the same image is that image's own
readout (the mask), which the pair walk gives anyway.

Counts (``recursions/ntk.py``): at the CNTK-GAP cell's 32 x 32 maps a
pair's walk reads 5.53e8 FP32 operations of the equations and
1.60e8 bytes as the program builds it (two 4 MiB fields in and two out
a layer); here, in float64, each block of pairs holds
``FIELD_COPIES`` fields of 8 MiB a pair.

``rounding`` is applied to every field an operation produces: the
control of ``correct`` passes ``nngp.round_tf32`` with float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import torch

from .. import arch
from . import fullcov

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# bytes of float64 fields a block of pairs may hold (its two fields and
# their temporaries)
BLOCK_BYTES = 8 << 30
FIELD_COPIES = 14     # live copies of a block's fields at the ReLU


def _conv(k: torch.Tensor, t: torch.Tensor, c: arch.Conv, live: bool):
    """(K', Theta') of a conv: Theta' the box sum of Theta (0 while
    Theta is 0) plus K'."""
    k2 = fullcov._conv(k, c)
    if not live:
        return k2, k2
    return k2, fullcov._conv(t, dataclasses.replace(c, var_bias=0.0)) + k2


def _relu(k: torch.Tensor, t: torch.Tensor, vx, vy, live: bool):
    """(K', Theta') of the ReLU, variances vx [..., W, H, 1, 1] and vy
    [..., 1, 1, W, H]."""
    norm = torch.sqrt(vx * vy)
    cos = torch.clamp(k / norm, -1.0, 1.0)
    theta = torch.acos(cos)
    k2 = norm / (2 * math.pi) * (torch.sqrt(1.0 - cos * cos)
                                 + (math.pi - theta) * cos)
    return k2, (t * ((math.pi - theta) / (2 * math.pi)) if live else t)


def _walk(tree, f: torch.Tensor, vx: Optional[List[torch.Tensor]],
          vy: Optional[List[torch.Tensor]], rnd):
    """Fields f [n, W, H, W, H] (K0) through the tree; with vx None each
    is its image's own, whose variances are recorded.  Returns (the
    variances, Theta)."""
    t, live = torch.zeros_like(f), False
    variances, relu = [], 0
    for layer in fullcov._layers(tree):
        if isinstance(layer, arch.Conv):
            f, t = (rnd(v) for v in _conv(f, t, layer, live))
            live = True
        elif isinstance(layer, arch.ReLU):
            if vx is None:
                v = fullcov._diag(f)
                variances.append(v)
                a, b = v[:, :, :, None, None], v[:, None, None]
            else:
                a = vx[relu][:, :, :, None, None]
                b = vy[relu][:, None, None]
            relu += 1
            f, t = (rnd(v) for v in _relu(f, t, a, b, live))
        else:
            f = rnd(fullcov._pool(f, layer.kernel_size))
            t = rnd(fullcov._pool(t, layer.kernel_size))
    if f.shape[-4:] != (1, 1, 1, 1):
        raise ValueError(f"the model leaves {tuple(f.shape[-4:])} fields")
    return variances, t.reshape(len(f))


def own(tree, x: torch.Tensor, rnd):
    """Each image's own fields through the tree: the variance maps [n, W,
    H] before each ReLU, and the readout Theta(x, x) [n]."""
    c = x.shape[1]
    return _walk(tree, rnd(torch.einsum("ncwh,nckl->nwhkl", x, x) / c),
                 None, None, rnd)


def pairs(tree, x: torch.Tensor, y: torch.Tensor, vx: List[torch.Tensor],
          vy: List[torch.Tensor], rnd) -> torch.Tensor:
    """Theta(x_i, y_i) [n] of zipped pairs, the variances each image's
    own."""
    c = x.shape[1]
    return _walk(tree, rnd(torch.einsum("ncwh,nckl->nwhkl", x, y) / c),
                 vx, vy, rnd)[1]


def entries(tree, images: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor, dtype=torch.float64,
            rounding: Optional[Callable] = None,
            block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """K[rows][:, cols] of one image set (the NTK), rows and columns as
    global indices, an entry masked (its image's own readout) where they
    name the same image.  Each image's own fields are walked once; the
    pairs in blocks that keep their fields under ``block_bytes``; where
    rows and columns are the same list only the upper triangle is walked
    and mirrored."""
    rnd = rounding or (lambda t: t)
    rows, cols = rows.to(images.device), cols.to(images.device)
    out = torch.empty((len(rows), len(cols)), dtype=dtype,
                      device=images.device)
    if not len(rows) or not len(cols):
        return out
    shape = images.shape[1:]
    per_pair = FIELD_COPIES * torch.finfo(dtype).bits // 8 * (
        shape[1] * shape[2]) ** 2
    step = max(1, block_bytes // per_pair)
    with torch.no_grad():
        uniq, inv = torch.unique(torch.cat([rows, cols]),
                                 return_inverse=True)
        x = images[uniq].to(dtype)
        vs, readout = [], []
        for i0 in range(0, len(x), step):
            v, r = own(tree, x[i0:i0 + step], rnd)
            vs.append(v)
            readout.append(r)
        var = [torch.cat(v) for v in zip(*vs)]
        readout = torch.cat(readout)
        ri, ci = inv[:len(rows)], inv[len(rows):]
        symmetric = len(rows) == len(cols) and bool((rows == cols).all())
        a, b = torch.meshgrid(torch.arange(len(rows), device=x.device),
                              torch.arange(len(cols), device=x.device),
                              indexing="ij")
        a, b = a.reshape(-1), b.reshape(-1)
        keep = (a <= b) if symmetric else torch.ones_like(a, dtype=torch.bool)
        keep &= ri[a] != ci[b]
        a, b = a[keep], b[keep]
        for p0 in range(0, len(a), step):
            pa, pb = ri[a[p0:p0 + step]], ci[b[p0:p0 + step]]
            k = pairs(tree, x[pa], x[pb], [v[pa] for v in var],
                      [v[pb] for v in var], rnd)
            out[a[p0:p0 + step], b[p0:p0 + step]] = k
            if symmetric:
                out[b[p0:p0 + step], a[p0:p0 + step]] = k
        same = ri[:, None] == ci[None, :]
        out = torch.where(same, readout[ri][:, None].expand_as(out), out)
    return out

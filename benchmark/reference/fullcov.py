"""The plain full-covariance NNGP recursion that decides ``correct`` for a
configuration with average pooling (``recursions/full.py``).

A straightforward PyTorch walk of the configuration's own tree, in
float64 by default, on whatever device its inputs lie.  It imports
nothing of the program under test and takes nothing the program made.

A pair (x, y) of images carries ``K(p, q)`` over every pair of
positions, a field [W, H, W, H]; each image also carries its own
covariance, whose diagonal is the ReLU's variance.  With C channels:

    input:  K0(p, q) = mean_c x_c(p) y_c(q)
    conv:   K'(p, q) = (var_weight / k^2) sum_d K(p + d - lo, q + d - lo)
                       + var_bias,   d over the k x k window, a term with
                       p + d - lo or q + d - lo off the map 0
    ReLU:   K'(p, q) = sqrt(Kxx(p, p) Kyy(q, q)) / (2 pi)
                       (sin theta + (pi - theta) cos theta),
            cos theta = K(p, q) / sqrt(Kxx(p, p) Kyy(q, q))
    pool:   K'(P, Q) = (1 / k^4) sum_{a, b in [0, k)^2} K(kP + a, kQ + b)

The one departure from the equations: cos theta is clamped to [-1, 1]
before the arccos (rounding can carry it past 1 where p = q and x = y).
An entry whose row and column name the same image is that image's own
covariance readout (the mask), which the pair walk gives anyway.  The
conv sums its k^2 shifted views directly (not separably).

``rounding`` is applied to every field an operation produces: the
control of ``correct`` passes ``nngp.round_tf32`` with float32.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from .. import arch

# bytes of float64 fields a block of pairs may hold (its pair fields and
# their temporaries)
BLOCK_BYTES = 8 << 30
FIELD_COPIES = 8      # live copies of a block's fields at the ReLU


def _conv(f: torch.Tensor, c: arch.Conv) -> torch.Tensor:
    if c.stride != 1 or c.dilation != 1:
        raise ValueError("the full recursion takes stride 1, dilation 1")
    lo, hi = c.pad
    w, h = f.shape[-4], f.shape[-3]
    wo, ho = c.out_size(w), c.out_size(h)
    fp = F.pad(f, (lo, hi) * 4)
    out = None
    for a in range(c.kernel_size):
        for b in range(c.kernel_size):
            v = fp[..., a:a + wo, b:b + ho, a:a + wo, b:b + ho]
            out = v if out is None else out + v
    return out * (c.var_weight / c.kernel_size ** 2) + c.var_bias


def _pool(f: torch.Tensor, k: int) -> torch.Tensor:
    w, h = f.shape[-4], f.shape[-3]
    wo, ho = w // k, h // k
    f = f[..., :k * wo, :k * ho, :k * wo, :k * ho]
    lead = f.shape[:-4]
    f = f.reshape(*lead, wo, k, ho, k, wo, k, ho, k)
    return f.sum(dim=(-7, -5, -3, -1)) / k ** 4


def _relu(f: torch.Tensor, vx: torch.Tensor, vy: torch.Tensor
          ) -> torch.Tensor:
    """f [..., W, H, W, H] with variances vx [..., W, H, 1, 1] and vy
    [..., 1, 1, W, H] broadcast against it."""
    norm = torch.sqrt(vx * vy)
    cos = torch.clamp(f / norm, -1.0, 1.0)
    theta = torch.acos(cos)
    return norm / (2 * math.pi) * (torch.sqrt(1.0 - cos * cos)
                                   + (math.pi - theta) * cos)


def _diag(f: torch.Tensor) -> torch.Tensor:
    """K(p, p) of own covariances [n, W, H, W, H], as [n, W, H]."""
    n, w, h = f.shape[:3]
    return f.reshape(n, w * h, w * h).diagonal(dim1=1, dim2=2).reshape(
        n, w, h)


def _layers(tree) -> list:
    if isinstance(tree, arch.Seq):
        return [x for layer in tree.layers for x in _layers(layer)]
    return [tree]


def own(tree, x: torch.Tensor, rnd) -> (List[torch.Tensor], torch.Tensor):
    """Each image's own covariance through the tree: the variance maps
    [n, W, H] before each ReLU, and the readout [n]."""
    c = x.shape[1]
    f = rnd(torch.einsum("ncwh,nckl->nwhkl", x, x) / c)
    variances = []
    for layer in _layers(tree):
        if isinstance(layer, arch.Conv):
            f = rnd(_conv(f, layer))
        elif isinstance(layer, arch.ReLU):
            v = _diag(f)
            variances.append(v)
            f = rnd(_relu(f, v[:, :, :, None, None], v[:, None, None]))
        else:
            f = rnd(_pool(f, layer.kernel_size))
    return variances, f.reshape(len(x))


def pairs(tree, x: torch.Tensor, y: torch.Tensor, vx: List[torch.Tensor],
          vy: List[torch.Tensor], rnd) -> torch.Tensor:
    """K(x_i, y_i) [n] of zipped pairs, the variances each image's own."""
    c = x.shape[1]
    f = rnd(torch.einsum("ncwh,nckl->nwhkl", x, y) / c)
    relu = 0
    for layer in _layers(tree):
        if isinstance(layer, arch.Conv):
            f = rnd(_conv(f, layer))
        elif isinstance(layer, arch.ReLU):
            f = rnd(_relu(f, vx[relu][:, :, :, None, None],
                          vy[relu][:, None, None]))
            relu += 1
        else:
            f = rnd(_pool(f, layer.kernel_size))
    if f.shape[-4:] != (1, 1, 1, 1):
        raise ValueError(f"the model leaves {tuple(f.shape[-4:])} fields")
    return f.reshape(len(x))


def entries(tree, images: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor, dtype=torch.float64,
            rounding: Optional[Callable] = None,
            block_bytes: int = BLOCK_BYTES) -> torch.Tensor:
    """K[rows][:, cols] of one image set, rows and columns as global
    indices, an entry masked (its image's own readout) where they name
    the same image.  Each image's own covariance is walked once; the
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

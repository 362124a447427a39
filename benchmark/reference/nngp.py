"""The plain NNGP covariance recursion that decides ``correct``.

A straightforward PyTorch walk of a configuration's own description of
its architecture (``configs/<name>.json``, parsed by ``arch.parse``), on
whatever device its inputs lie, in float64 by default.  It imports
nothing of the program under test and takes nothing the program made:
it recomputes every map from the images.

For a pair of image sets the fields are the cross moments ``xy`` [nx,
nz, W, H] and each side's variance maps ``xx`` [nx, W, H], ``zz`` [nz, W,
H], starting from their channel means.  A ``conv`` is a zero-padded box
sum (``F.avg_pool2d`` with ``divisor_override=1`` after ``F.pad``)
scaled by ``var_weight / k^2`` plus ``var_bias``, on all three fields.  A
``relu`` is the arccos kernel

    xy' = (sqrt(xx zz - xy^2) + (pi - theta) xy) / (2 pi),
    theta = acos(xy / sqrt(xx zz)),      xx' = xx / 2,   zz' = zz / 2,

with an entry whose row and column are the same example set to xx' (the
mask); that entry's input is replaced by 0 before the map, so gradients
through a masked tile stay finite.  A ``sum`` adds its branches' fields.
The channel multipliers of a ``conv`` shape a finite network only and do
not enter the kernel.

``rounding`` is applied to every field an operation produces: the
control of ``correct`` passes ``round_tf32`` with float32 to compute the
same recursion as a TF32 path would store it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import arch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa, to nearest with
    ties to even (the low 13 of float32's 23 mantissa bits cleared); the
    gradient passes through as if unrounded."""
    if t.dtype != torch.float32:
        raise TypeError("round_tf32 takes float32")
    bits = t.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return t + (rounded - t).detach() if t.requires_grad else rounded


def _box(a: torch.Tensor, c: arch.Conv) -> torch.Tensor:
    """The k x k window sum over a's last two dims, zero-padded."""
    if c.dilation != 1:
        raise ValueError("the reference box sum takes dilation 1")
    lo, hi = c.pad
    lead = a.shape[:-2]
    a = a.reshape(-1, 1, *a.shape[-2:])
    if lo or hi:
        a = F.pad(a, (lo, hi, lo, hi))
    out = F.avg_pool2d(a, c.kernel_size, c.stride, 0, divisor_override=1)
    return out.reshape(*lead, *out.shape[-2:])


class _Fields:
    __slots__ = ("xy", "xx", "zz")

    def __init__(self, xy, xx, zz):
        self.xy, self.xx, self.zz = xy, xx, zz

    def map(self, fn):
        return _Fields(fn(self.xy), fn(self.xx), fn(self.zz))


def _walk(tree, f: _Fields, mask, leaves, rnd):
    if isinstance(tree, arch.Conv):
        vw, vb = leaves.pop(0) if leaves is not None else (
            tree.var_weight, tree.var_bias)
        scale = vw / (tree.kernel_size * tree.kernel_size)
        return f.map(lambda a: rnd(_box(a, tree) * scale + vb))
    if isinstance(tree, arch.ReLU):
        xy = f.xy if mask is None else torch.where(
            mask[:, :, None, None], torch.zeros_like(f.xy), f.xy)
        xx_zz = f.xx[:, None] * f.zz[None, :]
        cos = torch.clamp(xy / torch.sqrt(xx_zz), -1.0, 1.0)
        sin = torch.sqrt(torch.clamp(xx_zz - xy * xy, min=0.0))
        out = (sin + (math.pi - torch.acos(cos)) * xy) / (2 * math.pi)
        xx, zz = f.xx * 0.5, f.zz * 0.5
        if mask is not None:
            out = torch.where(mask[:, :, None, None],
                              xx[:, None].expand_as(out), out)
        return _Fields(rnd(out), rnd(xx), rnd(zz))
    if isinstance(tree, arch.Seq):
        for layer in tree.layers:
            f = _walk(layer, f, mask, leaves, rnd)
        return f
    total = None
    for branch in tree.branches:
        out = _walk(branch, f, mask, leaves, rnd)
        total = out if total is None else _Fields(
            rnd(total.xy + out.xy), rnd(total.xx + out.xx),
            rnd(total.zz + out.zz))
    return total


def block(tree, x: torch.Tensor, z: torch.Tensor,
          mask: Optional[torch.Tensor] = None, leaves=None,
          dtype=torch.float64,
          rounding: Optional[Callable] = None) -> torch.Tensor:
    """K(x, z) as an [nx, nz] tensor of ``dtype``.  ``mask`` [nx, nz]
    marks the entries whose row and column are the same example;
    ``leaves`` (one (var_weight, var_bias) pair of tensors per conv, in
    walk order) replaces the configuration's values, for gradients."""
    rnd = rounding or (lambda t: t)
    x, z = x.to(dtype), z.to(dtype)
    c = x.shape[1]
    xy = rnd(torch.einsum("icwh,jcwh->ijwh", x, z) / c)
    f = _Fields(xy, rnd((x * x).mean(1)), rnd((z * z).mean(1)))
    f = _walk(tree, f, mask, None if leaves is None else list(leaves), rnd)
    if f.xy.shape[-2:] != (1, 1):
        raise ValueError(f"the model leaves {tuple(f.xy.shape[-2:])} maps")
    return f.xy.reshape(x.shape[0], z.shape[0])


def entries(tree, images: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor, dtype=torch.float64, rounding=None,
            pairs_per_block: int = 8192) -> torch.Tensor:
    """K[rows][:, cols] of one image set, its rows and columns given as
    global indices: an entry is masked where they name the same image.
    Computed a block of rows at a time, so that it fits."""
    out = torch.empty((len(rows), len(cols)), dtype=dtype,
                      device=images.device)
    step = max(1, pairs_per_block // max(len(cols), 1))
    with torch.no_grad():
        for r0 in range(0, len(rows), step):
            r = rows[r0:r0 + step]
            mask = r[:, None] == cols[None, :]
            out[r0:r0 + len(r)] = block(tree, images[r], images[cols],
                                        mask if mask.any() else None,
                                        dtype=dtype, rounding=rounding)
    return out

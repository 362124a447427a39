"""Strided/dilated box filters: the NNGP Conv2d covariance op.

PyTorch counterpart of ``cnn_gp_tpu/ops/boxfilter.py``.  A conv with a
constant ``var_weight / k**2`` kernel is a scaled windowed sum, so no
weight tensor is built.  ``box_filter_2d`` is the separable shift-sum of
``cnn_gp_tpu/ops/boxfilter.py::_shift_sum_1d``: per axis, zero padding
``(lo, hi)`` and then ``k`` strided slices added together.

It deliberately avoids ``F.conv2d``: cuDNN runs float32 convolutions in
TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["same_padding", "resolve_padding", "box_filter_2d", "out_size"]

PadT = Tuple[int, int]


def same_padding(kernel_size: int, dilation: int = 1) -> PadT:
    """(lo, hi) padding replicating the reference's "same" mode.

    Odd kernels: symmetric ``p = dilation * (k // 2)``.  Even kernels: the
    reference's zero-row trick is equivalent to ``(p - dilation, p)``.
    """
    p = dilation * (kernel_size // 2)
    if kernel_size % 2 == 0:
        return (p - dilation, p)
    return (p, p)


def resolve_padding(padding: Union[str, int, PadT], kernel_size: int,
                    dilation: int = 1) -> PadT:
    if isinstance(padding, str):
        if padding != "same":
            raise ValueError(f"unknown padding {padding!r}")
        return same_padding(kernel_size, dilation)
    if isinstance(padding, int):
        return (padding, padding)
    lo, hi = padding
    return (int(lo), int(hi))


def out_size(length: int, kernel_size: int, stride: int, pad: PadT,
             dilation: int) -> int:
    eff = dilation * (kernel_size - 1) + 1
    return (length + pad[0] + pad[1] - eff) // stride + 1


def _shift_sum_1d(x: torch.Tensor, dim: int, k: int, stride: int,
                  pad: PadT, dilation: int) -> torch.Tensor:
    """``out[o] = sum_a xp[o*stride + a*dilation]`` along ``dim`` over the
    zero-padded input."""
    n_out = out_size(x.shape[dim], k, stride, pad, dilation)
    if pad[0] or pad[1]:
        # F.pad lists (lo, hi) pairs from the last dim backwards
        spec = [0, 0] * (x.ndim - 1 - dim) + [pad[0], pad[1]]
        x = F.pad(x, spec)
    head = (slice(None),) * dim
    total = None
    for a in range(k):
        start = a * dilation
        sl = x[head + (slice(start, start + (n_out - 1) * stride + 1,
                             stride),)]
        total = sl if total is None else total + sl
    return total


def box_filter_2d(x: torch.Tensor, kernel_size: int, stride: int = 1,
                  padding: Union[str, int, PadT] = 0,
                  dilation: int = 1) -> torch.Tensor:
    """Windowed sum over the trailing two dims of ``x`` ([..., W, H])."""
    pad = resolve_padding(padding, kernel_size, dilation)
    y = _shift_sum_1d(x, x.ndim - 2, kernel_size, stride, pad, dilation)
    return _shift_sum_1d(y, x.ndim - 1, kernel_size, stride, pad, dilation)

"""Arccos-kernel ReLU covariance transform.

PyTorch counterpart of ``cnn_gp_tpu/ops/arccos.py``:

    xy' = ( sqrt(xx*yy - xy^2) + (pi - theta) * xy ) / (2*pi),
    theta = acos( clip( xy / sqrt(xx*yy), -1, 1 ) ),
    xx' = xx / 2,   yy' = yy / 2,

with ``+ f32_tiny`` under the rsqrt, the cosine clamped to [-1, 1], the
sine argument clamped >= 0, and the same-example entries overwritten with
``xx'`` through the ``[Nx, Ny]`` mask.  ``acos_f32`` is the Cephes
polynomial that the megakernel evaluates too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernel_patch import KernelPatch

__all__ = ["relu_transform", "acos_f32", "F32_TINY"]

F32_TINY = float(np.finfo(np.float32).tiny)
_HALF_PI = math.pi / 2.0


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest.  CUDA's sqrtf is; PyTorch's
    vectorised CPU sqrt misrounds some inputs by one ulp, so on the CPU it
    goes through float64, which is exact for a float32 input before the
    one rounding back."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def acos_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 arccos from sqrt+fma only (Cephes asinf polynomial).

    Max abs error ~1e-7 over [-1, 1]; relative accuracy is kept near +-1
    via acos(x) = 2*asin(sqrt((1-x)/2)).  Inputs must be in [-1, 1].
    """
    a = torch.abs(x)
    big = a > 0.5
    z_big = 0.5 * (1.0 - a)
    z = torch.where(big, z_big, a * a)
    t = torch.where(big, _sqrt_rn(z_big), a)
    p = ((((4.2163199048e-2 * z + 2.4181311049e-2) * z + 4.5470025998e-2) * z
          + 7.4953002686e-2) * z + 1.6666752422e-1)
    asin_core = t + t * z * p          # = asin(t) for t in [0, sqrt(0.5)]
    acos_abs = torch.where(big, 2.0 * asin_core, _HALF_PI - asin_core)
    return torch.where(x < 0, math.pi - acos_abs, acos_abs)


def _xy_update(xy, xx_yy, acos_fn):
    """Core elementwise map, in the reference's op order (no mask fix)."""
    cos_theta = torch.clamp(xy * torch.rsqrt(xx_yy), -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(xx_yy - xy * xy, min=0.0))
    theta = acos_fn(cos_theta)
    return (sin_theta + (math.pi - theta) * xy) * (0.5 / math.pi)


def _xy_update_factored(xy, xx, yy, acos_fn):
    """Same map with the per-row/per-column rsqrt and sqrt hoisted out of
    the pair grid; sin(theta) is recovered from cos(theta)."""
    r_xx = torch.rsqrt(xx + F32_TINY)[:, None]
    r_yy = torch.rsqrt(yy + F32_TINY)[None, :]
    s_xx = torch.sqrt(xx + F32_TINY)[:, None]
    s_yy = torch.sqrt(yy + F32_TINY)[None, :]
    # (r_xx * r_yy) first: the factor is symmetric under (i, j) swap, so
    # Gram tiles stay exactly symmetric (a chained xy*r_xx*r_yy would
    # associate differently across the diagonal)
    cos_theta = torch.clamp(xy * (r_xx * r_yy), -1.0, 1.0)
    sin_theta = (s_xx * s_yy) * torch.sqrt(
        torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    pi_minus_theta = acos_fn(-cos_theta)   # acos(-c) = pi - acos(c)
    return (sin_theta + pi_minus_theta * xy) * (0.5 / math.pi)


def relu_transform(kp: KernelPatch) -> KernelPatch:
    """The transform on a whole patch (``cnn_gp_tpu.ops.arccos._relu_xla``,
    which the JAX ``relu_transform`` dispatches to)."""
    from .. import settings
    acos_fn = acos_f32 if settings.acos_impl == "poly" else torch.acos
    xx_half = kp.xx * 0.5
    if kp.diag:
        if kp.same:
            # same & diag => xy' = xx' exactly
            return KernelPatch(xx_half, xx_half, xx_half, kp.same, kp.diag)
        xx_yy = kp.xx * kp.yy + F32_TINY
        xy = _xy_update(kp.xy, xx_yy, acos_fn)
        return KernelPatch(xy, xx_half, kp.yy * 0.5, kp.same, kp.diag)

    mask = kp.resolve_diag_mask()
    xy_in = kp.xy
    if mask is not None and settings.grad_safe:
        # Double-where: same-example entries sit at cos(theta) = 1, where
        # acos and sqrt have infinite local derivatives; their outputs are
        # overwritten below (zero cotangent), but 0 * inf = NaN in the
        # backward pass.  A neutral input (cos = 0) in the discarded branch
        # keeps gradients finite and changes no primal value.
        xy_in = torch.where(mask[:, :, None, None], 0.0, xy_in)
    if settings.relu_impl == "fast":
        xy = _xy_update_factored(xy_in, kp.xx, kp.yy, acos_fn)
    else:
        xx_yy = kp.xx[:, None] * kp.yy[None, :] + F32_TINY
        xy = _xy_update(xy_in, xx_yy, acos_fn)
    if mask is not None:
        # same-example entries must equal xx' exactly
        xy = torch.where(mask[:, :, None, None],
                         xx_half[:, None].expand_as(xy), xy)
    yy_half = xx_half if kp.same else kp.yy * 0.5
    return KernelPatch(xy, xx_half, yy_half, kp.same, kp.diag, kp.diag_mask)

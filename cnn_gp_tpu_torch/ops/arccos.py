"""Arccos-kernel ReLU covariance transform.

PyTorch counterpart of ``cnn_gp_tpu/ops/arccos.py``:

    xy' = ( sqrt(xx*yy - xy^2) + (pi - theta) * xy ) / (2*pi),
    theta = acos( clip( xy / sqrt(xx*yy), -1, 1 ) ),
    xx' = xx / 2,   yy' = yy / 2,

with ``+ f32_tiny`` under the rsqrt, the cosine clamped to [-1, 1], the
sine argument clamped >= 0, and the same-example entries overwritten with
``xx'`` through the ``[Nx, Ny]`` mask.  ``acos_f32`` is the Cephes
polynomial that the megakernel evaluates too.

The plain version is ``relu_transform_reference`` (``relu_xy_reference``
for the xy' map alone).  On the card the xy' map is one hand-written CUDA
kernel, ``csrc/arccos.cu`` (both ``relu_impl`` forms, both ``acos_impl``
versions, pair and diagonal modes, with or without the mask), within 1e-6
of max|xy'| of the plain version; xx' and yy' stay torch multiplies.  In
the "fast" form the side maps' factors (``relu_factors``: rsqrt and sqrt
of xx + tiny and yy + tiny) are computed once per launch into a factor
table that the wrapper allocates (``factor_table``) and the kernel fills
and reads, inside the same launch.
``relu_transform`` runs the plain version for CPU tensors and launches
the kernel for CUDA tensors, or raises (a diagonal block of one set,
whose xy' is xx', launches nothing).  A ReLU whose every consumer is a
``Conv2d`` runs instead in the box filter's prologue (``ops/layer.py``),
on the same device math (``csrc/arccos.cuh``).  ``launches`` counts this
kernel's launches; ``copies`` counts inputs that were not contiguous and
were copied before a launch.

``settings.relu_method`` names the JAX package's lowering of the ReLU;
the port has one, and refuses an unknown name as JAX does
(``check_method``).
"""

from __future__ import annotations

import ctypes
import math
import types
from typing import Optional

import numpy as np
import torch

from ..kernel_patch import KernelPatch
from . import cuda_lib

__all__ = ["relu_transform", "relu_transform_reference", "relu_xy_reference",
           "relu_factors", "factor_table", "factor_table_entries",
           "factor_table_reference", "acos_f32", "F32_TINY", "check_method",
           "METHODS", "build", "launches", "copies"]

launches = 0   # ReLU kernel launches
copies = 0     # inputs copied to make them contiguous before a launch
_lib = None

F32_TINY = float(np.finfo(np.float32).tiny)
_HALF_PI = math.pi / 2.0
# the JAX package's lowerings of the ReLU (settings.relu_method)
METHODS = ("auto", "xla")


def check_method() -> None:
    """Raise ``ValueError`` on an unknown ``settings.relu_method``, as
    ``cnn_gp_tpu/ops/arccos.py::relu_transform`` does."""
    from .. import settings
    if settings.relu_method not in METHODS:
        raise ValueError(f"unknown relu method {settings.relu_method!r}")


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


def relu_factors(v: torch.Tensor):
    """The "fast" form's factors of side-map values ``v``: ``(rsqrt(v +
    tiny), sqrt(v + tiny))``, computed once per row or column of the pair
    grid, not per pair element.  The kernels' factor table holds the same
    pairs (``factor_table_reference``)."""
    a = v + F32_TINY
    return torch.rsqrt(a), torch.sqrt(a)


def _xy_update_factored(xy, xx, yy, acos_fn):
    """Same map with the per-row/per-column rsqrt and sqrt hoisted out of
    the pair grid; sin(theta) is recovered from cos(theta)."""
    r_xx, s_xx = relu_factors(xx)
    r_yy, s_yy = relu_factors(yy)
    r_xx, s_xx = r_xx[:, None], s_xx[:, None]
    r_yy, s_yy = r_yy[None, :], s_yy[None, :]
    # (r_xx * r_yy) first: the factor is symmetric under (i, j) swap, so
    # Gram tiles stay exactly symmetric (a chained xy*r_xx*r_yy would
    # associate differently across the diagonal)
    cos_theta = torch.clamp(xy * (r_xx * r_yy), -1.0, 1.0)
    sin_theta = (s_xx * s_yy) * torch.sqrt(
        torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    pi_minus_theta = acos_fn(-cos_theta)   # acos(-c) = pi - acos(c)
    return (sin_theta + pi_minus_theta * xy) * (0.5 / math.pi)


def relu_xy_reference(xy: torch.Tensor, xx: torch.Tensor,
                      yy: torch.Tensor, mask: Optional[torch.Tensor],
                      diag: bool) -> torch.Tensor:
    """The xy' map in plain torch (``cnn_gp_tpu.ops.arccos._relu_xla``'s
    xy): pair mode (``xy`` [Nx, Ny, W, H], ``xx`` [Nx, W, H], ``yy`` [Ny,
    W, H], ``mask`` [Nx, Ny] bool or None) in the ``settings.relu_impl``
    form, or the diagonal mode (all [N, W, H], the reference form, no
    mask)."""
    from .. import settings
    acos_fn = acos_f32 if settings.acos_impl == "poly" else torch.acos
    if diag:
        return _xy_update(xy, xx * yy + F32_TINY, acos_fn)
    xy_in = xy
    if mask is not None and settings.grad_safe:
        # Double-where: same-example entries sit at cos(theta) = 1, where
        # acos and sqrt have infinite local derivatives; their outputs are
        # overwritten below (zero cotangent), but 0 * inf = NaN in the
        # backward pass.  A neutral input (cos = 0) in the discarded branch
        # keeps gradients finite and changes no primal value.
        xy_in = torch.where(mask[:, :, None, None], 0.0, xy_in)
    if settings.relu_impl == "fast":
        out = _xy_update_factored(xy_in, xx, yy, acos_fn)
    else:
        xx_yy = xx[:, None] * yy[None, :] + F32_TINY
        out = _xy_update(xy_in, xx_yy, acos_fn)
    if mask is not None:
        # same-example entries must equal xx' exactly
        out = torch.where(mask[:, :, None, None],
                          (xx * 0.5)[:, None].expand_as(out), out)
    return out


def _transform(kp: KernelPatch, xy_map) -> KernelPatch:
    """The transform of a patch, with its xy' map from ``xy_map(xy, xx,
    yy, mask, diag)``."""
    xx_half = kp.xx * 0.5
    if kp.diag and kp.same:
        # same & diag => xy' = xx' exactly
        return KernelPatch(xx_half, xx_half, xx_half, kp.same, kp.diag)
    xy = xy_map(kp.xy, kp.xx, kp.yy, kp.resolve_diag_mask(), kp.diag)
    if kp.diag:
        return KernelPatch(xy, xx_half, kp.yy * 0.5, kp.same, kp.diag)
    yy_half = xx_half if kp.same else kp.yy * 0.5
    return KernelPatch(xy, xx_half, yy_half, kp.same, kp.diag, kp.diag_mask)


def relu_transform_reference(kp: KernelPatch) -> KernelPatch:
    """The transform on a whole patch in plain torch
    (``cnn_gp_tpu.ops.arccos._relu_xla``, which the JAX ``relu_transform``
    dispatches to)."""
    check_method()
    return _transform(kp, relu_xy_reference)


def relu_transform(kp: KernelPatch) -> KernelPatch:
    """The transform on a whole patch: ``relu_transform_reference`` for
    CPU tensors; for CUDA tensors the xy' map is one kernel launch (or the
    call raises), through an autograd Function where a gradient is
    wanted."""
    if kp.xy.device.type == "cpu":
        return relu_transform_reference(kp)
    check_method()
    return _transform(kp, _on_card)


# kernel modes (csrc/arccos.cu)
PAIR_FAST, PAIR_REFERENCE, DIAGONAL = 0, 1, 2


def _one_side(xx: torch.Tensor, yy: torch.Tensor) -> bool:
    """yy is xx (a same block): one set of factors serves both sides."""
    return xx.data_ptr() == yy.data_ptr() and xx.shape == yy.shape


def factor_table_entries(nx: int, ny: int, one_side: bool) -> int:
    """(r, s) entries of the factor table of nx xx values and ny yy
    values: xx's first, then yy's from the first multiple of 4 at or after
    nx (16-byte aligned), or xx's alone when yy is xx
    (``csrc/arccos.cuh::factor_y_offset``)."""
    return nx if one_side else ((nx + 3) & ~3) + ny


def factor_table(xx: torch.Tensor, yy: torch.Tensor) -> torch.Tensor:
    """An empty float32 [entries, 2] factor table on ``xx``'s device, from
    torch's caching allocator, for a "fast" launch on the side maps xx
    and yy; the launch fills it."""
    n = factor_table_entries(xx.numel(), yy.numel(), _one_side(xx, yy))
    return torch.empty((n, 2), dtype=torch.float32, device=xx.device)


def factor_table_reference(xx: torch.Tensor,
                           yy: torch.Tensor) -> torch.Tensor:
    """The factor table's contents in plain torch (``relu_factors`` of
    every xx value, then of every yy value unless yy is xx); the padding
    between the two, which no launch writes, is zero here."""
    out = torch.zeros(factor_table_entries(xx.numel(), yy.numel(),
                                           _one_side(xx, yy)), 2,
                      dtype=torch.float32, device=xx.device)
    r, s = relu_factors(xx.reshape(-1))
    out[:xx.numel(), 0], out[:xx.numel(), 1] = r, s
    if not _one_side(xx, yy):
        r, s = relu_factors(yy.reshape(-1))
        out[-yy.numel():, 0], out[-yy.numel():, 1] = r, s
    return out


def build() -> float:
    """Build and load the kernel libraries (``cuda_lib.build``) and bind
    this module's entry point.  Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    seconds = cuda_lib.build()
    lib = cuda_lib.library("arccos")
    fn = lib.cnn_gp_relu
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cnn_gp_relu_error_string.argtypes = [ctypes.c_int]
    lib.cnn_gp_relu_error_string.restype = ctypes.c_char_p
    _lib = types.SimpleNamespace(
        cnn_gp_relu=fn,
        error_string=lambda code: lib.cnn_gp_relu_error_string(
            code).decode())
    return seconds


def _forms():
    """The settings the kernel and its plain version read, as they stand:
    (mode of a pair launch, acosf instead of the polynomial, the settings
    for a backward pass to restore)."""
    from .. import settings
    saved = dict(relu_impl=settings.relu_impl, acos_impl=settings.acos_impl,
                 grad_safe=settings.grad_safe)
    mode = PAIR_FAST if settings.relu_impl == "fast" else PAIR_REFERENCE
    return mode, int(settings.acos_impl != "poly"), saved


def _on_card(xy: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
             mask: Optional[torch.Tensor], diag: bool) -> torch.Tensor:
    """The CUDA route: launch the kernel or raise."""
    if xy.device.type != "cuda":
        raise ValueError(f"the ReLU kernel runs on cuda tensors, not on "
                         f"{xy.device}")
    build()
    return _route(xy, xx, yy, mask, diag,
                  torch.cuda.current_stream(xy.device).cuda_stream)


def _route(xy: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
           mask: Optional[torch.Tensor], diag: bool, stream) -> torch.Tensor:
    """The launch, through ``_ReluXY`` where a gradient is wanted."""
    mode, exact, saved = _forms()
    mode = DIAGONAL if diag else mode
    if torch.is_grad_enabled() and (xy.requires_grad or xx.requires_grad
                                    or yy.requires_grad):
        return _ReluXY.apply(mode, exact, saved, mask, stream, xy, xx, yy)
    return _launch(xy, xx, yy, mask, mode, exact, stream)


class _ReluXY(torch.autograd.Function):
    """The kernel as the forward; the backward re-runs
    ``relu_xy_reference`` on the saved inputs, under the settings of the
    forward, and returns its gradients, the same as plain autograd's.  (A
    hand-written backward kernel is ROADMAP Queue 2 item 1, the tile
    VJP.)"""

    @staticmethod
    def forward(ctx, mode, exact, saved, mask, stream, xy, xx, yy):
        ctx.settings = saved
        ctx.diag = mode == DIAGONAL
        ctx.save_for_backward(mask, xy, xx, yy)
        return _launch(xy, xx, yy, mask, mode, exact, stream)

    @staticmethod
    def backward(ctx, grad):
        from .. import settings
        mask, *inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs)]
        with settings.override(**ctx.settings), torch.enable_grad():
            out = relu_xy_reference(*inputs, mask, ctx.diag)
        got = iter(torch.autograd.grad(
            out, [t for t, need in zip(inputs, needs) if need], grad,
            allow_unused=True))
        return (None,) * 5 + tuple(next(got) if need else None
                                   for need in needs)


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    global copies
    if t.is_contiguous():
        return t
    copies += 1
    return t.contiguous()


def _check_table(table: Optional[torch.Tensor], xx: torch.Tensor,
                 yy: torch.Tensor) -> torch.Tensor:
    """The factor table of a "fast" launch on (contiguous) xx and yy: a
    new one, or ``table`` if it has the shape, type, device and layout
    that the kernel writes."""
    if table is None:
        return factor_table(xx, yy)
    want = (factor_table_entries(xx.numel(), yy.numel(), _one_side(xx, yy)),
            2)
    if (table.shape != want or table.dtype != torch.float32
            or table.device != xx.device or not table.is_contiguous()):
        raise ValueError(f"a factor table must be contiguous float32 {want} "
                         f"on {xx.device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    return table


def _launch(xy: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor,
            mask: Optional[torch.Tensor], mode: int, exact: int,
            stream, table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One kernel launch on ``stream``; returns the new xy' map.  A
    ``PAIR_FAST`` launch fills and reads a factor table: ``table`` when it
    is given (a ``factor_table`` of these side maps, left filled for a
    caller to read), else a new one."""
    global launches
    for name, t in (("xy", xy), ("xx", xx), ("yy", yy)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != xy.device:
            raise ValueError(f"{name} on {t.device}, xy on {xy.device}")
    if mode == DIAGONAL:
        if not (xy.ndim == 3 and xx.shape == xy.shape == yy.shape):
            raise ValueError(f"diagonal mode takes xy, xx, yy of one [N, W, "
                             f"H] shape, got {tuple(xy.shape)}, "
                             f"{tuple(xx.shape)}, {tuple(yy.shape)}")
        if mask is not None:
            raise ValueError("diagonal mode takes no mask")
        b1, b2 = xy.shape[0], 1
    else:
        b1, b2 = xy.shape[:2] if xy.ndim == 4 else (0, 0)
        if not (xy.ndim == 4 and xx.shape == (b1,) + xy.shape[2:]
                and yy.shape == (b2,) + xy.shape[2:]):
            raise ValueError(f"pair mode takes xy [Nx, Ny, W, H], xx [Nx, W,"
                             f" H], yy [Ny, W, H], got {tuple(xy.shape)}, "
                             f"{tuple(xx.shape)}, {tuple(yy.shape)}")
        if mask is not None and (mask.dtype != torch.bool
                                 or mask.shape != (b1, b2)
                                 or mask.device != xy.device):
            raise ValueError(f"mask must be bool [{b1}, {b2}] on "
                             f"{xy.device}, got {mask.dtype} "
                             f"{tuple(mask.shape)} on {mask.device}")
    xy, xx, yy = _contiguous(xy), _contiguous(xx), _contiguous(yy)
    if mask is not None:
        mask = _contiguous(mask)
    out = torch.empty(xy.shape, dtype=torch.float32, device=xy.device)
    s = xy.shape[-2] * xy.shape[-1]
    if mode == PAIR_FAST:
        table = _check_table(table, xx, yy)
    elif table is not None:
        raise ValueError("only a PAIR_FAST launch takes a factor table")
    err = _lib.cnn_gp_relu(
        xy.data_ptr(), xx.data_ptr(), yy.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), b1, b2,
        s, mode, exact, None if table is None else table.data_ptr(),
        xy.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ReLU kernel launch failed: cuda error {err} "
                           f"({_lib.error_string(err)})")
    launches += 1
    return out

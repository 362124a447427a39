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

The adjoint of the xy' map (the backward of the ReLU's autograd Function
and of the box filter's ReLU prologue) has a closed form, with theta and
sin(theta) computed as the forward computes them in each form:

    d xy'/d xy = (pi - theta) / (2 pi),
    d xy'/d xx = sqrt(yy / xx) sin(theta) / (4 pi),
    d xy'/d yy = sqrt(xx / yy) sin(theta) / (4 pi),

a same-example entry (xx / 2) sending half its cotangent to xx.  Its
plain version is ``relu_xy_vjp_reference``; on the card it is a second
hand-written kernel, ``csrc/arccos_vjp.cu`` (every mode, with or without
the mask, the side maps' sums over the pair grid reduced without float
atomics, so two runs give the same bits); ``vjp_launches`` counts its
launches.

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
           "relu_xy_vjp_reference", "relu_factors", "factor_table",
           "factor_table_entries", "factor_table_reference", "acos_f32",
           "F32_TINY", "check_method", "METHODS", "DEFAULT_METHOD", "build",
           "launches", "vjp_launches", "copies", "COUNTERS"]

launches = 0   # ReLU kernel launches
vjp_launches = 0   # launches of the adjoint kernel
COUNTERS = ("launches", "vjp_launches")
copies = 0     # inputs copied to make them contiguous before a launch
_lib = None
_scratch_sizes = (None, {})   # (the library, its scratch sizes by shape)

F32_TINY = float(np.finfo(np.float32).tiny)
_HALF_PI = math.pi / 2.0
# the JAX package's lowerings of the ReLU (settings.relu_method)
METHODS = ("auto", "xla")
DEFAULT_METHOD = "auto"   # settings.relu_method's default, as in JAX


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


def _adjoint(xy, xx, yy, acos_fn, fast: bool):
    """(xy', d xy'/d xy, d xy'/d xx, d xy'/d yy) elementwise on
    broadcastable xy, xx, yy, in the "fast" form (``_xy_update_factored``:
    xx + tiny and yy + tiny under the square roots, sin(theta) from
    cos(theta)) or the reference form (``_xy_update``: tiny added to xx *
    yy).  With P the product under the square root, d xy'/d P = sin(theta)
    / (4 pi sqrt(P)): no term that a clipped cosine would make infinite."""
    if fast:
        r_xx, s_xx = relu_factors(xx)
        r_yy, s_yy = relu_factors(yy)
        cos_theta = torch.clamp(xy * (r_xx * r_yy), -1.0, 1.0)
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                           min=0.0))
        pi_minus_theta = acos_fn(-cos_theta)
        out = ((s_xx * s_yy) * sin_theta + pi_minus_theta * xy) * (
            0.5 / math.pi)
        q = sin_theta * (0.25 / math.pi)
        return (out, pi_minus_theta * (0.5 / math.pi), (s_yy * r_xx) * q,
                (s_xx * r_yy) * q)
    xx_yy = xx * yy + F32_TINY
    r = torch.rsqrt(xx_yy)
    cos_theta = torch.clamp(xy * r, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(xx_yy - xy * xy, min=0.0))
    pi_minus_theta = math.pi - acos_fn(cos_theta)
    out = (sin_theta + pi_minus_theta * xy) * (0.5 / math.pi)
    d_p = (sin_theta * (r * r)) * (0.25 / math.pi)
    return out, pi_minus_theta * (0.5 / math.pi), yy * d_p, xx * d_p


def relu_xy_vjp_reference(g: torch.Tensor, xy: torch.Tensor,
                          xx: torch.Tensor, yy: torch.Tensor,
                          mask: Optional[torch.Tensor], diag: bool):
    """The VJP of ``relu_xy_reference(xy, xx, yy, mask, diag)`` against
    the cotangent ``g`` of xy', in closed form (``_adjoint``) under the
    ``settings.relu_impl`` and ``acos_impl`` of the forward: ``(g_xy,
    g_xx, g_yy)``.  A same-example entry (its xy' is xx / 2) sends half its
    cotangent to xx and none to xy or yy.  Pair mode sums over the pair
    grid: g_xx[i] over j, g_yy[j] over i; when yy is xx (a same block)
    both sums land in g_xx and g_yy is None.  The diagonal mode (the
    reference form) is elementwise.  Autograd of ``relu_xy_reference``
    agrees away from |cos(theta)| = 1, where its sqrt's and acos's
    infinite slopes cancel only in exact arithmetic (or make NaN at a
    clipped cosine)."""
    from .. import settings
    acos_fn = acos_f32 if settings.acos_impl == "poly" else torch.acos
    if diag:
        _, d_xy, d_xx, d_yy = _adjoint(xy, xx, yy, acos_fn, False)
        return g * d_xy, g * d_xx, g * d_yy
    if mask is not None:
        # the forward's neutral input for same-example entries
        xy = torch.where(mask[:, :, None, None], 0.0, xy)
    _, d_xy, d_xx, d_yy = _adjoint(xy, xx[:, None], yy[None, :], acos_fn,
                                   settings.relu_impl == "fast")
    g_xy, g_xx, g_yy = g * d_xy, g * d_xx, g * d_yy
    if mask is not None:
        m = mask[:, :, None, None]
        g_xy = torch.where(m, 0.0, g_xy)
        g_xx = torch.where(m, g * 0.5, g_xx)
        g_yy = torch.where(m, 0.0, g_yy)
    g_xx, g_yy = g_xx.sum(1), g_yy.sum(0)
    if _one_side(xx, yy):
        return g_xy, g_xx + g_yy, None
    return g_xy, g_xx, g_yy


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
    vjp_lib = cuda_lib.library("arccos_vjp")
    vjp = vjp_lib.cnn_gp_relu_vjp
    vjp.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_float, ctypes.c_void_p]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    vjp.restype = ctypes.c_int
    scratch = vjp_lib.cnn_gp_relu_vjp_scratch
    scratch.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    scratch.restype = ctypes.c_int
    _lib = types.SimpleNamespace(
        cnn_gp_relu=fn, cnn_gp_relu_vjp=vjp, cnn_gp_relu_vjp_scratch=scratch,
        error_string=lambda code: lib.cnn_gp_relu_error_string(
            code).decode())
    return seconds


def _forms():
    """The settings the kernel and its plain version read, as they stand:
    (mode of a pair launch, acosf instead of the polynomial, whether the
    forward ran under ``settings.grad_safe``, which a backward checks)."""
    from .. import settings
    mode = PAIR_FAST if settings.relu_impl == "fast" else PAIR_REFERENCE
    return mode, int(settings.acos_impl != "poly"), settings.grad_safe


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
    mode, exact, grad_safe = _forms()
    mode = DIAGONAL if diag else mode
    if torch.is_grad_enabled() and (xy.requires_grad or xx.requires_grad
                                    or yy.requires_grad):
        return _ReluXY.apply(mode, exact, grad_safe, mask, stream, xy, xx,
                             yy)
    return _launch(xy, xx, yy, mask, mode, exact, stream)


class _ReluXY(torch.autograd.Function):
    """The kernel as the forward; the backward one launch of the adjoint
    kernel (``_launch_vjp``) under the forms of the forward."""

    @staticmethod
    def forward(ctx, mode, exact, grad_safe, mask, stream, xy, xx, yy):
        ctx.mode, ctx.exact, ctx.stream = mode, exact, stream
        ctx.grad_safe = grad_safe
        ctx.save_for_backward(mask, xy, xx, yy)
        return _launch(xy, xx, yy, mask, mode, exact, stream)

    @staticmethod
    def backward(ctx, grad):
        mask, xy, xx, yy = ctx.saved_tensors
        check_grad_safe(mask, ctx.grad_safe)
        g_xy, g_xx, g_yy = _launch_vjp(
            grad, xy, xx, yy, mask, ctx.mode, ctx.exact, None,
            ctx.needs_input_grad[5:], None, None, None, ctx.stream)
        return (None,) * 5 + (g_xy, g_xx, g_yy)


def check_grad_safe(mask: Optional[torch.Tensor], grad_safe: bool) -> None:
    """Refuse the adjoint of a masked pair map whose forward ran without
    ``settings.grad_safe``: plain autograd's gradient is NaN there (0 *
    inf at the same-example entries), in both packages."""
    if mask is not None and not grad_safe:
        raise ValueError("the ReLU's adjoint of a masked pair map needs "
                         "settings.grad_safe=True in the forward (without it "
                         "plain autograd's gradient is NaN)")


def _vjp_reference(t, xy, xx, yy, mask, mode, exact, gscale, want, acc_xx,
                   acc_yy, dot):
    """What one launch of the adjoint kernel computes, in plain torch
    (``_launch_vjp``'s arguments, without the stream)."""
    from .. import settings
    g = t if gscale is None else t * gscale
    with settings.override(
            relu_impl="fast" if mode == PAIR_FAST else "reference",
            acos_impl="exact" if exact else "poly"):
        g_xy, g_xx, g_yy = relu_xy_vjp_reference(g, xy, xx, yy, mask,
                                                 mode == DIAGONAL)
        if dot is not None:
            dot += (t * relu_xy_reference(xy, xx, yy, mask,
                                          mode == DIAGONAL)).sum()
    if g_yy is None and acc_yy is not None:
        acc_xx = acc_yy if acc_xx is None else acc_xx + acc_yy
    if acc_xx is not None:
        g_xx = acc_xx + g_xx
    if acc_yy is not None and g_yy is not None:
        g_yy = acc_yy + g_yy
    return tuple(v if w else None for v, w in zip((g_xy, g_xx, g_yy), want))


def vjp_scratch(b1: int, b2: int, s: int, mode: int, device) -> int:
    """Floats of scratch that an adjoint launch on a [b1, b2, s] pair map
    (or b1 rows of a diagonal) reduces its sums through: the side maps'
    partial sums and the per-block partials of the dot product.  Builds
    the library; the library's answer is kept per sizes and device."""
    global _scratch_sizes
    build()
    key = (b1, b2, s, mode, torch.device(device).index or 0)
    if _scratch_sizes[0] is not _lib:
        _scratch_sizes = (_lib, {})
    if key not in _scratch_sizes[1]:
        n = ctypes.c_longlong()
        err = _lib.cnn_gp_relu_vjp_scratch(*key, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"ReLU adjoint: cuda error {err} "
                               f"({_lib.error_string(err)})")
        _scratch_sizes[1][key] = n.value
    return _scratch_sizes[1][key]


def _launch_vjp(t: torch.Tensor, xy: torch.Tensor, xx: torch.Tensor,
                yy: torch.Tensor, mask: Optional[torch.Tensor], mode: int,
                exact: int, gscale, want, acc_xx: Optional[torch.Tensor],
                acc_yy: Optional[torch.Tensor], dot: Optional[torch.Tensor],
                stream):
    """One launch of the adjoint kernel (``csrc/arccos_vjp.cu``) on
    ``stream``: the xy' map's cotangent is ``t * gscale`` (``gscale`` a
    float, a float32 0-d tensor, or None for 1); returns ``(g_xy, g_xx,
    g_yy)`` as ``relu_xy_vjp_reference`` does, each None where ``want``
    says so, with ``acc_xx`` / ``acc_yy`` (when given) added to the side
    maps' sums; ``dot`` (a float32 0-d tensor on the card, or None) gets
    sum(t * xy') added, the part of a ``Conv2d``'s d scale that reads the
    ReLU's output.  When yy is xx both side sums land in g_xx (and
    ``acc_yy`` with them), and g_yy is None."""
    global vjp_launches
    for name, v in (("t", t), ("xy", xy), ("xx", xx), ("yy", yy)):
        if v.dtype != torch.float32 or v.device != xy.device:
            raise ValueError(f"{name} must be float32 on {xy.device}, got "
                             f"{v.dtype} on {v.device}")
    if t.shape != xy.shape:
        raise ValueError(f"the cotangent {tuple(t.shape)} differs from xy "
                         f"{tuple(xy.shape)}")
    if mode == DIAGONAL:
        if mask is not None or dot is not None:
            raise ValueError("diagonal mode takes no mask and no dot")
        if not xy.shape == xx.shape == yy.shape:
            raise ValueError("diagonal mode takes xy, xx, yy of one shape")
        b1, b2 = xy.shape[0], 1
    else:
        b1, b2 = xy.shape[:2]
        if xx.shape != (b1,) + xy.shape[2:] or yy.shape != (
                b2,) + xy.shape[2:]:
            raise ValueError(f"pair mode takes xy [Nx, Ny, W, H], xx [Nx, W,"
                             f" H], yy [Ny, W, H], got {tuple(xy.shape)}, "
                             f"{tuple(xx.shape)}, {tuple(yy.shape)}")
        if mask is not None and (mask.dtype != torch.bool
                                 or mask.shape != (b1, b2)
                                 or mask.device != xy.device):
            raise ValueError(f"mask must be bool [{b1}, {b2}] on "
                             f"{xy.device}")
    one_side = mode != DIAGONAL and _one_side(xx, yy)
    if one_side and acc_yy is not None:
        acc_xx = acc_yy if acc_xx is None else acc_xx + acc_yy
        acc_yy = None
    # one copy of a same block's side map, so the launch sees yy is xx
    t, xy, xx = (_contiguous(v) for v in (t, xy, xx))
    yy = xx if one_side else _contiguous(yy)
    mask = None if mask is None else _contiguous(mask)
    accs = [None if a is None else _contiguous(a) for a in (acc_xx, acc_yy)]
    for a, side in zip(accs, (xx, yy)):
        if a is not None and (a.shape != side.shape
                              or a.dtype != torch.float32
                              or a.device != xy.device):
            raise ValueError("an accumulator takes its side map's shape")
    s = xy.shape[-2] * xy.shape[-1]
    want = [bool(want[0]), bool(want[1]),
            bool(want[2]) and not one_side]
    outs = [torch.empty(v.shape, dtype=torch.float32, device=xy.device)
            if w else None for v, w in zip((xy, xx, yy), want)]
    scratch = torch.empty(vjp_scratch(b1, b2, s, mode, xy.device),
                          dtype=torch.float32, device=xy.device)
    from .boxfilter import _operand   # read as the box filter's scale is
    gscale_v, gscale_p = ((1.0, None) if gscale is None
                          else _operand(gscale, xy.device))

    def ptr(v):
        return None if v is None else v.data_ptr()
    err = _lib.cnn_gp_relu_vjp(
        t.data_ptr(), xy.data_ptr(), xx.data_ptr(), yy.data_ptr(),
        ptr(mask), *(ptr(o) for o in outs), *(ptr(a) for a in accs),
        scratch.data_ptr(), ptr(dot), gscale_v, gscale_p, b1, b2, s, mode,
        exact, xy.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ReLU adjoint launch failed: cuda error {err} "
                           f"({_lib.error_string(err)})")
    vjp_launches += 1
    return tuple(outs)


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
    one_side = mode != DIAGONAL and _one_side(xx, yy)
    xy, xx = _contiguous(xy), _contiguous(xx)
    yy = xx if one_side else _contiguous(yy)
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

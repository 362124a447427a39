"""Strided/dilated box filters: the NNGP Conv2d covariance op.

PyTorch counterpart of ``cnn_gp_tpu/ops/boxfilter.py``.  A conv with a
constant ``var_weight / k**2`` kernel is a scaled windowed sum, so no
weight tensor is built.  The plain version, ``box_filter_2d_reference``,
is the separable shift-sum of ``cnn_gp_tpu/ops/boxfilter.py::_shift_sum_1d``:
per axis, zero padding ``(lo, hi)`` and then ``k`` strided slices added
together.  ``conv_maps_reference`` applies it, then the scale and the
bias, to the fields of a ``Conv2d``.

On the card the same functions are one hand-written CUDA kernel,
``csrc/boxfilter.cu``, bit-equal to the plain version: ``conv_maps`` runs
all of a ``Conv2d``'s fields (the xy pair map and the xx / yy side maps)
in one launch, ``box_filter_2d`` one map without the scale and bias.
Both run the plain version for CPU tensors and launch the kernel for CUDA
tensors, or raise.  The same kernel also runs the fused ResNet layer of
``ops/layer.py`` (the ReLU in its prologue, the ``Sum`` add in its
epilogue; ``_launch_layer``).  ``launches`` counts every launch of the
kernel; ``prologue_launches`` and ``epilogue_launches`` count those with
the ReLU prologue and with the skip epilogue; ``copies`` counts inputs
that were not contiguous and were copied before a launch.

The adjoint (the backward of ``conv_maps`` and of the fused layer) is a
second hand-written kernel, ``csrc/boxfilter_vjp.cu``: per axis the
transposed shift-sum (each output's cotangent sent back to the k input
pixels its window read, the padding dropped), times the scale, with the
leaf gradients d scale = sum <box^T(g), a> and d bias = sum g reduced in
the same launch.  Its plain version is ``box_filter_2d_vjp_reference``
per map and ``_vjp_reference`` for a launch's maps, scale and leaf sums;
``vjp_launches`` counts its launches.

``settings.conv_method`` names the JAX package's lowering of the box
filter; the port has one lowering, which computes each of them, and
refuses an unknown name as JAX does (``check_method``).

It deliberately avoids ``F.conv2d``: cuDNN runs float32 convolutions in
TF32 by default, which keeps about three decimal digits.
"""

from __future__ import annotations

import ctypes
import struct
import types
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import arccos, cuda_lib

__all__ = ["same_padding", "resolve_padding", "out_size", "box_filter_2d",
           "box_filter_2d_reference", "conv_maps", "conv_maps_reference",
           "box_filter_2d_vjp_reference",
           "check_method", "METHODS", "build", "launches",
           "prologue_launches", "epilogue_launches", "vjp_launches",
           "copies"]

PadT = Tuple[int, int]
Operand = Union[None, float, torch.Tensor]

launches = 0            # box-filter kernel launches, every form
prologue_launches = 0   # of them, with the ReLU prologue
epilogue_launches = 0   # of them, with the skip epilogue
vjp_launches = 0        # launches of the adjoint kernel
copies = 0     # inputs copied to make them contiguous before a launch
_lib = None
_partials_sizes = (None, {})   # (the library, its partials sizes by shape)

# the JAX package's lowerings of the box filter (settings.conv_method)
METHODS = ("shifts", "separable", "direct", "matmul")
# what a fused launch's prologue does to a map (csrc/boxfilter.cu)
AS_IS, HALF, RELU = 0, 1, 2


def check_method() -> None:
    """Raise ``ValueError`` on an unknown ``settings.conv_method``, as
    ``cnn_gp_tpu/ops/boxfilter.py::box_filter_2d`` does."""
    from .. import settings
    if settings.conv_method not in METHODS:
        raise ValueError(
            f"unknown box filter method {settings.conv_method!r}")


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


class Geometry(NamedTuple):
    """One box filter: window, stride, (lo, hi) padding, dilation."""
    kernel_size: int
    stride: int
    pad: PadT
    dilation: int

    @classmethod
    def of(cls, kernel_size, stride=1, padding=0, dilation=1) -> "Geometry":
        return cls(int(kernel_size), int(stride),
                   resolve_padding(padding, kernel_size, dilation),
                   int(dilation))

    def out_shape(self, w: int, h: int) -> Tuple[int, int]:
        k, s, p, d = self
        return out_size(w, k, s, p, d), out_size(h, k, s, p, d)


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


def box_filter_2d_reference(x: torch.Tensor, kernel_size: int,
                            stride: int = 1,
                            padding: Union[str, int, PadT] = 0,
                            dilation: int = 1) -> torch.Tensor:
    """Windowed sum over the trailing two dims of ``x`` ([..., W, H]) in
    plain torch: the W slices, then the H slices, each added in order."""
    check_method()
    pad = resolve_padding(padding, kernel_size, dilation)
    y = _shift_sum_1d(x, x.ndim - 2, kernel_size, stride, pad, dilation)
    return _shift_sum_1d(y, x.ndim - 1, kernel_size, stride, pad, dilation)


def _plain(geom: Geometry, maps: Sequence[torch.Tensor], scale: Operand,
           bias: Operand) -> List[torch.Tensor]:
    out = [box_filter_2d_reference(a, *geom) for a in maps]
    if scale is None:
        return out
    return [o * scale + bias for o in out]


def conv_maps_reference(maps: Sequence[torch.Tensor], kernel_size: int,
                        stride: int, padding: Union[str, int, PadT],
                        dilation: int, scale: Union[float, torch.Tensor],
                        bias: Union[float, torch.Tensor]
                        ) -> List[torch.Tensor]:
    """``box_filter_2d_reference(a) * scale + bias`` for each map ``a``:
    the plain ``Conv2d`` covariance map."""
    return _plain(Geometry.of(kernel_size, stride, padding, dilation), maps,
                  scale, bias)


def _shift_sum_1d_vjp(g: torch.Tensor, dim: int, length: int, k: int,
                      stride: int, pad: PadT, dilation: int) -> torch.Tensor:
    """The adjoint of ``_shift_sum_1d`` along ``dim`` (whose input had
    ``length`` entries there): each of the k strided slices of ``g`` added
    back into the zero-padded axis, tap by tap in order, then the padding
    dropped."""
    shape = list(g.shape)
    shape[dim] = length + pad[0] + pad[1]
    buf = g.new_zeros(shape)
    head = (slice(None),) * dim
    n_out = g.shape[dim]
    for a in range(k):
        start = a * dilation
        buf[head + (slice(start, start + (n_out - 1) * stride + 1,
                          stride),)] += g
    return buf.narrow(dim, pad[0], length)


def box_filter_2d_vjp_reference(g: torch.Tensor, size: Tuple[int, int],
                                kernel_size: int, stride: int = 1,
                                padding: Union[str, int, PadT] = 0,
                                dilation: int = 1) -> torch.Tensor:
    """The adjoint of ``box_filter_2d_reference`` on [..., W, H] inputs
    of ``size`` (W, H), in plain torch: ``g`` [..., Wo, Ho] sent back
    through the H slices, then the W slices (the forward's passes in
    reverse).  sum <box^T(g), a> = sum <g, box(a)> for every a."""
    check_method()
    pad = resolve_padding(padding, kernel_size, dilation)
    w, h = size
    u = _shift_sum_1d_vjp(g, g.ndim - 1, h, kernel_size, stride, pad,
                          dilation)
    return _shift_sum_1d_vjp(u, g.ndim - 2, w, kernel_size, stride, pad,
                             dilation)


def _vjp_reference(geom: Geometry, grads: Sequence[torch.Tensor],
                   maps: Sequence[torch.Tensor], modes: Sequence[int],
                   want: Sequence[bool], scale: Operand, leaves: bool):
    """What one launch of the adjoint kernel computes, in plain torch
    (``_launch_vjp``'s arguments, without the stream): for map f, t =
    box^T(grads[f]) and its input cotangent ``t * scale`` (``AS_IS``),
    ``t * scale * 0.5`` (``HALF``: the map was halved before the filter)
    or t itself (``RELU``: the ReLU's adjoint takes it on), None where
    ``want[f]`` is False; with ``leaves``, d scale = sum_f <t_f, the
    filtered map> over the maps that are not ``RELU`` (the ReLU's adjoint
    adds its own) and d bias = sum_f sum grads[f], as 0-d float32
    tensors (else None)."""
    outs, dscale, dbias = [], None, None
    for g, a, mode, wanted in zip(grads, maps, modes, want):
        t = box_filter_2d_vjp_reference(g, tuple(a.shape[-2:]), *geom)
        if mode == RELU:
            out = t
        else:
            out = t if scale is None else t * scale
            if mode == HALF:
                out = out * 0.5
                a = a * 0.5
            if leaves:
                dot = (t * a).sum()
                dscale = dot if dscale is None else dscale + dot
        outs.append(out if wanted else None)
        if leaves:
            dbias = g.sum() if dbias is None else dbias + g.sum()
    if leaves and dscale is None:
        dscale = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    return outs, dscale, dbias


def box_filter_2d(x: torch.Tensor, kernel_size: int, stride: int = 1,
                  padding: Union[str, int, PadT] = 0,
                  dilation: int = 1) -> torch.Tensor:
    """Windowed sum over the trailing two dims of ``x`` ([..., W, H]):
    the plain version for a CPU tensor, one kernel launch for a CUDA
    tensor (or the call raises)."""
    if x.device.type == "cpu":
        return box_filter_2d_reference(x, kernel_size, stride, padding,
                                       dilation)
    return _on_card(Geometry.of(kernel_size, stride, padding, dilation),
                    [x], None, None)[0]


def conv_maps(maps: Sequence[torch.Tensor], kernel_size: int, stride: int,
              padding: Union[str, int, PadT], dilation: int,
              scale: Union[float, torch.Tensor],
              bias: Union[float, torch.Tensor]) -> List[torch.Tensor]:
    """The ``Conv2d`` covariance map of one to three fields ([..., W, H]
    float32 each, on one device): ``box(a) * scale + bias``.  ``scale`` is
    ``var_weight / k**2`` as the layer computes it, a float or (for a
    learnable leaf) a float32 tensor; ``bias`` likewise.  CPU tensors run
    ``conv_maps_reference``; CUDA tensors launch the kernel once for all
    the fields (or the call raises).  Under autograd, the launch is the
    forward of a ``torch.autograd.Function`` whose backward differentiates
    the plain version."""
    if maps[0].device.type == "cpu":
        return conv_maps_reference(maps, kernel_size, stride, padding,
                                   dilation, scale, bias)
    return _on_card(Geometry.of(kernel_size, stride, padding, dilation),
                    list(maps), scale, bias)


def build() -> float:
    """Build and load the kernel libraries (``cuda_lib.build``) and bind
    this module's entry point.  Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    seconds = cuda_lib.build()
    lib = cuda_lib.library("boxfilter")
    layer = lib.cnn_gp_conv_layer
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    layer.argtypes = ([ptr, ptr, ptr, i64, i32] * 3 + [ptr] * 3
                      + [i32] * 12 + [f32] * 2 + [ptr] * 3
                      + [i32, i32, ptr])
    layer.restype = ctypes.c_int
    plan_fn = lib.cnn_gp_box_filter_plan
    plan_fn.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
    plan_fn.restype = None
    lib.cnn_gp_box_filter_error_string.argtypes = [ctypes.c_int]
    lib.cnn_gp_box_filter_error_string.restype = ctypes.c_char_p
    vjp_lib = cuda_lib.library("boxfilter_vjp")
    vjp = vjp_lib.cnn_gp_box_filter_vjp
    vjp.argtypes = ([ptr, ptr, ptr, i64, i32] * 3 + [i32] * 8
                    + [f32, ptr, i32, ptr, ptr, ptr, i32, ptr])
    vjp.restype = ctypes.c_int
    partials = vjp_lib.cnn_gp_box_filter_vjp_partials
    partials.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int)]
    partials.restype = ctypes.c_int
    _lib = types.SimpleNamespace(
        cnn_gp_conv_layer=layer, cnn_gp_box_filter_plan=plan_fn,
        cnn_gp_box_filter_vjp=vjp, cnn_gp_box_filter_vjp_partials=partials,
        error_string=lambda code: lib.cnn_gp_box_filter_error_string(
            code).decode())
    return seconds


def plan(w: int, h: int, wo: int, ho: int, skip: bool) -> Tuple[int, int]:
    """(planes per run, dynamic shared memory bytes) of the staged kernel
    for [w, h] planes filtered to [wo, ho], with a skip or not; (0, 0)
    when the planes take the unstaged kernel.  Builds the library."""
    build()
    ppr, smem = ctypes.c_int(), ctypes.c_int()
    _lib.cnn_gp_box_filter_plan(w, h, wo, ho, int(skip), ctypes.byref(ppr),
                                ctypes.byref(smem))
    return ppr.value, smem.value


def _requires_grad(t) -> bool:
    return isinstance(t, torch.Tensor) and t.requires_grad


def _on_card(geom: Geometry, maps: List[torch.Tensor], scale: Operand,
             bias: Operand) -> List[torch.Tensor]:
    """The CUDA route: launch the kernel or raise."""
    check_method()
    if maps[0].device.type != "cuda":
        raise ValueError(f"the box-filter kernel runs on cuda tensors, not "
                         f"on {maps[0].device}")
    build()
    return _route(geom, maps, scale, bias,
                  torch.cuda.current_stream(maps[0].device).cuda_stream)


def _route(geom: Geometry, maps: List[torch.Tensor], scale: Operand,
           bias: Operand, stream) -> List[torch.Tensor]:
    """The launch, through ``_ConvMaps`` where a gradient is wanted."""
    if torch.is_grad_enabled() and any(
            _requires_grad(t) for t in (scale, bias, *maps)):
        return list(_ConvMaps.apply(geom, stream, scale, bias, *maps))
    return _launch(geom, maps, scale, bias, stream)


class _ConvMaps(torch.autograd.Function):
    """The kernel as the forward; the backward one launch of the adjoint
    kernel (``_launch_vjp``): the maps' cotangents and the leaf gradients
    of the scale and the bias."""

    @staticmethod
    def forward(ctx, geom, stream, scale, bias, *maps):
        ctx.geom, ctx.stream = geom, stream
        ctx.scale = None if isinstance(scale, torch.Tensor) else scale
        ctx.leaf_devices = _leaf_devices(scale, bias)
        ctx.save_for_backward(
            scale if isinstance(scale, torch.Tensor) else None, *maps)
        return tuple(_launch(geom, list(maps), scale, bias, stream))

    @staticmethod
    def backward(ctx, *grads):
        scale, *maps = ctx.saved_tensors
        scale = ctx.scale if scale is None else scale
        n_scale, n_bias, *want = ctx.needs_input_grad[2:]
        outs, dscale, dbias = _launch_vjp(
            ctx.geom, list(grads), maps, [AS_IS] * len(maps), want, scale,
            n_scale or n_bias, ctx.stream)
        return (None, None) + _leaf_grads(ctx.leaf_devices, (n_scale, n_bias),
                                         (dscale, dbias)) + tuple(outs)


def _leaf_devices(scale: Operand, bias: Operand):
    """The devices of the scale and the bias that are tensors (None for
    a float): where their gradients go."""
    return tuple(t.device if isinstance(t, torch.Tensor) else None
                 for t in (scale, bias))


def _leaf_grads(devices, needs, grads) -> tuple:
    """(d scale, d bias) as autograd wants them: each on its operand's
    device, None where it is not wanted."""
    return tuple(g.to(dev) if need else None
                 for dev, need, g in zip(devices, needs, grads))


def _f32(v: float) -> float:
    """``v`` rounded to float32, as torch rounds a Python scalar operand
    of a float32 tensor."""
    return struct.unpack("f", struct.pack("f", float(v)))[0]


def _operand(v: Operand, device: torch.device
             ) -> Tuple[float, Optional[int]]:
    """(value, card pointer) of the scale or the bias: a float rounded to
    float32; a float32 0-d tensor read on the host if it lies there, else
    passed by its pointer (no synchronisation)."""
    if v is None:
        return 0.0, None
    if not isinstance(v, torch.Tensor):
        return _f32(v), None
    if v.dtype != torch.float32 or v.numel() != 1:
        raise ValueError(f"scale and bias must be floats or float32 "
                         f"scalars, got {v.dtype} {tuple(v.shape)}")
    if v.device.type == "cpu":
        return float(v), None
    if v.device != device:
        raise ValueError(f"scale or bias on {v.device}, maps on {device}")
    return 0.0, v.data_ptr()


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    global copies
    if t.is_contiguous():
        return t
    copies += 1
    return t.contiguous()


def _launch(geom: Geometry, maps: List[torch.Tensor], scale: Operand,
            bias: Operand, stream) -> List[torch.Tensor]:
    """One kernel launch over every map (three at most) on ``stream``, no
    prologue and no skip; returns the new output maps."""
    return _launch_layer(geom, maps, [AS_IS] * len(maps), [None] * len(maps),
                         None, scale, bias, stream)


def _launch_layer(geom: Geometry, maps: List[torch.Tensor],
                  prologues: List[int], skips: List[Optional[torch.Tensor]],
                  side, scale: Operand, bias: Operand, stream,
                  runtime_geometry: bool = False) -> List[torch.Tensor]:
    """One launch of the kernel on ``stream``: map f (up to three) through
    its prologue (``AS_IS``, ``HALF`` or ``RELU``), the box filter, the
    scale and bias (none when ``scale`` is None) and, where ``skips[f]``
    is a tensor of the output's shape, the skip added.  ``side`` is
    ``(xx, yy, mask, form, exact)`` for a ``RELU`` prologue (map 0 a
    [bx, bz, W, H] pair map; xx [bx, W, H] and yy [bz, W, H] its
    pre-ReLU side maps; mask [bx, bz] bool or None; form 0 "fast", 1
    "reference"; exact: acosf) and None otherwise.  A "fast" ReLU
    prologue fills and reads a factor table of xx and yy
    (``arccos.factor_table``, allocated here) inside the launch.
    ``runtime_geometry`` takes the kernel with run-time indices even
    where the geometry has a fixed instantiation (to time the two).
    Returns the new output maps."""
    global launches, prologue_launches, epilogue_launches
    if not 1 <= len(maps) <= 3:
        raise ValueError(f"one to three maps per launch, got {len(maps)}")
    device = maps[0].device
    w, h = maps[0].shape[-2:]
    for a in maps:
        if a.dtype != torch.float32 or a.ndim < 2:
            raise ValueError(f"maps must be float32 [..., W, H], got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != device or a.shape[-2:] != (w, h):
            raise ValueError(f"maps differ: {a.device} {tuple(a.shape)} "
                             f"against {device} [..., {w}, {h}]")
    wo, ho = geom.out_shape(w, h)
    if wo < 1 or ho < 1:
        raise ValueError(f"{geom} leaves no output of a {w}x{h} map")
    if len(prologues) != len(maps) or len(skips) != len(maps):
        raise ValueError("one prologue and one skip (or None) per map")
    relu = RELU in prologues
    if relu != (side is not None) or any(
            p not in (AS_IS, HALF, RELU) for p in prologues):
        raise ValueError(f"prologues {prologues} and side operands "
                         f"{'given' if side is not None else 'none'} "
                         f"disagree")
    bz = 0
    if relu:
        xx, yy, mask, form, exact = side
        if prologues.index(RELU) != 0 or prologues.count(RELU) != 1:
            raise ValueError("the ReLU prologue runs on map 0 alone")
        xy = maps[0]
        bx, bz = xy.shape[:2] if xy.ndim == 4 else (0, 0)
        for name, t in (("xx", xx), ("yy", yy)):
            if t.dtype != torch.float32 or t.device != device:
                raise ValueError(f"{name} must be float32 on {device}, got "
                                 f"{t.dtype} on {t.device}")
        if not (xy.ndim == 4 and xx.shape == (bx, w, h)
                and yy.shape == (bz, w, h)):
            raise ValueError(f"the ReLU prologue takes xy [Nx, Ny, W, H], "
                             f"xx [Nx, W, H], yy [Ny, W, H], got "
                             f"{tuple(xy.shape)}, {tuple(xx.shape)}, "
                             f"{tuple(yy.shape)}")
        if mask is not None and (mask.dtype != torch.bool
                                 or mask.shape != (bx, bz)
                                 or mask.device != device):
            raise ValueError(f"mask must be bool [{bx}, {bz}] on {device}, "
                             f"got {mask.dtype} {tuple(mask.shape)} on "
                             f"{mask.device}")
        # held until the launch: a copy freed earlier could be reused
        # one copy of a same block's side map, so the launch sees yy is xx
        one_side = arccos._one_side(xx, yy)
        xx = _contiguous(xx)
        yy = xx if one_side else _contiguous(yy)
        side = [xx, yy, None if mask is None else _contiguous(mask)]
        table = (arccos.factor_table(xx, yy) if form == arccos.PAIR_FAST
                 else None)
    else:
        side, form, exact, table = [None, None, None], 0, 0, None
    maps = [_contiguous(a) for a in maps]
    outs = [torch.empty(a.shape[:-2] + (wo, ho), dtype=torch.float32,
                        device=device) for a in maps]
    for o, s in zip(outs, skips):
        if s is not None and (s.dtype != torch.float32 or s.device != device
                              or s.shape != o.shape):
            raise ValueError(f"a skip must be float32 {tuple(o.shape)} on "
                             f"{device}, got {s.dtype} {tuple(s.shape)} on "
                             f"{s.device}")
    skips = [None if s is None else _contiguous(s) for s in skips]
    slots = []
    for f in range(3):
        if f < len(maps):
            slots += [maps[f].data_ptr(),
                      None if skips[f] is None else skips[f].data_ptr(),
                      outs[f].data_ptr(), maps[f].numel() // (w * h),
                      prologues[f]]
        else:
            slots += [None, None, None, 0, AS_IS]
    scale_v, scale_p = _operand(scale, device)
    bias_v, bias_p = _operand(bias, device)
    k, s, (lo, _), d = geom
    err = _lib.cnn_gp_conv_layer(
        *slots, *[None if t is None else t.data_ptr() for t in side], bz,
        form, exact, w, h, wo, ho, k, s, lo, d, int(scale is not None),
        scale_v, bias_v, scale_p, bias_p,
        None if table is None else table.data_ptr(), int(runtime_geometry),
        device.index, stream)
    if err != 0:
        raise RuntimeError(f"box-filter kernel launch failed: cuda error "
                           f"{err} ({_lib.error_string(err)})")
    launches += 1
    prologue_launches += relu
    epilogue_launches += any(s is not None for s in skips)
    return outs


def vjp_partials(w: int, h: int, wo: int, ho: int, device) -> int:
    """Floats of the per-block partial sums that an adjoint launch over
    [w, h] planes filtered to [wo, ho] reduces its leaf gradients through
    (two per block of its persistent grid).  Builds the library; the
    library's answer is kept per sizes and device."""
    global _partials_sizes
    build()
    key = (w, h, wo, ho, torch.device(device).index or 0)
    if _partials_sizes[0] is not _lib:
        _partials_sizes = (_lib, {})
    if key not in _partials_sizes[1]:
        n = ctypes.c_int()
        err = _lib.cnn_gp_box_filter_vjp_partials(*key, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"box-filter adjoint: cuda error {err} "
                               f"({_lib.error_string(err)})")
        _partials_sizes[1][key] = n.value
    return _partials_sizes[1][key]


def _launch_vjp(geom: Geometry, grads: List[torch.Tensor],
                maps: List[torch.Tensor], modes: List[int],
                want: Sequence[bool], scale: Operand, leaves: bool, stream):
    """One launch of the adjoint kernel (``csrc/boxfilter_vjp.cu``) on
    ``stream`` over up to three maps; computes what ``_vjp_reference``
    does: the input cotangent of map f where ``want[f]`` (of mode
    ``AS_IS``, ``HALF`` or ``RELU``, as there), and with ``leaves`` the
    leaf gradients d scale and d bias as 0-d float32 tensors on the card,
    reduced in the same launch through per-block partial sums.  A map
    that is not wanted and takes no part in d scale is read for d bias
    alone."""
    global vjp_launches
    if not 1 <= len(maps) == len(grads) == len(modes) == len(want) <= 3:
        raise ValueError("one to three maps, each with its cotangent, mode "
                         "and flag")
    device = maps[0].device
    w, h = maps[0].shape[-2:]
    wo, ho = geom.out_shape(w, h)
    for a, g, mode in zip(maps, grads, modes):
        if a.dtype != torch.float32 or g.dtype != torch.float32:
            raise ValueError(f"maps and cotangents must be float32, got "
                             f"{a.dtype} and {g.dtype}")
        if a.device != device or g.device != device:
            raise ValueError(f"maps and cotangents on {a.device} and "
                             f"{g.device}, map 0 on {device}")
        if a.shape[-2:] != (w, h) or g.shape != a.shape[:-2] + (wo, ho):
            raise ValueError(f"a map {tuple(a.shape)} takes a cotangent of "
                             f"{tuple(a.shape[:-2] + (wo, ho))}, got "
                             f"{tuple(g.shape)}")
        if mode not in (AS_IS, HALF, RELU):
            raise ValueError(f"unknown mode {mode}")
    grads = [_contiguous(g) for g in grads]
    maps = [_contiguous(a) for a in maps]
    outs = [torch.empty(a.shape, dtype=torch.float32, device=device)
            if wanted else None for a, wanted in zip(maps, want)]
    dscale = dbias = partials = None
    if leaves:
        sums = torch.empty(2, dtype=torch.float32, device=device)
        dscale, dbias = sums[0], sums[1]
        partials = torch.empty(vjp_partials(w, h, wo, ho, device),
                               dtype=torch.float32, device=device)
    slots = []
    for f in range(3):
        if f < len(maps):
            slots += [grads[f].data_ptr(), maps[f].data_ptr(),
                      None if outs[f] is None else outs[f].data_ptr(),
                      maps[f].numel() // (w * h), modes[f]]
        else:
            slots += [None, None, None, 0, AS_IS]
    scale_v, scale_p = _operand(scale, device)
    k, s, (lo, _), d = geom
    err = _lib.cnn_gp_box_filter_vjp(
        *slots, w, h, wo, ho, k, s, lo, d, scale_v, scale_p,
        int(scale is not None),
        None if dscale is None else dscale.data_ptr(),
        None if dbias is None else dbias.data_ptr(),
        None if partials is None else partials.data_ptr(), device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"box-filter adjoint launch failed: cuda error "
                           f"{err} ({_lib.error_string(err)})")
    vjp_launches += 1
    return outs, dscale, dbias

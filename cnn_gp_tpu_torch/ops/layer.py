"""The fused ResNet layer: one ``Conv2d`` with the ``ReLU`` before it and
the ``Sum`` add after it.

    conv_layer(kp, conv, relu, skip)
        = skip + conv(relu(kp))     (relu and skip each optional)

The JAX package leaves this to XLA, which fuses a tile's box filters,
ReLU transforms and ``Sum`` adds (``cnn_gp_tpu/kernels.py::apply_kernel``
under ``_kernel_jit``).  The plain version, ``conv_layer_reference``, is
the unfused chain: ``relu_transform_reference`` (when ``relu``), then the
``Conv2d``'s ``conv_maps_reference``, then ``skip + out``, the order of
``Sum.propagate``'s add.  On the card the whole layer is one launch of
the box-filter kernel (``csrc/boxfilter.cu``): the ReLU of its input in
the prologue (xy' from the pre-ReLU xy, xx and yy, the side maps halved),
the skip added in the epilogue, bit-equal to the plain chain.
``conv_layer`` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, or raises; under autograd the launch is the
forward of a ``torch.autograd.Function`` whose backward launches the
adjoint kernels: the skip's cotangent passes through as it is, one launch
of the box filter's adjoint (``csrc/boxfilter_vjp.cu``) takes the output
cotangents back through the filter and reduces d scale and d bias, and,
with the prologue, one launch of the ReLU's adjoint (``csrc/arccos_vjp.cu``)
takes the xy map's share on through the ReLU from the saved pre-ReLU xy,
xx and yy, adding its share of d scale (the ReLU's output is not kept:
the adjoint recomputes it).  Its plain version is
``conv_layer_vjp_reference``, the same steps on the two plain VJPs.  The
launch counts are ``boxfilter.launches`` (every box-filter launch),
``boxfilter.prologue_launches`` and ``boxfilter.epilogue_launches``; the
backward's are ``boxfilter.vjp_launches`` and ``arccos.vjp_launches``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..kernel_patch import KernelPatch
from . import arccos, boxfilter

__all__ = ["conv_layer", "conv_layer_reference", "conv_layer_vjp_reference"]


def _add(skip: Optional[KernelPatch], out: KernelPatch) -> KernelPatch:
    return out if skip is None else skip + out


def _geometry(conv) -> boxfilter.Geometry:
    return boxfilter.Geometry.of(conv.kernel_size, conv.stride,
                                 conv.pad_lo_hi, conv.dilation)


def _operands(conv):
    """(scale, bias) of a ``Conv2d`` as its ``propagate`` forms them."""
    k = conv.kernel_size
    return conv.var_weight / (k * k), conv.var_bias


def _reference(kp: KernelPatch, geom: boxfilter.Geometry, scale, bias,
               relu: bool, skip: Optional[KernelPatch]) -> KernelPatch:
    if relu:
        kp = arccos.relu_transform_reference(kp)
    # yy is xx after a ReLU of a same block: filtered once
    maps = [kp.xy, kp.xx] + ([] if kp.yy is kp.xx else [kp.yy])
    out = boxfilter.conv_maps_reference(maps, *geom, scale, bias)
    return _add(skip, KernelPatch(out[0], out[1], out[-1], kp.same,
                                  kp.diag, kp.diag_mask))


def conv_layer_reference(kp: KernelPatch, conv, relu: bool = False,
                         skip: Optional[KernelPatch] = None) -> KernelPatch:
    """The layer in plain torch: ``conv_maps_reference`` with ``conv``'s
    geometry, scale and bias (a ``kernels.Conv2d``, as its ``propagate``
    forms them) of ``relu_transform_reference(kp)`` (when ``relu``) or of
    ``kp``, then ``skip + out``."""
    return _reference(kp, _geometry(conv), *_operands(conv), relu, skip)


def conv_layer(kp: KernelPatch, conv, relu: bool = False,
               skip: Optional[KernelPatch] = None) -> KernelPatch:
    """The layer: ``conv_layer_reference`` for CPU tensors; for CUDA
    tensors one launch of the box-filter kernel with the ReLU in its
    prologue and the skip in its epilogue (or the call raises).  The
    prologue takes pair patches (``kp.diag`` False)."""
    if kp.xy.device.type == "cpu":
        return conv_layer_reference(kp, conv, relu, skip)
    boxfilter.check_method()
    if relu:
        arccos.check_method()
    if kp.xy.device.type != "cuda":
        raise ValueError(f"the box-filter kernel runs on cuda tensors, not "
                         f"on {kp.xy.device}")
    boxfilter.build()
    return _route(kp, conv, relu, skip,
                  torch.cuda.current_stream(kp.xy.device).cuda_stream)


class _Spec(NamedTuple):
    """What a launch computes, besides its tensors."""
    geom: boxfilter.Geometry
    relu: bool
    same: bool
    diag_mask: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]   # the resolved same-example mask
    n_out: int                     # 2: yy' is xx' (filtered once)
    third_xx: bool                 # the third map filtered is xx
    form: int                      # arccos.PAIR_FAST / PAIR_REFERENCE
    exact: int
    grad_safe: bool                # of the forward, for the backward


def _spec(kp: KernelPatch, conv, relu: bool,
          skip: Optional[KernelPatch]) -> _Spec:
    # yy' is xx' after the ReLU of a same block, and a map that is xx is
    # filtered once, as in Conv2d.propagate; the skip's yy, when it is not
    # its xx, makes a third map all the same
    form, exact, grad_safe = arccos._forms()
    one_side = (kp.same if relu else kp.yy is kp.xx)
    one_skip = skip is None or skip.yy is skip.xx
    return _Spec(_geometry(conv), relu, kp.same, kp.diag_mask,
                 kp.resolve_diag_mask() if relu else None,
                 2 if one_side and one_skip else 3, one_side, form, exact,
                 grad_safe)


def _route(kp: KernelPatch, conv, relu: bool, skip: Optional[KernelPatch],
           stream) -> KernelPatch:
    """The launch, through ``_ConvLayer`` where a gradient is wanted."""
    if relu and kp.diag:
        raise ValueError("the ReLU prologue takes pair patches; a diagonal "
                         "patch takes relu_transform, then conv_maps")
    spec = _spec(kp, conv, relu, skip)
    tensors = [kp.xy, kp.xx, kp.yy] + (
        [None] * 3 if skip is None else [skip.xy, skip.xx, skip.yy])
    scale, bias = _operands(conv)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in (scale, bias, *tensors)):
        outs = _ConvLayer.apply(spec, stream, scale, bias, *tensors)
    else:
        outs = _launch(spec, tensors, scale, bias, stream)
    # the mask that skip + out would carry
    mask = (skip.diag_mask if skip is not None and skip.diag_mask is not None
            else kp.diag_mask)
    return KernelPatch(outs[0], outs[1], outs[-1], kp.same, kp.diag, mask)


def _maps(spec: _Spec, xy, xx, yy):
    """The maps a launch filters and their prologues: xy (through the ReLU
    when ``spec.relu``), xx (halved after a ReLU) and, with three outputs,
    xx again or yy."""
    pro = boxfilter.HALF if spec.relu else boxfilter.AS_IS
    maps = [xy, xx] + ([xx if spec.third_xx else yy] if spec.n_out == 3
                       else [])
    prologues = [boxfilter.RELU if spec.relu else boxfilter.AS_IS,
                 pro, pro][:spec.n_out]
    return maps, prologues


def _launch(spec: _Spec, tensors: List[Optional[torch.Tensor]], scale,
            bias, stream) -> List[torch.Tensor]:
    """One launch of the fused layer; returns its ``spec.n_out`` output
    maps (xy, xx and, with three, yy)."""
    xy, xx, yy, s_xy, s_xx, s_yy = tensors
    maps, prologues = _maps(spec, xy, xx, yy)
    side = ((xx, yy, spec.mask, spec.form, spec.exact) if spec.relu
            else None)
    return boxfilter._launch_layer(spec.geom, maps, prologues,
                                   [s_xy, s_xx, s_yy][:spec.n_out], side,
                                   scale, bias, stream)


def _backward(spec: _Spec, scale, xy, xx, yy, grads, needs, box_vjp,
              relu_vjp):
    """The layer's VJP against the cotangents ``grads`` of its
    ``spec.n_out`` outputs: ``(d scale, d bias, g_xy, g_xx, g_yy, gs_xy,
    gs_xx, gs_yy)``, each None where ``needs`` (the same eight flags) says
    so, from one call of ``box_vjp`` (``boxfilter._launch_vjp`` or its
    plain version, without the stream) and, with the ReLU, one of
    ``relu_vjp`` (``arccos._launch_vjp`` or its plain version).  The
    skip's cotangents are the outputs' own (gs_yy None when the skip's yy
    is its xx: the one tensor took its cotangent through xx)."""
    n_scale, n_bias, n_xy, n_xx, n_yy = needs[:5]
    maps, modes = _maps(spec, xy, xx, yy)
    relu_runs = spec.relu and (n_xy or n_xx or n_yy or n_scale)
    # map 0's box^T(g) feeds the ReLU's adjoint; map 2 is xx's or yy's
    want = [relu_runs if spec.relu else n_xy, n_xx,
            n_xx if spec.third_xx else n_yy][:spec.n_out]
    outs, dscale, dbias = box_vjp(spec.geom, list(grads), maps, modes, want,
                                  scale, n_scale or n_bias)
    outs = outs + [None] * (3 - len(outs))
    acc_xx = outs[1]
    if spec.third_xx and outs[2] is not None:
        acc_xx = outs[2] if acc_xx is None else acc_xx + outs[2]
    acc_yy = None if spec.third_xx else outs[2]
    if relu_runs:
        arccos.check_grad_safe(spec.mask, spec.grad_safe)
        g_xy, g_xx, g_yy = relu_vjp(
            outs[0], xy, xx, yy, spec.mask,
            spec.form, spec.exact, scale, (n_xy, n_xx, n_yy), acc_xx,
            acc_yy, dscale if n_scale else None)
    else:
        g_xy, g_xx, g_yy = (None if spec.relu else outs[0]), acc_xx, acc_yy
    skip = [grads[0], grads[1], grads[2] if spec.n_out == 3 else None]
    return (dscale if n_scale else None, dbias if n_bias else None,
            g_xy if n_xy else None, g_xx if n_xx else None,
            g_yy if n_yy else None) + tuple(
                g if need else None for g, need in zip(skip, needs[5:]))


class _ConvLayer(torch.autograd.Function):
    """The fused launch as the forward; the backward launches the adjoint
    kernels (``_backward`` on ``boxfilter._launch_vjp`` and
    ``arccos._launch_vjp``) under the forms of the forward, on the saved
    inputs of the layer (not the skip, whose cotangent passes through)."""

    @staticmethod
    def forward(ctx, spec, stream, scale, bias, *tensors):
        ctx.spec, ctx.stream = spec, stream
        ctx.scale = None if isinstance(scale, torch.Tensor) else scale
        ctx.leaf_devices = boxfilter._leaf_devices(scale, bias)
        ctx.save_for_backward(
            scale if isinstance(scale, torch.Tensor) else None,
            *tensors[:3])
        return tuple(_launch(spec, list(tensors), scale, bias, stream))

    @staticmethod
    def backward(ctx, *grads):
        scale, xy, xx, yy = ctx.saved_tensors
        scale = ctx.scale if scale is None else scale
        stream = ctx.stream
        needs = ctx.needs_input_grad[2:]
        got = _backward(
            ctx.spec, scale, xy, xx, yy, grads, needs,
            lambda *a: boxfilter._launch_vjp(*a, stream),
            lambda *a: arccos._launch_vjp(*a, stream))
        return (None, None) + boxfilter._leaf_grads(
            ctx.leaf_devices, needs[:2], got[:2]) + got[2:]


def conv_layer_vjp_reference(kp: KernelPatch, conv, relu: bool,
                             skip: Optional[KernelPatch], grads):
    """The VJP of ``conv_layer_reference(kp, conv, relu, skip)`` in plain
    torch, composed from ``boxfilter._vjp_reference`` and
    ``arccos._vjp_reference`` as the card's backward composes the two
    kernels: ``grads`` are the cotangents of the layer's distinct output
    maps (xy', xx' and, unless yy' is xx', yy'); returns ``(d scale, d
    bias, (g_xy, g_xx, g_yy), (gs_xy, gs_xx, gs_yy))`` for the ``Conv2d``'s
    scale ``var_weight / k**2`` and bias, ``kp``'s fields (g_yy None where
    yy is xx and its cotangent went to g_xx) and the skip's (None without
    one).  Under the settings of the forward; a masked ReLU needs
    ``settings.grad_safe``."""
    spec = _spec(kp, conv, relu, skip)
    scale, _ = _operands(conv)
    got = _backward(spec, scale, kp.xy, kp.xx, kp.yy, grads,
                    [True] * 5 + [skip is not None] * 3,
                    boxfilter._vjp_reference, arccos._vjp_reference)
    return got[0], got[1], got[2:5], got[5:8]

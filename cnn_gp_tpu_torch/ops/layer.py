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
forward of a ``torch.autograd.Function`` whose backward re-runs the plain
version under the forward's settings.  The launch counts are
``boxfilter.launches`` (every box-filter launch),
``boxfilter.prologue_launches`` and ``boxfilter.epilogue_launches``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from ..kernel_patch import KernelPatch
from . import arccos, boxfilter

__all__ = ["conv_layer", "conv_layer_reference"]


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
    form: int                      # arccos.PAIR_FAST / PAIR_REFERENCE
    exact: int
    settings: dict                 # for the backward to restore


def _route(kp: KernelPatch, conv, relu: bool, skip: Optional[KernelPatch],
           stream) -> KernelPatch:
    """The launch, through ``_ConvLayer`` where a gradient is wanted."""
    if relu and kp.diag:
        raise ValueError("the ReLU prologue takes pair patches; a diagonal "
                         "patch takes relu_transform, then conv_maps")
    geom = _geometry(conv)
    form, exact, saved = arccos._forms()
    # yy' is xx' after the ReLU of a same block, and a map that is xx is
    # filtered once, as in Conv2d.propagate; the skip's yy, when it is not
    # its xx, makes a third map all the same
    one_side = (kp.same if relu else kp.yy is kp.xx)
    one_skip = skip is None or skip.yy is skip.xx
    spec = _Spec(geom, relu, kp.same, kp.diag_mask,
                 kp.resolve_diag_mask() if relu else None,
                 2 if one_side and one_skip else 3, form, exact, saved)
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


def _launch(spec: _Spec, tensors: List[Optional[torch.Tensor]], scale,
            bias, stream) -> List[torch.Tensor]:
    """One launch of the fused layer; returns its ``spec.n_out`` output
    maps (xy, xx and, with three, yy)."""
    xy, xx, yy, s_xy, s_xx, s_yy = tensors
    pro = boxfilter.HALF if spec.relu else boxfilter.AS_IS
    maps = [xy, xx]
    prologues = [boxfilter.RELU if spec.relu else boxfilter.AS_IS, pro]
    skips = [s_xy, s_xx]
    if spec.n_out == 3:
        one_side = spec.same if spec.relu else yy is xx
        maps.append(xx if one_side else yy)
        prologues.append(pro)
        skips.append(s_yy)
    side = ((xx, yy, spec.mask, spec.form, spec.exact) if spec.relu
            else None)
    return boxfilter._launch_layer(spec.geom, maps, prologues, skips, side,
                                   scale, bias, stream)


class _ConvLayer(torch.autograd.Function):
    """The fused launch as the forward; the backward re-runs
    ``conv_layer_reference`` on the saved inputs, under the settings of
    the forward (``relu_impl``, ``acos_impl``, ``grad_safe``), and
    returns its gradients, the same as plain autograd's.  (A hand-written
    backward kernel is ROADMAP Queue 2, the tile VJP.)"""

    @staticmethod
    def forward(ctx, spec, stream, scale, bias, *tensors):
        ctx.spec = spec
        ctx.operands = [None if isinstance(t, torch.Tensor) else t
                        for t in (scale, bias)]
        ctx.save_for_backward(*[t if isinstance(t, torch.Tensor) else None
                                for t in (scale, bias)], *tensors)
        return tuple(_launch(spec, list(tensors), scale, bias, stream))

    @staticmethod
    def backward(ctx, *grads):
        from .. import settings
        spec = ctx.spec
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        inputs = [ctx.operands[i] if saved[i] is None else saved[i]
                  for i in range(2)] + list(saved[2:])
        inputs = [t.detach().requires_grad_(need)
                  if isinstance(t, torch.Tensor) else t
                  for t, need in zip(inputs, needs)]
        scale, bias, xy, xx, yy, s_xy, s_xx, s_yy = inputs
        kp = KernelPatch(xy, xx, yy, spec.same, False, spec.diag_mask)
        skip = None if s_xy is None else KernelPatch(
            s_xy, s_xx, s_yy, spec.same, False, spec.diag_mask)
        with settings.override(**spec.settings), torch.enable_grad():
            out = _reference(kp, spec.geom, scale, bias, spec.relu, skip)
        outs = [out.xy, out.xx, out.yy][:spec.n_out]
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [t for t, need in zip(inputs, needs) if need]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None) + tuple(next(got) if need else None
                                    for need in needs)

"""NNGP kernel combinator DSL.

PyTorch counterpart of ``cnn_gp_tpu/kernels.py`` with the same names:

    model = Sequential(Conv2d(7), ReLU(), ..., Conv2d(28, padding=0))
    K = model(x, y)          # one Gram block, [N1, N2]
    K = model(x)             # symmetric block (same=True)
    k = model(x, diag=True)  # diagonal only, [N]

Layers are ``nn.Module``s whose ``forward(kp) -> kp`` is the JAX
``propagate``.  Calling a layer on a ``KernelPatch`` runs ``forward``;
calling it on images runs ``kernel_fn``.  ``Mixture.logit`` and the
``var_weight``/``var_bias`` of ``Conv2d(learnable=True)`` are
``nn.Parameter``s.  Nothing here needs gradients: ``kernel_fn`` runs under
``torch.no_grad``.

``apply_kernel`` walks a pair tile with the ResNet layer fused
(``ops/layer.py::conv_layer``): on the card every ``Conv2d`` is one launch
of the box-filter kernel, which also runs

- a ``ReLU`` whose every consumer is a ``Conv2d``, in the prologue of
  each of them (a projection block's ``ReLU`` feeds its 1x1 shortcut and
  its 3x3 branch, so it runs in both);
- the add of a ``Sum`` branch whose last layer is a ``Conv2d``, in that
  launch's epilogue, with the running total of the earlier branches as
  the skip (an empty ``Sequential()`` branch is that total itself).

Every other ``ReLU`` is one launch of the arccos kernel
(``ops/arccos.py::relu_transform``); every other ``Sum`` add, the
``Mixture`` and ``input_patch``'s contraction stay torch ops.  A
diagonal walk (``diag=True``) runs each layer on its own
(``conv_maps``, ``relu_transform``).  On the CPU the same fused walk runs
the plain versions.  ``apply_kernel_reference`` walks the model unfused
with the plain torch versions, on any device: the yardstick of the
kernels, which the main path never calls.

A model that holds an ``AvgPool2d`` (Myrtle-10: ``[Conv2d(3), ReLU()] x
3`` and a pool per stage) needs the covariance of every pair of
positions from its input on (``FullKernelPatch``): ``apply_kernel``
runs it through ``ops/fullcov.py`` (one pre-pass per image set, then
the pairs in memory-bounded chunks, on the card its CUDA kernels), and
``apply_kernel_reference`` propagates a ``FullKernelPatch`` layer by
layer in plain torch.  Such a model takes ``Sequential``, ``Conv2d`` of
stride 1, ``ReLU`` and ``AvgPool2d`` only; an ``AvgPool2d`` on a
diagonal patch raises.

``NTK(model)`` is the neural tangent kernel of such a model (with or
without a pool): the same route carries a tangent field beside the
covariance and reads the kernel from it (``ops/fullcov.py``).  No other
route computes it: the megakernel and the layer kernels refuse it.
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import settings
from .kernel_patch import FullKernelPatch, KernelPatch
from .ops import arccos, boxfilter, fullcov, layer
from .ops.layer import _add

__all__ = ["NNGPKernel", "Conv2d", "ReLU", "AvgPool2d", "NTK", "Sequential",
           "Sum", "Mixture", "resnet_block", "kernel_fn", "input_patch",
           "apply_kernel", "apply_kernel_reference"]


def input_patch(x: torch.Tensor, y: torch.Tensor, same: bool, diag: bool,
                diag_mask: Optional[torch.Tensor] = None,
                full: bool = False):
    """Channel-mean second moments of the inputs.

    ``xy[i, j] = mean_c(x[i, c] * y[j, c])`` is a float32 contraction over
    the channel axis per pixel (full float32 only with TF32 off, see
    ``settings.moment_precision``).  ``full=True`` gives the
    ``FullKernelPatch``: ``xy[i, j, p, q] = mean_c(x[i, c, p] * y[j, c,
    q])`` over every pair of positions, and each image's own."""
    c = x.shape[1]
    if full:
        xx = torch.einsum("icwh,ickl->iwhkl", x, x) / c
        yy = xx if y is x else torch.einsum("icwh,ickl->iwhkl", y, y) / c
        xy = torch.einsum("icwh," + ("ickl->iwhkl" if diag
                                     else "jckl->ijwhkl"), x, y) / c
        return FullKernelPatch(xy, xx, yy, same, diag, diag_mask)
    if diag:
        xy = torch.mean(x * y, dim=1)
    else:
        xy = torch.einsum("icwh,jcwh->ijwh", x, y) / c
    xx = torch.mean(x * x, dim=1)
    yy = torch.mean(y * y, dim=1)
    return KernelPatch(xy, xx, yy, same, diag, diag_mask)


def _finalize(kp, n1: int, n2: int, diag: bool):
    w, h = kp.spatial
    if (w, h) != (1, 1):
        raise ValueError(
            f"model must reduce spatial dims to 1x1 before readout, got "
            f"{(w, h)}; add a valid-padding Conv2d covering the whole map")
    if diag:
        return kp.xy.reshape(n1)
    return kp.xy.reshape(n1, n2)


def apply_kernel(model, x: torch.Tensor, y: torch.Tensor, same: bool,
                 diag: bool, diag_mask: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Kernel core on tensors that already lie on the compute device (on
    the card: the layer kernels; for a model with a pool or an ``NTK``,
    the full-covariance kernels)."""
    if x.is_cuda:
        settings.check_precision()
    spec = fullcov.match(model)
    if spec is not None:
        return fullcov.apply(spec, x, y, same, diag, diag_mask)
    kp = input_patch(x, y, same, diag, diag_mask)
    if diag:
        kp = model.propagate(kp)
    else:
        kp, _ = model.fused(kp)
    return _finalize(kp, x.shape[0], y.shape[0], diag)


def apply_kernel_reference(model, x: torch.Tensor, y: torch.Tensor,
                           same: bool, diag: bool,
                           diag_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``apply_kernel`` with every layer on its plain torch version
    (``conv_maps_reference``, ``relu_transform_reference``) on any
    device: the yardstick that the layer kernels are held to on the
    card."""
    if x.is_cuda:
        settings.check_precision()
    kp = input_patch(x, y, same, diag, diag_mask,
                     full=fullcov.match(model) is not None)
    kp = model.propagate(kp, reference=True)
    return _finalize(kp, x.shape[0], y.shape[0], diag)


@torch.no_grad()
def kernel_fn(model, x, y=None, same=None, diag=False,
              diag_mask=None, device=None) -> torch.Tensor:
    """Compute one Gram block (the reference's ``NNGPKernel.forward``).

    ``device=None`` keeps tensor inputs where they are and puts numpy
    inputs on the CPU; any other value moves the inputs there.
    """
    if y is None:
        assert same is None, "y=None implies same=True"
        y, same = x, True
    elif same is None:
        same = False
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    assert x.ndim == 4 and y.ndim == 4, "inputs must be [N, C, W, H]"
    assert x.shape[1:] == y.shape[1:], "channel/spatial dims must match"
    if diag:
        assert x.shape[0] == y.shape[0], (
            "diagonal kernels must operate with data of equal length")
    if diag_mask is not None:
        diag_mask = torch.as_tensor(diag_mask, dtype=torch.bool,
                                    device=x.device)
    return apply_kernel(model, x, y, same, diag, diag_mask)


def _relu(kp: KernelPatch, relu: bool) -> KernelPatch:
    """``kp`` with a waiting ReLU applied (one arccos-kernel launch)."""
    return arccos.relu_transform(kp) if relu else kp


class NNGPKernel(nn.Module):
    """Base class: transforms one kernel patch into another."""

    def __call__(self, x, y=None, same=None, diag=False, diag_mask=None,
                 device=None):
        if isinstance(x, KernelPatch):
            return super().__call__(x)
        return kernel_fn(self, x, y, same, diag, diag_mask, device)

    def forward(self, kp: KernelPatch) -> KernelPatch:
        return self.propagate(kp)

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        """The layer's map of a patch; ``reference=True`` runs the plain
        torch versions of the layer kernels throughout."""
        raise NotImplementedError

    def fused(self, kp: KernelPatch, relu: bool = False,
              skip: Optional[KernelPatch] = None,
              defer: bool = False):
        """The layer's map of a pair patch with the ResNet layer fused:
        ``relu`` says that ``kp`` still waits for a ``ReLU`` (only a layer
        that ``opens_with_conv`` is given one to fuse), ``skip`` is a
        patch to add to the output (the running total of a ``Sum``), and
        ``defer`` says that the output's one reader is a ``Conv2d``, so
        a trailing ``ReLU`` may be left waiting.  Returns
        (patch, whether a ReLU still waits on it).  This default runs the
        layer's own ``propagate``."""
        out = self.propagate(_relu(kp, relu))
        return _add(skip, out), False

    def opens_with_conv(self) -> bool:
        """Whether the layer's input has one reader, a ``Conv2d``: a
        ``ReLU`` before it runs in that launch's prologue."""
        return False

    def closes_with_conv(self) -> bool:
        """Whether the layer's output is a ``Conv2d``'s."""
        return False

    def layers(self) -> int:
        """Number of conv layers."""
        raise NotImplementedError

    def nn(self, channels, in_channels=None, out_channels=None):
        """Finite-width random networks with this kernel as their
        infinite-width limit (``finite.FiniteNet``; draw them with
        ``init``)."""
        from . import finite
        return finite.FiniteNet(self, channels, in_channels, out_channels)


class Conv2d(NNGPKernel):
    """Covariance map of an infinite-channel conv layer: a box filter
    scaled by ``var_weight / k^2``, plus ``var_bias``.

    ``learnable=True`` makes ``var_weight``/``var_bias`` ``nn.Parameter``s
    (the leaves ``cnn_gp_tpu.fit`` optimises); otherwise they are floats.
    """

    def __init__(self, kernel_size, stride=1, padding="same", dilation=1,
                 var_weight=1.0, var_bias=0.0, in_channel_multiplier=1,
                 out_channel_multiplier=1, learnable=False):
        super().__init__()
        self.kernel_size = int(kernel_size)
        self.stride = int(stride)
        self.dilation = int(dilation)
        self.learnable = bool(learnable)
        if self.learnable:
            self.var_weight = nn.Parameter(
                torch.tensor(float(var_weight), dtype=torch.float32))
            self.var_bias = nn.Parameter(
                torch.tensor(float(var_bias), dtype=torch.float32))
        else:
            self.var_weight = float(var_weight)
            self.var_bias = float(var_bias)
        self.in_channel_multiplier = int(in_channel_multiplier)
        self.out_channel_multiplier = int(out_channel_multiplier)
        # the reference's even-kernel "same" trick becomes asymmetric
        # padding; `even_trick` records it as the JAX layer does
        self.even_trick = (padding == "same" and kernel_size % 2 == 0)
        if padding == "same":
            self.padding = boxfilter.same_padding(self.kernel_size,
                                                  self.dilation)[1]
        else:
            try:
                self.padding = operator.index(padding)
            except TypeError:
                raise TypeError(
                    f"Conv2d padding must be 'same' or an int, got "
                    f"{padding!r}; call ops.boxfilter.box_filter_2d "
                    f"directly for asymmetric padding") from None

    @property
    def pad_lo_hi(self):
        if self.even_trick:
            return boxfilter.same_padding(self.kernel_size, self.dilation)
        return (self.padding, self.padding)

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        k = self.kernel_size
        if isinstance(kp, FullKernelPatch):
            if self.stride != 1 or self.dilation != 1:
                raise ValueError("a full-covariance patch takes Conv2d of "
                                 "stride 1 and dilation 1")
            return fullcov.patch_conv(kp, k, *self.pad_lo_hi,
                                      fullcov._value(self.var_weight),
                                      fullcov._value(self.var_bias))
        scale = self.var_weight / (k * k)
        conv = (boxfilter.conv_maps_reference if reference
                else boxfilter.conv_maps)
        # yy is xx after a ReLU of a same block: filtered once
        maps = [kp.xy, kp.xx] + ([] if kp.yy is kp.xx else [kp.yy])
        out = conv(maps, k, self.stride, self.pad_lo_hi, self.dilation,
                   scale, self.var_bias)
        return KernelPatch(out[0], out[1], out[-1] if len(out) == 3
                           else out[1], kp.same, kp.diag, kp.diag_mask)

    def fused(self, kp, relu=False, skip=None, defer=False):
        return layer.conv_layer(kp, self, relu, skip), False

    def opens_with_conv(self):
        return True

    def closes_with_conv(self):
        return True

    def layers(self):
        return 1


class ReLU(NNGPKernel):
    """Arccos-kernel ReLU nonlinearity."""

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        if isinstance(kp, FullKernelPatch):
            return fullcov.patch_relu(kp)
        if reference:
            return arccos.relu_transform_reference(kp)
        return arccos.relu_transform(kp)

    def fused(self, kp, relu=False, skip=None, defer=False):
        kp = _relu(kp, relu)
        if defer and skip is None:
            return kp, True
        return _add(skip, arccos.relu_transform(kp)), False

    def layers(self):
        return 0


class AvgPool2d(NNGPKernel):
    """Average pooling over k x k blocks (stride k, no padding), as a
    CNN's ``nn.AvgPool2d(k)``: ``K'(P, Q) = mean over the k^4 pairs of
    positions (kP + a, kQ + b)``.  It mixes positions, so it acts on the
    full-covariance patch only; a model that holds one takes that patch
    from its input on (``apply_kernel``)."""

    def __init__(self, kernel_size=2, stride=None, padding=0):
        super().__init__()
        self.kernel_size = int(kernel_size)
        if (stride is not None and int(stride) != self.kernel_size) \
                or padding != 0:
            raise ValueError("AvgPool2d takes stride = kernel_size and no "
                             "padding")

    def propagate(self, kp, reference: bool = False):
        if not isinstance(kp, FullKernelPatch):
            raise ValueError(
                "AvgPool2d mixes positions and needs the full covariance "
                "(FullKernelPatch); kernel_fn and apply_kernel route a "
                "model with a pool through ops/fullcov.py")
        return fullcov.patch_pool(kp, self.kernel_size)

    def layers(self):
        return 0


class NTK(NNGPKernel):
    """The neural tangent kernel of ``model`` (a ``Sequential`` of
    ``Conv2d`` of stride 1, ``ReLU`` and ``AvgPool2d``) in the NTK
    parameterization (Arora et al., "On Exact Computation with an
    Infinitely Wide Neural Net", 2019, section 4): beside the covariance
    K each pair carries the tangent Theta over every pair of positions,
    0 at the input; a conv maps it as it maps K, without the bias, and
    adds the new K; a ReLU scales it by (pi - theta) / (2 pi) of the
    angle of K; a pool averages it.  The kernel is the last Theta.  It
    needs the full-covariance patch, so ``kernel_fn`` and
    ``apply_kernel`` route it through ``ops/fullcov.py`` whether or not
    the model pools; the tiled fit refuses it (no adjoints)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def propagate(self, kp, reference: bool = False):
        if not isinstance(kp, FullKernelPatch):
            raise ValueError(
                "an NTK carries its tangent on the full covariance "
                "(FullKernelPatch); kernel_fn and apply_kernel route it "
                "through ops/fullcov.py")
        return self.model.propagate(kp.with_tangent(),
                                    reference).tangent_patch()

    def layers(self):
        return self.model.layers()


class Sequential(NNGPKernel):
    def __init__(self, *mods):
        super().__init__()
        self.mods = nn.ModuleList(mods)

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        for mod in self.mods:
            kp = mod.propagate(kp, reference)
        return kp

    def fused(self, kp, relu=False, skip=None, defer=False):
        waiting = relu
        for i, mod in enumerate(self.mods):
            last = i == len(self.mods) - 1
            if waiting and not mod.opens_with_conv():
                kp, waiting = _relu(kp, True), False
            kp, waiting = mod.fused(
                kp, waiting, skip if last else None,
                defer if last else self.mods[i + 1].opens_with_conv())
        if not self.mods and (skip is not None or not defer):
            kp, waiting = _add(skip, _relu(kp, waiting)), False
        return kp, waiting

    def opens_with_conv(self):
        return bool(self.mods) and self.mods[0].opens_with_conv()

    def closes_with_conv(self):
        return bool(self.mods) and self.mods[-1].closes_with_conv()

    def layers(self):
        return sum(mod.layers() for mod in self.mods)


class Sum(NNGPKernel):
    """Kernel of a sum of independent branches = sum of branch kernels.
    With an empty ``Sequential()`` branch this is a residual connection."""

    def __init__(self, mods):
        super().__init__()
        self.mods = nn.ModuleList(mods)

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        total = self.mods[0].propagate(kp, reference)
        for mod in self.mods[1:]:
            total = total + mod.propagate(kp, reference)
        return total

    def fused(self, kp, relu=False, skip=None, defer=False):
        if relu and not self.opens_with_conv():
            kp, relu = _relu(kp, True), False
        total, _ = self.mods[0].fused(kp, relu)
        for mod in self.mods[1:]:
            if mod.closes_with_conv():
                # the running total as the branch's epilogue skip
                total, _ = mod.fused(kp, relu, total)
            else:
                total = total + mod.fused(kp, relu)[0]
        return _add(skip, total), False

    def opens_with_conv(self):
        # a ReLU read by several branches (a projection block's) launches
        # once on its own rather than once in each branch's prologue
        return len(self.mods) == 1 and self.mods[0].opens_with_conv()

    def layers(self):
        return max(mod.layers() for mod in self.mods)


class Mixture(NNGPKernel):
    """Softmax-weighted convex mixture of branch kernels; ``logit`` is an
    ``nn.Parameter``."""

    def __init__(self, mods, logit_proportions=None):
        super().__init__()
        self.mods = nn.ModuleList(mods)
        if logit_proportions is None:
            logit_proportions = np.zeros(len(self.mods), np.float32)
        self.logit = nn.Parameter(torch.tensor(
            np.asarray(logit_proportions, np.float32)))

    def propagate(self, kp: KernelPatch,
                  reference: bool = False) -> KernelPatch:
        proportions = torch.softmax(self.logit, dim=0).to(kp.xy.device)
        total = self.mods[0].propagate(kp, reference) * proportions[0]
        for i, mod in enumerate(self.mods[1:], start=1):
            total = total + mod.propagate(kp, reference) * proportions[i]
        return total

    def fused(self, kp, relu=False, skip=None, defer=False):
        kp = _relu(kp, relu)
        proportions = torch.softmax(self.logit, dim=0).to(kp.xy.device)
        total = self.mods[0].fused(kp)[0] * proportions[0]
        for i, mod in enumerate(self.mods[1:], start=1):
            total = total + mod.fused(kp)[0] * proportions[i]
        return _add(skip, total), False

    def layers(self):
        return max(mod.layers() for mod in self.mods)


def resnet_block(stride=1, projection_shortcut=False, multiplier=1):
    """Pre-activation ResNet block in the kernel DSL."""
    if stride == 1 and not projection_shortcut:
        return Sum([
            Sequential(),
            Sequential(
                ReLU(),
                Conv2d(3, stride=stride, in_channel_multiplier=multiplier,
                       out_channel_multiplier=multiplier),
                ReLU(),
                Conv2d(3, in_channel_multiplier=multiplier,
                       out_channel_multiplier=multiplier),
            ),
        ])
    return Sequential(
        ReLU(),
        Sum([
            Conv2d(1, stride=stride,
                   in_channel_multiplier=multiplier // stride,
                   out_channel_multiplier=multiplier),
            Sequential(
                Conv2d(3, stride=stride,
                       in_channel_multiplier=multiplier // stride,
                       out_channel_multiplier=multiplier),
                ReLU(),
                Conv2d(3, in_channel_multiplier=multiplier,
                       out_channel_multiplier=multiplier),
            ),
        ]),
    )

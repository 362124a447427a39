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
"""

from __future__ import annotations

import operator
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import settings
from .kernel_patch import KernelPatch
from .ops import arccos, boxfilter

__all__ = ["NNGPKernel", "Conv2d", "ReLU", "Sequential", "Sum", "Mixture",
           "resnet_block", "kernel_fn", "input_patch", "apply_kernel"]


def input_patch(x: torch.Tensor, y: torch.Tensor, same: bool, diag: bool,
                diag_mask: Optional[torch.Tensor] = None) -> KernelPatch:
    """Channel-mean second moments of the inputs.

    ``xy[i, j] = mean_c(x[i, c] * y[j, c])`` is a float32 contraction over
    the channel axis per pixel (full float32 only with TF32 off, see
    ``settings.moment_precision``)."""
    c = x.shape[1]
    if diag:
        xy = torch.mean(x * y, dim=1)
    else:
        xy = torch.einsum("icwh,jcwh->ijwh", x, y) / c
    xx = torch.mean(x * x, dim=1)
    yy = torch.mean(y * y, dim=1)
    return KernelPatch(xy, xx, yy, same, diag, diag_mask)


def _finalize(kp: KernelPatch, n1: int, n2: int, diag: bool):
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
    """Kernel core on tensors that already lie on the compute device."""
    if x.is_cuda:
        settings.check_precision()
    kp = input_patch(x, y, same, diag, diag_mask)
    kp = model(kp)
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


class NNGPKernel(nn.Module):
    """Base class: transforms one kernel patch into another."""

    def __call__(self, x, y=None, same=None, diag=False, diag_mask=None,
                 device=None):
        if isinstance(x, KernelPatch):
            return super().__call__(x)
        return kernel_fn(self, x, y, same, diag, diag_mask, device)

    def forward(self, kp: KernelPatch) -> KernelPatch:
        raise NotImplementedError

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

    def forward(self, kp: KernelPatch) -> KernelPatch:
        k = self.kernel_size
        scale = self.var_weight / (k * k)

        def f(a):
            out = boxfilter.box_filter_2d(a, k, self.stride, self.pad_lo_hi,
                                          self.dilation)
            return out * scale + self.var_bias

        return KernelPatch(f(kp.xy), f(kp.xx), f(kp.yy), kp.same, kp.diag,
                           kp.diag_mask)

    def layers(self):
        return 1


class ReLU(NNGPKernel):
    """Arccos-kernel ReLU nonlinearity."""

    def forward(self, kp: KernelPatch) -> KernelPatch:
        return arccos.relu_transform(kp)

    def layers(self):
        return 0


class Sequential(NNGPKernel):
    def __init__(self, *mods):
        super().__init__()
        self.mods = nn.ModuleList(mods)

    def forward(self, kp: KernelPatch) -> KernelPatch:
        for mod in self.mods:
            kp = mod(kp)
        return kp

    def layers(self):
        return sum(mod.layers() for mod in self.mods)


class Sum(NNGPKernel):
    """Kernel of a sum of independent branches = sum of branch kernels.
    With an empty ``Sequential()`` branch this is a residual connection."""

    def __init__(self, mods):
        super().__init__()
        self.mods = nn.ModuleList(mods)

    def forward(self, kp: KernelPatch) -> KernelPatch:
        total = self.mods[0](kp)
        for mod in self.mods[1:]:
            total = total + mod(kp)
        return total

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

    def forward(self, kp: KernelPatch) -> KernelPatch:
        proportions = torch.softmax(self.logit, dim=0).to(kp.xy.device)
        total = self.mods[0](kp) * proportions[0]
        for i, mod in enumerate(self.mods[1:], start=1):
            total = total + mod(kp) * proportions[i]
        return total

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

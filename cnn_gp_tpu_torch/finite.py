"""Finite-width random networks mirroring the kernel DSL.

PyTorch counterpart of ``cnn_gp_tpu/finite.py``: every kernel layer has a
finite-width counterpart whose infinite-channel limit is that kernel.  The
Monte-Carlo experiment (``exp_random_nn``) and ``scripts/mc_width_check``
check the analytic kernels against sampled networks with it.

One ``FiniteNet`` evaluates S independent networks at once.  Its
parameters carry a leading sample axis S, drawn by ``init(generator,
n_nets=S)`` from an explicit ``torch.Generator`` on the compute device,
``DRAW_BLOCK`` networks at a time (each block's layers in order), so the
networks that a seed gives do not depend on how they are split into
forwards:

    net = model.nn(channels=30, in_channels=3, out_channels=1)
    net.init(torch.Generator(device).manual_seed(0), n_nets=64)
    y = net(x)                          # [S, N, out, H', W']

Activations are laid out ``[N, S*C, H, W]``: each conv is one grouped
``F.conv2d`` with weights ``[S*C_out, C_in, k, k]`` and ``groups=S``.
The images are shared by all S networks, so until a layer mixes them with
per-network outputs they stay ``[N, C, H, W]``: a first conv reads them
with ``groups=1`` and ``S*C_out`` output channels, and a ``Sum`` whose
identity branch passes them on broadcasts them against the other branch,
channels included, as JAX's sum does.  S = 1 is the single network that
``model.nn()`` returns.

Weight distribution (the JAX package's, exact by construction):
  * conv weights ~ N(0, sqrt(var_weight / in_channels_total) / kernel_size),
  * for even "same" kernels the enlarged (k+1) kernel keeps its first
    row and column at zero, with symmetric padding ``layer.padding``,
  * bias ~ N(0, sqrt(var_bias)) only when var_bias > 0.

As in the JAX package, a ``Mixture`` scales every branch by
sqrt(softmax(logit)), so its finite nets converge to the Mixture kernel.
Learnable leaves are read as plain values; no gradient flows into the
finite net.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import kernels as K
from . import settings
from .utils import synced_clock

__all__ = ["FiniteNet", "sample_nn_outputs", "conv_ops"]

# Networks drawn together from the generator: init and sample_nn_outputs
# draw whole blocks, so a seed's networks are the same for any chunking
# into multiples of it.
DRAW_BLOCK = 8


def _value(v) -> float:
    """A hyperparameter as a plain float (learnable leaves included)."""
    return float(torch.as_tensor(v).detach())


def _build(layer, channels, in_ch, out_ch) -> nn.Module:
    if isinstance(layer, K.Conv2d):
        return _Conv(layer, channels, in_ch, out_ch)
    if isinstance(layer, K.ReLU):
        assert in_ch is None and out_ch is None, (
            "ReLU cannot change channel counts")
        return _ReLU()
    if isinstance(layer, K.Sequential):
        mods = list(layer.mods)
        if len(mods) == 0:
            return _Identity()
        if len(mods) == 1:
            return _build(mods[0], channels, in_ch, out_ch)
        # in_channels into the first child, out_channels into the last,
        # plain `channels` through the middle
        return _Sequential(
            [_build(mods[0], channels, in_ch, None)]
            + [_build(m, channels, None, None) for m in mods[1:-1]]
            + [_build(mods[-1], channels, None, out_ch)])
    if isinstance(layer, (K.Sum, K.Mixture)):
        return _Branches(layer, [_build(m, channels, in_ch, out_ch)
                                 for m in layer.mods])
    raise TypeError(f"no finite-width mirror for {type(layer).__name__}")


class _Node(nn.Module):
    """A mirror layer.  ``forward`` maps activations ``[N, S', C, H, W]``
    to the same layout, where S' is 1 (shared by all networks) or S."""

    def allocate(self, n_nets, device):
        """Room for the parameters of ``n_nets`` networks."""

    def draw(self, generator, lo, hi):
        """Draw the parameters of networks ``lo`` to ``hi - 1`` in place."""

    def load(self, draws, device):
        """Set the parameters from the JAX package's pytrees, one per
        network (the structure ``cnn_gp_tpu.finite`` builds)."""


class _Conv(_Node):
    def __init__(self, layer, channels, in_ch, out_ch):
        super().__init__()
        self.in_total = ((channels if in_ch is None else in_ch)
                         * layer.in_channel_multiplier)
        self.out_total = ((channels if out_ch is None else out_ch)
                          * layer.out_channel_multiplier)
        self.even_trick = layer.even_trick
        self.ksz = layer.kernel_size + (1 if layer.even_trick else 0)
        self.std_w = (math.sqrt(_value(layer.var_weight) / self.in_total)
                      / layer.kernel_size)
        var_bias = _value(layer.var_bias)
        self.std_b = math.sqrt(var_bias) if var_bias > 0.0 else None
        self.stride, self.dilation = layer.stride, layer.dilation
        self.padding = layer.padding
        self.w = None                      # [S, out, in, ksz, ksz]
        self.b = None                      # [S, out] or None

    def allocate(self, n_nets, device):
        self.w = torch.empty((n_nets, self.out_total, self.in_total,
                              self.ksz, self.ksz), device=device)
        self.b = (None if self.std_b is None else
                  torch.empty((n_nets, self.out_total), device=device))

    def draw(self, generator, lo, hi):
        w = self.w[lo:hi].normal_(0.0, self.std_w, generator=generator)
        if self.even_trick:
            w[:, :, :, 0, :] = 0.0
            w[:, :, :, :, 0] = 0.0
        if self.b is not None:
            self.b[lo:hi].normal_(0.0, self.std_b, generator=generator)

    def load(self, draws, device):
        w = np.stack([np.asarray(d["w"], np.float32) for d in draws])
        want = (self.out_total, self.in_total, self.ksz, self.ksz)
        if w.shape[1:] != want:
            raise ValueError(f"conv weight shape {w.shape[1:]} != {want}")
        if ("b" in draws[0]) != (self.std_b is not None):
            raise ValueError("bias present in the parameters but not in "
                             "the layer, or the other way round")
        self.w = torch.as_tensor(w, device=device)
        self.b = (None if self.std_b is None else torch.as_tensor(
            np.stack([np.asarray(d["b"], np.float32) for d in draws]),
            device=device))

    def forward(self, a):
        n, s_in, c, h, wd = a.shape
        s = self.w.shape[0]
        # channels_last: cuDNN's faster layout for these grouped convs
        # (PERF.md has the card's times of both layouts)
        x = a.reshape(n, s_in * c, h, wd).contiguous(
            memory_format=torch.channels_last)
        w = self.w.reshape(s * self.out_total, self.in_total, self.ksz,
                           self.ksz).contiguous(
                               memory_format=torch.channels_last)
        # shared input: one conv with S*C_out output channels; else one
        # group per network
        y = F.conv2d(x, w, stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=1 if s_in == 1 else s)
        y = y.view(n, s, self.out_total, *y.shape[2:])
        if self.b is not None:
            y = y + self.b[None, :, :, None, None]
        return y


class _ReLU(_Node):
    def forward(self, a):
        return torch.relu(a)


class _Identity(_Node):
    def forward(self, a):
        return a


class _Sequential(_Node):
    """Children in order; the parameters of child i are entry i of the
    JAX pytree."""

    def __init__(self, children):
        super().__init__()
        self.body = nn.ModuleList(children)

    def allocate(self, n_nets, device):
        for m in self.body:
            m.allocate(n_nets, device)

    def draw(self, generator, lo, hi):
        for m in self.body:
            m.draw(generator, lo, hi)

    def load(self, draws, device):
        for i, m in enumerate(self.body):
            m.load([d[i] for d in draws], device)

    def forward(self, a):
        for m in self.body:
            a = m(a)
        return a


class _Branches(_Sequential):
    """``Sum`` and ``Mixture``: the branches' outputs summed, each scaled
    by sqrt(softmax(logit)) for a Mixture.  A shared output (S' = 1) or a
    one-channel identity broadcasts against the others."""

    def __init__(self, layer, children):
        super().__init__(children)
        # read at forward time, as JAX's apply does; kept out of this
        # module's parameters
        self._logit = ((lambda: layer.logit)
                       if isinstance(layer, K.Mixture) else None)

    def forward(self, a):
        outs = [m(a) for m in self.body]
        if self._logit is not None:
            scale = torch.sqrt(torch.softmax(
                self._logit().detach().float(), dim=0)).tolist()
            outs = [o * scale[i] for i, o in enumerate(outs)]
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total


class FiniteNet(nn.Module):
    """S random finite-width networks sampled from a kernel model."""

    def __init__(self, model, channels: int,
                 in_channels: Optional[int] = None,
                 out_channels: Optional[int] = None):
        super().__init__()
        # the kernel model is not a part of this module
        object.__setattr__(self, "model", model)
        self.channels = channels
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.root = _build(model, channels, in_channels, out_channels)
        self.n_nets = 0
        self.device = None

    def init(self, generator: torch.Generator, n_nets: int = 1
             ) -> "FiniteNet":
        """Draw the parameters of ``n_nets`` independent networks on the
        generator's device, ``DRAW_BLOCK`` networks at a time: calls whose
        ``n_nets`` are multiples of it draw what one call with their sum
        draws."""
        self.device = generator.device
        self.root.allocate(n_nets, self.device)
        for lo in range(0, n_nets, DRAW_BLOCK):
            self.root.draw(generator, lo, min(lo + DRAW_BLOCK, n_nets))
        self.n_nets = n_nets
        return self

    def _load_jax(self, draws, device) -> "FiniteNet":
        """Set the parameters from a list of the JAX package's
        ``FiniteNet.init`` pytrees, one per network, on ``device``
        (``convert.finite_params_from_jax`` is the public entry)."""
        self.device = torch.device(device)
        self.root.load(list(draws), self.device)
        self.n_nets = len(draws)
        return self

    def select(self, i: int) -> "FiniteNet":
        """Network ``i`` alone, as a FiniteNet with S = 1 (its parameters
        are views of this one's)."""
        if not 0 <= i < self.n_nets:
            raise IndexError(f"network {i} of {self.n_nets}")
        one = FiniteNet(self.model, self.channels, self.in_channels,
                        self.out_channels)
        for src, dst in zip(self.root.modules(), one.root.modules()):
            if isinstance(src, _Conv):
                dst.w = src.w[i:i + 1]
                dst.b = None if src.b is None else src.b[i:i + 1]
        one.n_nets, one.device = 1, self.device
        return one

    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """``[S, N, out, H', W']``: the outputs of all S networks on the
        images ``x`` ``[N, C, H, W]`` (moved to the parameters' device)."""
        if self.n_nets == 0:
            raise RuntimeError("FiniteNet has no parameters: call init() "
                               "first")
        settings.check_precision_on(self.device)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = self.root(x[:, None])
        y = y.expand(y.shape[0], self.n_nets, *y.shape[2:])
        return y.transpose(0, 1)


def conv_ops(model, channels, shape) -> float:
    """FP32 operations of one network's convolutions on one image of
    ``shape`` [C, H, W]: 2 * C_out * C_in * k^2 per output pixel of each
    conv (the even trick's enlarged kernel as it runs), read off one
    forward on the CPU."""
    net = model.nn(channels, shape[0], 1).init(
        torch.Generator().manual_seed(0))
    ops = []

    def hook(conv, _, y):
        ops.append(2.0 * conv.out_total * conv.in_total * conv.ksz ** 2
                   * y.shape[-2] * y.shape[-1])

    for m in net.root.modules():
        if isinstance(m, _Conv):
            m.register_forward_hook(hook)
    net(np.zeros((1,) + tuple(shape), np.float32))
    return sum(ops)


def _bytes_per_net(net, x, generator, n_probe) -> tuple:
    """Draw and run ``n_probe`` networks on the card, measuring their peak
    card memory above what was allocated before: (outputs [S, N], bytes
    per network).  It resets the card's peak-memory counter."""
    device = x.device
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = net.init(generator, n_probe)(x)[:, :, 0, 0, 0]
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return out, max(peak - base, 1) / n_probe


@torch.no_grad()
def sample_nn_outputs(model, x, *, n_samples: int, channels: int,
                      in_channels: int, out_channels: int = 1,
                      sample_batch: Optional[int] = None,
                      generator: torch.Generator, device,
                      info: Optional[dict] = None) -> torch.Tensor:
    """Monte-Carlo draws of finite-net outputs: ``[n_samples, N]``, the
    output of channel 0 at pixel (0, 0) for each image of ``x``, on
    ``device``.

    The networks are drawn from ``generator`` (on ``device``) in chunks of
    ``sample_batch`` rounded down to whole ``DRAW_BLOCK``s (one block at
    least), each chunk one grouped forward; the outputs depend on the seed
    alone, not on the chunks.  ``sample_batch=None`` sizes the chunk to the
    card: a first block measures its networks' peak memory (this resets
    the card's peak-memory counter), and the rest run in chunks that fill
    half of the memory free to the process (``torch.cuda.mem_get_info``
    and what the caching allocator holds unused).  On the CPU, None means
    chunks of 64.  ``info``, when given, receives the chunk size
    (``sample_batch``), the seconds from entry to the last output on the
    device (``seconds``) and, when the card sized the chunk,
    ``bytes_per_net`` and ``free_bytes``."""
    device = torch.device(device)
    settings.check_precision_on(device)
    info = {} if info is None else info
    net = FiniteNet(model, channels, in_channels, out_channels)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    device = x.device                   # "cuda" resolved to its index
    if torch.empty(0, device=generator.device).device != device:
        raise ValueError(f"generator is on {generator.device}, the work on "
                         f"{device}")
    t0 = synced_clock(device)
    outs, done = [], 0
    if sample_batch is None:
        sample_batch = 64
        if device.type == "cuda":
            probe = min(DRAW_BLOCK, n_samples)
            out, per_net = _bytes_per_net(net, x, generator, probe)
            outs.append(out)
            done = probe
            # free to this process: the device's free memory and what the
            # caching allocator holds unused
            free = (torch.cuda.mem_get_info(device)[0]
                    + torch.cuda.memory_reserved(device)
                    - torch.cuda.memory_allocated(device))
            sample_batch = int(0.5 * free / per_net)
            info.update(bytes_per_net=per_net, free_bytes=free)
    sample_batch = max(DRAW_BLOCK, sample_batch // DRAW_BLOCK * DRAW_BLOCK)
    while done < n_samples:
        s = min(sample_batch, n_samples - done)
        outs.append(net.init(generator, s)(x)[:, :, 0, 0, 0])
        done += s
    out = torch.cat(outs)
    info.update(sample_batch=sample_batch,
                seconds=synced_clock(device) - t0)
    return out

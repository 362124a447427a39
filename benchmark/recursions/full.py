"""The full-covariance recursion: ``K(p, q)`` over every pair of positions
(a field [W, H, W, H] a pair of images, and each image's own), over
``conv``, ``relu``, ``pool`` and ``seq`` nodes.  A pool mixes positions,
so a pooling NNGP (Myrtle-10, ``configs/myrtle10.json``) needs it.

    {"op": "pool", "kernel_size": k}     a k x k average pool, stride k

``conv`` and ``relu`` are the diagonal recursion's nodes (``arch.Conv``
and ``arch.ReLU``; a conv of stride 1 and dilation 1).  No fit hooks:
the program's full-covariance kernels have no adjoints.

Counts, as ``arch.py`` counts the diagonal recursion (per Gram entry,
over the [W, H, W, H] field): the moments 2 C per element; per conv the
separable box sum (the taps that land inside the map, less one, per
output of each of its two passes: along (j, l), then along (i, k)), plus
scale and bias; per ReLU ``arch.RELU_PAIR_OPS``; per pool k^4 - 1 adds
and the scale per output.  Each image's own covariance, walked once a
call, costs as much as a pair.  Bytes: the tile's images read and the
tile written.  So ``gram_roofline`` reads the same work whatever
implements it.

The work also carries ``kernels``: for each of the program's two
kernels (``cov_conv_kernel``, ``cov_pool_kernel``) the least seconds its
launches of a call could take, the sum over launches of max(ops / the
FP32 peak, bytes / the memory rate), counted as the kernels are built:
the program's plan of ops (each ReLU in the prologue of the conv or pool
that reads it, the moments in the first op's prologue), each input
element read and put through its prologue once, each output written
once, a conv's k - 1 adds in each of its two passes over every output
(padding taps included) and its scale and bias, a pool's k^4 - 1 adds
and scale, the images or the two maps of the ReLU's factors a pair
reads.  The launches are linear in their pairs, so the sum does not
depend on how the program chunks a tile.  The per-kernel roofline
metrics (``metrics/cov_*_roofline.gram.py``) read them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import arch
from ..reference import fullcov

KERNELS = ("cov_conv_kernel", "cov_pool_kernel")
MOMENT_OPS = 2          # per element and channel: multiply and add
POOL_SCALE_OPS = 1


@dataclasses.dataclass(frozen=True)
class Pool:
    kernel_size: int


@dataclasses.dataclass(frozen=True)
class FullWork(arch.Work):
    """``arch.Work`` with each kernel's bound seconds a call:
    ((kernel name, seconds), ...)."""
    kernels: Tuple[Tuple[str, float], ...] = ()


def parse(node: dict):
    op = node["op"]
    if op == "pool":
        return Pool(int(node["kernel_size"]))
    if op == "seq":
        return arch.Seq(tuple(parse(n) for n in node["layers"]))
    if op in ("conv", "relu"):
        t = arch.parse(node)
        if isinstance(t, arch.Conv) and (t.stride, t.dilation) != (1, 1):
            raise ValueError("the full recursion takes convs of stride 1 "
                             "and dilation 1")
        return t
    raise ValueError(f"unknown op {op!r} in the full recursion")


def layers(tree) -> list:
    """The tree's layers in order, sequences flattened."""
    if isinstance(tree, arch.Seq):
        return [x for layer in tree.layers for x in layers(layer)]
    return [tree]


def _pair_adds(c: arch.Conv, n: int) -> int:
    """Adds of one pass of the shifted box sum along a dimension pair of
    length n (p and q shifted together): per output pair (o1, o2), the
    taps inside both maps less one."""
    m = c.out_size(n)
    return sum(max(sum(0 <= o1 + a - c.pad[0] < n and
                       0 <= o2 + a - c.pad[0] < n
                       for a in range(c.kernel_size)) - 1, 0)
               for o1 in range(m) for o2 in range(m))


def box_adds(c: arch.Conv, w: int, h: int) -> int:
    """Adds of the separable 4-D box sum over one [w, h, w, h] field: the
    (j, l) pass over every input (i, k), then the (i, k) pass over every
    output (j, l)."""
    ho = c.out_size(h)
    return w * w * _pair_adds(c, h) + ho * ho * _pair_adds(c, w)


def pair_ops(tree, shape) -> int:
    """FP32 operations per Gram entry (and per image's own covariance)."""
    c, w, h = shape
    ops = MOMENT_OPS * c * (w * h) ** 2
    for layer in layers(tree):
        if isinstance(layer, arch.Conv):
            wo, ho = layer.out_size(w), layer.out_size(h)
            ops += box_adds(layer, w, h) + arch.CONV_AFFINE_OPS * (
                wo * ho) ** 2
            w, h = wo, ho
        elif isinstance(layer, arch.ReLU):
            ops += arch.RELU_PAIR_OPS * (w * h) ** 2
        else:
            k = layer.kernel_size
            w, h = w // k, h // k
            ops += (k ** 4 - 1 + POOL_SCALE_OPS) * (w * h) ** 2
    if (w, h) != (1, 1):
        raise ValueError(f"the model leaves {w}x{h} maps")
    return ops


def kernel_ops(tree, shape) -> list:
    """The program's launches a pair (or an image's own walk) takes, as
    (kernel, ops, bytes) per pair: its plan of ops as built.  A ReLU of a
    ReLU or of the moments, or one that ends the model, rides on an
    identity pool (k = 1)."""
    c, w, h = shape
    out = []
    prologue = "moments"
    for layer in layers(tree):
        if isinstance(layer, arch.ReLU):
            if prologue != "none":
                out.append(_launch("cov_pool_kernel", 1, c, w, h, w, h,
                                   prologue))
            prologue = "relu"
            continue
        if isinstance(layer, arch.Conv):
            wo, ho = layer.out_size(w), layer.out_size(h)
            out.append(_launch("cov_conv_kernel", layer.kernel_size, c, w,
                               h, wo, ho, prologue))
        else:
            k = layer.kernel_size
            wo, ho = w // k, h // k
            out.append(_launch("cov_pool_kernel", k, c, w, h, wo, ho,
                               prologue))
        w, h, prologue = wo, ho, "none"
    if prologue != "none":
        out.append(_launch("cov_pool_kernel", 1, c, w, h, w, h, prologue))
    return out


def _launch(kernel, k, c, w, h, wo, ho, prologue):
    s_in, s_out = (w * h) ** 2, (wo * ho) ** 2
    nbytes = 4 * s_out
    ops = 0
    if prologue == "moments":
        ops += MOMENT_OPS * c * s_in
        nbytes += 4 * 2 * c * w * h          # the pair's two images
    else:
        nbytes += 4 * s_in
        if prologue == "relu":
            ops += arch.RELU_PAIR_OPS * s_in
            nbytes += 4 * 2 * 2 * w * h      # two maps of (rsqrt, sqrt)
    if kernel == "cov_conv_kernel":
        ops += (2 * (k - 1) + arch.CONV_AFFINE_OPS) * s_out
    else:
        ops += (k ** 4 - 1 + (POOL_SCALE_OPS if k > 1 else 0)) * s_out
    return kernel, ops, nbytes


def gram_work(tree, shape, n: int, b: int, peaks) -> FullWork:
    """One symmetric Gram call K(x, x) over n images in b-row tiles: every
    tile of the upper triangle, and each image's own covariance once;
    with each kernel's bound seconds over the call's pairs and images."""
    c, w, h = shape
    per_pair = pair_ops(tree, shape)
    total = arch.Work(n * per_pair, n * per_pair / peaks.FP32_FLOPS)
    for bi, bj in arch.tiles(n, b):
        ops = bi * bj * per_pair
        nbytes = 4 * ((bi + bj) * c * w * h + bi * bj)
        total = total + arch.Work(ops, max(ops / peaks.FP32_FLOPS,
                                           nbytes / peaks.HBM_BYTES_PER_S),
                                  bi * bj)
    walks = total.entries + n
    bounds = dict.fromkeys(KERNELS, 0.0)
    for kernel, ops, nbytes in kernel_ops(tree, shape):
        bounds[kernel] += walks * max(ops / peaks.FP32_FLOPS,
                                      nbytes / peaks.HBM_BYTES_PER_S)
    return FullWork(total.ops, total.bound_s, total.entries,
                    tuple(bounds.items()))


def build_model(tree, learnable: bool = False):
    """The program's model of ``tree``, built with its DSL."""
    if learnable:
        raise ValueError("the full recursion has no fit: its model takes "
                         "no learnable leaves")
    from cnn_gp_tpu_torch import AvgPool2d, Conv2d, ReLU, Sequential

    def build(t):
        if isinstance(t, arch.Conv):
            return Conv2d(t.kernel_size, stride=t.stride, padding=t.padding,
                          dilation=t.dilation, var_weight=t.var_weight,
                          var_bias=t.var_bias)
        if isinstance(t, arch.ReLU):
            return ReLU()
        if isinstance(t, Pool):
            return AvgPool2d(t.kernel_size)
        return Sequential(*[build(layer) for layer in t.layers])
    return build(tree)


def entries(tree, images: torch.Tensor, rows: torch.Tensor,
            cols: torch.Tensor, dtype=torch.float64, rounding=None):
    """The plain reference's K[rows][:, cols] (``reference/fullcov.py``)."""
    return fullcov.entries(tree, images, rows, cols, dtype, rounding)

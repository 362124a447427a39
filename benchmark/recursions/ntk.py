"""The neural tangent kernel on the full-covariance recursion (CNTK,
Arora et al. 2019, section 4): each pair carries the covariance K and
the tangent Theta over every pair of positions (``reference/ntk.py``
states the equations) and reads out Theta.  The nodes are
``recursions/full.py``'s (``conv``, ``relu``, ``pool``, ``seq``), parsed
by it; the CNTK with global average pooling (``configs/cntk_gap11.json``)
names it.  No fit hooks: the program's tangent kernels have no adjoints.

Counts from the equations, per Gram entry (and per image's own walk,
walked once a call as a pair), so that ``gram_roofline`` and
``mfu.gram`` read the same work whatever implements it: K's as
``full.pair_ops`` counts them; Theta's once it is not 0 (from the first
conv on; the first conv's Theta' is its K', no operation): per conv the
same box sum and its scale and the add of K' (2) per output, per ReLU
the K-dot (pi - theta) / (2 pi) and the product (2) per element, per
pool k^4 - 1 adds and the scale per output.  At the CNTK-GAP cell's
32 x 32 maps that is 5.53e8 operations a pair (K's 4.77e8).  Bytes: the
tile's images read and the tile written.

The work also carries ``kernels``: per kernel the least seconds its
launches of a call could take, the sum over launches of max(ops / the
FP32 peak, bytes / the memory rate), counted as the program builds them
(``ops/fullcov.py``'s plan: the ReLU in the prologue of the op that
reads it; an op that carries no tangent field, the first conv among
them, on ``cov_conv_kernel`` / ``cov_pool_kernel`` as ``full`` counts
it; the others on ``cov_ntk_conv_kernel`` / ``cov_ntk_pool_kernel``,
each reading K, the tangent where it is its own field, and the two maps
of the ReLU's factors, and writing K' and Theta' once; a ReLU prologue
41 operations an input element (K's 39, the K-dot and the product), a
conv 2 (2 (k - 1) + 2) per output, a pool 2 (k^4 - 1 + 1) per output,
no scale at k = 1).  At the cell's maps a pair's walk is 1.59e8 bytes
(the first conv 4.2e6, the second 1.26e7, the eight after it 1.68e7
each, the pool 8.4e6): every launch is bound by its bytes, 47.6 us a
walk.  The per-kernel roofline metrics
(``metrics/cov_ntk_*_roofline.gram.py``) read them.
"""

from __future__ import annotations

from .. import arch
from ..reference import ntk as reference
from . import full

KERNELS = ("cov_conv_kernel", "cov_pool_kernel", "cov_ntk_conv_kernel",
           "cov_ntk_pool_kernel")
TANGENT_RELU_OPS = 2     # per element: the K-dot and the product
TANGENT_CONV_OPS = 2     # per output: the scale and the add of K'

parse = full.parse
FullWork = full.FullWork


def pair_ops(tree, shape) -> int:
    """FP32 operations of the equations per Gram entry (and per image's
    own walk): K's (``full.pair_ops``) and Theta's once it is not 0."""
    ops = full.pair_ops(tree, shape)
    _, w, h = shape
    live = False
    for layer in full.layers(tree):
        if isinstance(layer, arch.Conv):
            wo, ho = layer.out_size(w), layer.out_size(h)
            if live:
                ops += full.box_adds(layer, w, h) + TANGENT_CONV_OPS * (
                    wo * ho) ** 2
            w, h, live = wo, ho, True
        elif isinstance(layer, arch.ReLU):
            ops += live * TANGENT_RELU_OPS * (w * h) ** 2
        else:
            k = layer.kernel_size
            w, h = w // k, h // k
            ops += live * (k ** 4 - 1 + full.POOL_SCALE_OPS) * (w * h) ** 2
    return ops


def _tangent_launch(kernel, k, w, h, wo, ho, prologue, field):
    """(kernel, ops, bytes) of one tangent op's launch a pair: K (and
    the tangent where it is its own ``field``) read, the ReLU's two
    factor maps, K' and Theta' written."""
    s_in, s_out = (w * h) ** 2, (wo * ho) ** 2
    nbytes = 4 * s_in * (1 + field) + 4 * 2 * s_out
    ops = 0
    if prologue == "relu":
        ops += (arch.RELU_PAIR_OPS + TANGENT_RELU_OPS) * s_in
        nbytes += 4 * 2 * 2 * w * h
    if kernel == "cov_ntk_conv_kernel":
        ops += 2 * (2 * (k - 1) + arch.CONV_AFFINE_OPS) * s_out
    else:
        ops += 2 * (k ** 4 - 1 + (full.POOL_SCALE_OPS if k > 1 else 0)) \
            * s_out
    return kernel, ops, nbytes


def kernel_ops(tree, shape) -> list:
    """The program's launches a pair (or an image's own walk) takes, as
    (kernel, ops, bytes) per pair: ``fullcov.plan`` for an NTK, as built.
    The tangent is 0 until the first conv and K after it until a ReLU
    reads it (state "sigma"); an op keeps to the NNGP kernels while it
    writes no tangent field of its own."""
    c, w, h = shape
    out = []
    prologue, state = "moments", "zero"

    def emit(kind, k, wo, ho):
        nonlocal prologue, state, w, h
        if kind == "conv" and state == "zero":
            out.append(full._launch("cov_conv_kernel", k, c, w, h, wo, ho,
                                    prologue))
            state = "sigma"
        elif state == "field" or (state == "sigma" and prologue == "relu"):
            out.append(_tangent_launch(f"cov_ntk_{kind}_kernel", k, w, h,
                                       wo, ho, prologue, state == "field"))
            state = "field"
        elif kind == "conv":       # a conv of K with Theta = K
            out.append(_tangent_launch("cov_ntk_conv_kernel", k, w, h, wo,
                                       ho, prologue, False))
            state = "field"
        else:
            out.append(full._launch("cov_pool_kernel", k, c, w, h, wo, ho,
                                    prologue))
        w, h, prologue = wo, ho, "none"

    for layer in full.layers(tree):
        if isinstance(layer, arch.ReLU):
            if prologue != "none":
                emit("pool", 1, w, h)
            prologue = "relu"
        elif isinstance(layer, arch.Conv):
            emit("conv", layer.kernel_size, layer.out_size(w),
                 layer.out_size(h))
        else:
            k = layer.kernel_size
            emit("pool", k, w // k, h // k)
    if prologue != "none":
        emit("pool", 1, w, h)
    return out


def gram_work(tree, shape, n: int, b: int, peaks) -> full.FullWork:
    """One symmetric Gram call K(x, x) over n images in b-row tiles: every
    tile of the upper triangle, and each image's own walk once; with each
    kernel's bound seconds over the call's pairs and images."""
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
    return full.FullWork(total.ops, total.bound_s, total.entries,
                         tuple((k, s) for k, s in bounds.items() if s))


def build_model(tree, learnable: bool = False):
    """The program's model of ``tree``: its DSL's ``NTK`` of the full
    recursion's model."""
    if learnable:
        raise ValueError("the ntk recursion has no fit: its model takes "
                         "no learnable leaves")
    from cnn_gp_tpu_torch import NTK
    return NTK(full.build_model(tree))


def entries(tree, images, rows, cols, dtype=None, rounding=None):
    """The plain reference's K[rows][:, cols] (``reference/ntk.py``)."""
    import torch
    return reference.entries(tree, images, rows, cols,
                             torch.float64 if dtype is None else dtype,
                             rounding)

"""Full-covariance NNGP recursion: the kernel of a CNN with average pooling.

A pool mixes positions, so a model that holds an ``AvgPool2d`` keeps the
covariance of every pair of positions, ``K(p, q)`` over a pair of
images, from its input on (the diagonal recursion keeps ``K(p, p)``
alone).  A pair's field is laid out [W, H, W, H] (p = (i, j), q = (k,
l)); with C channels

    input:  K0(p, q) = mean_c x_c(p) y_c(q)
    conv:   K'(p, q) = (var_weight / k^2) sum_d K(p + d - lo, q + d - lo)
                       + var_bias,  d in [0, k)^2, a term off the map 0
    ReLU:   K'(p, q) = arccos map of K(p, q) with the variances
                       Kxx(p, p) and Kyy(q, q), the diagonals of each
                       image's own full covariance
    pool:   K'(P, Q) = (1 / k^4) sum_{a, b in [0, k)^2} K(kP + a, kQ + b)

Under conv and ReLU each plane of fixed offset q - p evolves on its own;
only a pool mixes planes.  Nothing is truncated: every offset is kept.

An ``NTK`` of such a model (``kernels.NTK``; the neural tangent kernel
in the NTK parameterization, Arora et al. 2019, section 4) carries a
second field over the same pairs of positions, the tangent Theta(p, q),
and reads it out instead of K:

    input:  Theta0 = 0
    conv:   Theta'(p, q) = (var_weight / k^2) sum_d Theta(p + d - lo,
                           q + d - lo) + K'(p, q)
    ReLU:   Theta'(p, q) = Theta(p, q) (pi - theta) / (2 pi),  cos theta
                           = K(p, q) / sqrt(Kxx(p, p) Kyy(q, q)), clamped
    pool:   Theta averaged over k x k blocks, as K is

Until the first conv Theta is 0, and after a conv whose input Theta was
0 it equals K, so the plan's ops (``Op.tangent``) carry no tangent field
there (0), read K as their input tangent (``SIGMA``), or read their own
(``FIELD``), and write both fields once they carry one; an NTK of a model
without a pool takes this path too (the diagonal recursion has no
tangent).

The model (a ``Sequential`` of ``Conv2d``, ``ReLU`` and ``AvgPool2d``,
``match``) becomes a plan of ops (``plan``), each a conv or a pool whose
input passes through a prologue first: the channel moments of the images
(the first op), the arccos ReLU (a ReLU runs in the prologue of the op
that reads it), or nothing.  A ReLU that no conv or pool reads runs in
the prologue of an identity pool (k = 1).

A Gram-level call runs the plan twice:

* the pre-pass (``self_maps``), once per image set: each image against
  itself, its own full covariance, recording the diagonal before each
  ReLU (the variance maps the pairs read) and the readout k(x, x);
* the pair tile (``pair_tile``): every pair of a tile's rows and
  columns, the variances read from both sets' maps, in chunks of rows
  that keep a chunk's fields under ``CHUNK_BYTES``; entries whose row and
  column are the same image take the pre-pass readout.

Each op runs its plain torch version on CPU tensors
(``conv_reference``, ``pool_reference``, ``prologue_reference``) and one
hand-written CUDA kernel on CUDA tensors (``csrc/fullcov.cu``): the
shifted box sum with the prologue (``cov_conv_kernel``, each input read
and its prologue computed once; a 3x3 conv on square maps of a side in
``WALK_MAPS`` takes the warp walk, one warp segment per pair and pair of
offset diagonals (the moments of ``WALK_CHANNELS`` channels), its next
slab prefetched into shared memory, the taps
by shuffles and the running sums in registers, any other conv the slab
walk, one block per pair and offset diagonal behind a block barrier a
slab; both give the same bits) and the block pool with the prologue
(``cov_pool_kernel``: a 2x2 pool on square maps of a side in
``POOL_WALK_MAPS``, its prologue the ReLU or none, takes the pool walk,
a group of lanes per pair and position of x's side reading its four
input planes once by 16-byte loads, the side factors in registers and
the ReLU's roots branch-free; any other pool, the k = 1 identity pool
among them, one thread an output; both give the same bits).  On CUDA
tensors a model with a conv the kernel does not take (an even or wider
than 7 kernel, padding other than k // 2, maps past 32 along H) raises
``NotImplementedError`` before any launch; its plain version runs on
CPU tensors only.  ``conv_launches`` and ``pool_launches`` count the
launches, ``conv_walk_launches`` the convs that took the warp walk and
``pool_walk_launches`` the pools that took the pool walk.

The ops that carry a tangent field run ``cov_ntk_conv_kernel`` (a 3x3
"same" conv on square maps of a side in ``WALK_MAPS``, on a two-field
warp walk: both fields' running sums in registers, the ReLU's K-dot
(pi - theta) / (2 pi) from the same theta as its K; or a 1x1 conv,
elementwise) and ``cov_ntk_pool_kernel`` (one thread an output, or, for
a global average of maps of an even side of 4 or more, one block a pair
reducing both fields: each thread sums its float4 groups in order, then
a shuffle tree a warp and the warps' sums in order,
``ntk_pool_reference`` step for step); ``ntk_conv_launches`` and
``ntk_pool_launches`` count them.  On CUDA tensors a tangent op those
kernels do not take raises ``NotImplementedError`` before any launch.

The ReLU (``relu_xy``, on both routes) is the arccos map of
``ops/arccos.py`` in its "fast" form, each variance map's factors
``rsqrt(v + tiny)`` and ``sqrt(v + tiny)`` computed once per image
(``factors``, kept by the pre-pass) and read by every pair, with the
sine taken from the clamped cosine as ``sqrt((1 - c)(1 + c))``, not as
``sqrt(xx yy - xy^2)``: near c = 1, where a pooling network's
covariances sit, the latter's rounding is not the cosine's, the two
terms of the map stop cancelling, and a Myrtle-10 Gram drifted 3.3e-5
of its scale from the float64 reference (1.3e-7 with this form);
``settings.acos_impl`` picks the arccos.
"""

from __future__ import annotations

import ctypes
import math
import types
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import cuda_lib
from .arccos import F32_TINY, _sqrt_rn, acos_f32

__all__ = ["FullSpec", "Op", "match", "plan", "SelfMaps", "self_maps",
           "pair_tile", "diag_pairs", "apply", "conv_reference",
           "pool_reference", "prologue_reference", "relu_xy", "factors",
           "patch_conv", "patch_pool", "patch_relu", "CHUNK_BYTES", "build",
           "conv_launches", "pool_launches", "conv_walk_launches",
           "ntk_conv_launches", "ntk_pool_launches", "relu_ntk",
           "ntk_pool_reference", "WALK_MAPS", "WALK_CHANNELS",
           "POOL_WALK_MAPS", "pool_walk_launches", "COUNTERS"]

conv_launches = 0   # cov_conv_kernel launches
pool_launches = 0   # cov_pool_kernel launches
conv_walk_launches = 0   # of those, the warp walk's
pool_walk_launches = 0   # cov_pool_kernel launches on the pool walk
ntk_conv_launches = 0   # cov_ntk_conv_kernel launches
ntk_pool_launches = 0   # cov_ntk_pool_kernel launches
COUNTERS = ("conv_launches", "pool_launches", "conv_walk_launches",
            "pool_walk_launches", "ntk_conv_launches", "ntk_pool_launches")
_lib = None

# the most bytes of one chunk's input and output fields (a 64 x 64 tile
# of 32 x 32 maps holds 16 GiB a field: four chunks)
CHUNK_BYTES = 8 << 30
MAX_CONV_K = 7      # the widest conv the kernel takes
MAX_CONV_H = 32     # and the largest map side along H
NONE, RELU, MOMENTS = 0, 1, 2      # prologues (csrc/fullcov.cu)
# map sides whose 3x3 "same" convs on square maps take the warp walk
# (the kernel has it for 32, 16 and 8), and the moments' channels it takes
WALK_MAPS = (32, 16, 8)
WALK_CHANNELS = 3
# map sides whose 2x2 pools on square maps (the ReLU's prologue or none)
# take cov_pool_kernel's pool walk
POOL_WALK_MAPS = (32, 16, 8)
# an op's tangent input (Op.tangent): none carried (0), the op's input K
# (SIGMA), or its own field (FIELD)
SIGMA, FIELD = 1, 2
POOL_THREADS = 256   # cov_ntk_pool_kernel's block (a global average's)


class FullSpec(NamedTuple):
    """The model's layers as ("conv", k, lo, hi, var_weight, var_bias),
    ("relu",) and ("pool", k), in order; a snapshot of learnable leaves;
    ``ntk``: the model's NTK (``kernels.NTK``), read from its tangent
    field.  Its methods: the route of ``parallel.gram.tile_spec``, on
    SelfMaps."""
    layers: Tuple[tuple, ...]
    ntk: bool = False

    @property
    def fields(self) -> int:      # fields a pair carries: K, and Theta
        return 2 if self.ntk else 1

    def maps(self, x: torch.Tensor) -> "SelfMaps":
        return self_maps(self, x)

    def rows(self, m: "SelfMaps", i0: int, n: int) -> "SelfMaps":
        return m.rows(i0, n)

    def tile(self, x, z, mx, mz, mask=None) -> torch.Tensor:
        return pair_tile(self, x, z, mx, mz, mask)

    def readout(self, x: torch.Tensor) -> torch.Tensor:
        return self_maps(self, x).readout

    def sizes(self, m: "SelfMaps") -> str:     # each ReLU's map, WxH/...
        return "/".join(f"{v.shape[1]}x{v.shape[2]}" for v in m.factors)


class Op(NamedTuple):
    """One launch of the plan, on [W, H] maps to [Wo, Ho]."""
    kind: str          # "conv" or "pool"
    k: int
    lo: int            # conv padding before each dim (pool: 0)
    scale: float
    bias: float
    prologue: int      # NONE, RELU or MOMENTS
    relu: int          # which factor maps a RELU prologue reads (-1)
    w: int
    h: int
    wo: int
    ho: int
    tangent: int = 0   # its tangent input: none (0), SIGMA or FIELD


def _value(v) -> float:
    return float(v.detach() if isinstance(v, torch.Tensor) else v)


def _flat(model) -> list:
    from ..kernels import AvgPool2d, Conv2d, ReLU, Sequential
    if isinstance(model, Sequential):
        return [m for mod in model.mods for m in _flat(mod)]
    if isinstance(model, (Conv2d, ReLU, AvgPool2d)):
        return [model]
    raise ValueError(
        f"the full-covariance path takes a Sequential of Conv2d, ReLU and "
        f"AvgPool2d (or the NTK of one); {type(model).__name__} is not one "
        f"of them")


def _has_pool(model) -> bool:
    from ..kernels import AvgPool2d
    return any(isinstance(m, AvgPool2d) for m in model.modules())


def match(model) -> Optional[FullSpec]:
    """The model's FullSpec if it holds an ``AvgPool2d`` (and so needs the
    full covariance) or is an ``NTK`` (whose tangent field only this path
    carries), else None.  Raises on such a model this path does not take
    (a ``Sum``, a ``Mixture``, a strided or dilated conv, an ``NTK``
    inside a model)."""
    from ..kernels import NTK, AvgPool2d, Conv2d
    ntk = isinstance(model, NTK)
    inner = model.model if ntk else model
    if any(isinstance(m, NTK) for m in inner.modules()):
        raise ValueError("an NTK wraps a whole model: the full-covariance "
                         "path reads its tangent field at the readout")
    if not ntk and not _has_pool(model):
        return None
    layers = []
    for m in _flat(inner):
        if isinstance(m, Conv2d):
            if m.stride != 1 or m.dilation != 1:
                raise ValueError("the full-covariance path takes Conv2d of "
                                 "stride 1 and dilation 1")
            lo, hi = m.pad_lo_hi
            layers.append(("conv", m.kernel_size, lo, hi,
                           _value(m.var_weight), _value(m.var_bias)))
        elif isinstance(m, AvgPool2d):
            layers.append(("pool", m.kernel_size))
        else:
            layers.append(("relu",))
    return FullSpec(tuple(layers), ntk)


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def plan(spec: FullSpec, w: int, h: int) -> List[Op]:
    """The launches that take [w, h] maps through the model, each ReLU
    fused into the prologue of the op that reads it; raises unless the
    last map is 1 x 1.  For an NTK each op's ``tangent`` says what
    tangent it reads: none while Theta is 0 or equals the op's input K
    and the op keeps it so (Theta 0 until the first conv, K after it
    until a ReLU), else K (``SIGMA``) or its own field (``FIELD``)."""
    ops: List[Op] = []
    pending, relus = MOMENTS, 0
    state = 0       # Theta: 0, K (SIGMA) or a field (FIELD); NNGP: 0

    def emit(kind, k, lo, scale, bias, wo, ho):
        nonlocal pending, relus, w, h, state
        relu = relus - 1 if pending == RELU else -1
        tangent = 0
        if spec.ntk and kind == "conv":
            tangent, state = state, SIGMA if state == 0 else FIELD
        elif spec.ntk and (state == FIELD or
                           (state == SIGMA and pending == RELU)):
            tangent, state = state, FIELD
        ops.append(Op(kind, k, lo, scale, bias, pending, relu, w, h, wo, ho,
                      tangent))
        pending, w, h = NONE, wo, ho

    for layer in spec.layers:
        if layer[0] == "relu":
            if pending != NONE:      # a ReLU of a ReLU or of the moments
                emit("pool", 1, 0, 1.0, 0.0, w, h)
            pending, relus = RELU, relus + 1
        elif layer[0] == "conv":
            _, k, lo, hi, vw, vb = layer
            wo, ho = w + lo + hi - k + 1, h + lo + hi - k + 1
            if wo < 1 or ho < 1:
                raise ValueError(f"a {k}x{k} conv leaves no map of {w}x{h}")
            emit("conv", k, lo, _f32(vw) / (k * k), _f32(vb), wo, ho)
        else:
            k = layer[1]
            if w < k or h < k:
                raise ValueError(f"a {k}x{k} pool leaves no map of {w}x{h}")
            emit("pool", k, 0, 1.0 / k ** 4, 0.0, w // k, h // k)
    if pending != NONE:
        emit("pool", 1, 0, 1.0, 0.0, w, h)
    if (w, h) != (1, 1):
        raise ValueError(
            f"model must reduce spatial dims to 1x1 before readout, got "
            f"{(w, h)}; pool or add a valid-padding Conv2d over the map")
    return ops


# -- plain versions -------------------------------------------------------

def _acos():
    from .. import settings
    return acos_f32 if settings.acos_impl == "poly" else torch.acos


def factors(v: torch.Tensor) -> torch.Tensor:
    """The ReLU's factors of variances ``v`` [..., W, H]: ``(rsqrt(v +
    tiny), sqrt(v + tiny))`` stacked as [..., W, H, 2]."""
    a = v + F32_TINY
    return torch.stack((torch.rsqrt(a), torch.sqrt(a)), dim=-1)


def relu_xy(xy: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
            ) -> torch.Tensor:
    """The arccos map of covariances ``xy`` with its two sides' factors
    ``fx``, ``fy`` (``factors``, broadcast against ``xy`` with the pair
    (rsqrt, sqrt) last): ``(s + (pi - acos(c)) xy) / (2 pi)``, ``c =
    clamp(xy (rx ry))``, ``s = (sx sy) sqrt((1 - c)(1 + c))``
    (``csrc/fullcov.cu``'s ``relu_full``, op for op)."""
    c = torch.clamp(xy * (fx[..., 0] * fy[..., 0]), -1.0, 1.0)
    s = (fx[..., 1] * fy[..., 1]) * _sqrt_rn((1.0 - c) * (1.0 + c))
    return (s + (math.pi - _acos()(c)) * xy) * (0.5 / math.pi)


def relu_ntk(xy: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``relu_xy`` of ``xy`` (the same bits) and its K-dot, ``(pi -
    acos(c)) / (2 pi)`` of the same clamped cosine c, by which an NTK's
    ReLU scales the tangent (``csrc/fullcov.cu``'s ``relu_ntk``, op for
    op)."""
    c = torch.clamp(xy * (fx[..., 0] * fy[..., 0]), -1.0, 1.0)
    s = (fx[..., 1] * fy[..., 1]) * _sqrt_rn((1.0 - c) * (1.0 + c))
    pt = math.pi - _acos()(c)
    return (s + pt * xy) * (0.5 / math.pi), pt * (0.5 / math.pi)


def _zipped(v: torch.Tensor, zip_: bool, side: int):
    """Side factors ``v`` [rows, W, H, 2] broadcast over fields [A, B, W,
    H, W, H] (the pair last): side 0 (p) by A, side 1 (q) by A when
    zipped, else by B."""
    if side == 0:
        return v[:, None, :, :, None, None]
    return v[:, None, None, None] if zip_ else v[None, :, None, None]


def prologue_reference(op: Op, src, x, y, vx, vy, zip_: bool
                       ) -> torch.Tensor:
    """The op's input [A, B, W, H, W, H] after its prologue: the channel
    moments of x [A, C, W, H] and y [B, C, W, H] (zipped: row a against
    y[a], B = 1), the arccos ReLU of ``src`` with the factors vx [A, W,
    H, 2] and vy [B (zipped: A), W, H, 2], or ``src`` as it is."""
    if op.prologue == MOMENTS:
        c = x.shape[1]
        if zip_:
            m = torch.einsum("acwh,ackl->awhkl", x, y)[:, None]
        else:
            m = torch.einsum("acwh,bckl->abwhkl", x, y)
        return m / c
    if op.prologue == RELU:
        return relu_xy(src, _zipped(vx, zip_, 0), _zipped(vy, zip_, 1))
    return src


def conv_reference(r: torch.Tensor, k: int, lo: int, wo: int, ho: int,
                   scale: float, bias: float) -> torch.Tensor:
    """The shifted box sum of fields r [..., W, H, W, H] to [..., Wo, Ho,
    Wo, Ho], zero off the map: the taps along (j, l) summed first, then
    along (i, k), each in order, then scale and bias (the kernel's
    order)."""
    w, h = r.shape[-4], r.shape[-3]
    hi_w, hi_h = wo + k - 1 - lo - w, ho + k - 1 - lo - h
    pad = torch.nn.functional.pad
    rp = pad(r, (lo, hi_h, 0, 0, lo, hi_h)) if (lo or hi_h) else r
    t = None
    for b in range(k):
        s = rp[..., :, b:b + ho, :, b:b + ho]
        t = s if t is None else t + s
    tp = pad(t, (0, 0, lo, hi_w, 0, 0, lo, hi_w)) if (lo or hi_w) else t
    out = None
    for a in range(k):
        s = tp[..., a:a + wo, :, a:a + wo, :]
        out = s if out is None else out + s
    return out * scale + bias


def pool_reference(r: torch.Tensor, k: int, wo: int, ho: int,
                   scale: float) -> torch.Tensor:
    """The k x k block pool of fields r [..., W, H, W, H] (rows and
    columns past k Wo, k Ho dropped), its k^4 terms added in order, then
    scaled."""
    out = None
    for a in range(k):
        for b in range(k):
            for c in range(k):
                for d in range(k):
                    s = r[..., a:k * wo:k, b:k * ho:k, c:k * wo:k,
                          d:k * ho:k]
                    out = s if out is None else out + s
    return out * scale if k > 1 else out.clone()


def _op_reference(op: Op, src, x, y, vx, vy, zip_: bool) -> torch.Tensor:
    r = prologue_reference(op, src, x, y, vx, vy, zip_)
    if op.kind == "conv":
        return conv_reference(r, op.k, op.lo, op.wo, op.ho, op.scale,
                              op.bias)
    return pool_reference(r, op.k, op.wo, op.ho, op.scale)


def _blocked(k: int, w: int, h: int, wo: int, ho: int) -> bool:
    """Whether a tangent op's pool is a global average that
    ``cov_ntk_pool_kernel`` reduces with one block a pair: k the whole
    square map, of an even side of 4 or more (its field then splits
    into float4 groups)."""
    return (wo, ho) == (1, 1) and k == w == h and k >= 4 and k % 2 == 0


def _block_sum(r: torch.Tensor) -> torch.Tensor:
    """The sum over the last dim of ``r`` [..., n] (n a multiple of 4) as
    ``cov_ntk_pool_kernel``'s block of ``POOL_THREADS`` adds it: thread t
    takes the float4 groups t, t + 256, ... and adds their entries in
    order to its 0, each warp's 32 sums fold by halves (lane l + off onto
    l, off 16 down to 1), and the 8 warps' sums are added in order."""
    lead, n = r.shape[:-1], r.shape[-1]
    groups = n // 4
    steps = -(-groups // POOL_THREADS)
    g = torch.nn.functional.pad(r.reshape(*lead, groups, 4),
                                (0, 0, 0, steps * POOL_THREADS - groups))
    g = g.reshape(*lead, steps, POOL_THREADS, 4)
    acc = torch.zeros((*lead, POOL_THREADS), dtype=r.dtype, device=r.device)
    for i in range(steps):
        for q in range(4):
            acc = acc + g[..., i, :, q]
    acc = acc.reshape(*lead, POOL_THREADS // 32, 32)
    off = 16
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    acc = acc[..., 0]
    total = acc[..., 0]
    for wp in range(1, POOL_THREADS // 32):
        total = total + acc[..., wp]
    return total


def ntk_pool_reference(r: torch.Tensor, k: int, wo: int, ho: int,
                       scale: float) -> torch.Tensor:
    """A tangent op's k x k block pool of fields r [..., W, H, W, H]: a
    global average (``_blocked``) summed in ``cov_ntk_pool_kernel``'s
    block order (``_block_sum``) and scaled, any other pool
    ``pool_reference``'s."""
    w, h = r.shape[-4], r.shape[-3]
    if not _blocked(k, w, h, wo, ho):
        return pool_reference(r, k, wo, ho, scale)
    lead = r.shape[:-4]
    return (_block_sum(r.reshape(*lead, -1)) * scale).reshape(
        *lead, 1, 1, 1, 1)


def _ntk_op_reference(op: Op, src, tsrc, vx, vy, zip_: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A tangent op's (K', Theta') from its input K ``src`` and tangent
    ``tsrc`` (None: the tangent is ``src``): the prologue (the ReLU's K
    and K-dot times the tangent, or both fields as they are), then a
    conv (Theta' the box sum of the tangent, scaled, plus K') or a pool
    of both."""
    t = src if tsrc is None else tsrc
    if op.prologue == RELU:
        r, kdot = relu_ntk(src, _zipped(vx, zip_, 0), _zipped(vy, zip_, 1))
        t = t * kdot
    else:
        r = src
    if op.kind == "conv":
        out = conv_reference(r, op.k, op.lo, op.wo, op.ho, op.scale, op.bias)
        return out, conv_reference(t, op.k, op.lo, op.wo, op.ho, op.scale,
                                   out)
    return (ntk_pool_reference(r, op.k, op.wo, op.ho, op.scale),
            ntk_pool_reference(t, op.k, op.wo, op.ho, op.scale))


# -- the CUDA route -------------------------------------------------------

def build() -> float:
    """Build and load the kernel libraries (``cuda_lib.build``) and bind
    this module's entry points.  Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    seconds = cuda_lib.build()
    lib = cuda_lib.library("fullcov")
    head = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2)
    # the walk before the device
    for fn in (lib.cnn_gp_cov_conv, lib.cnn_gp_cov_pool):
        fn.argtypes = head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the tangent ops: src, tsrc, out, tout, fx, fy, then as above less
    # the images' channels
    for fn in (lib.cnn_gp_cov_ntk_conv, lib.cnn_gp_cov_ntk_pool):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.cnn_gp_cov_check.argtypes = [ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_uint, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.cnn_gp_cov_check.restype = ctypes.c_int
    lib.cnn_gp_cov_error_string.argtypes = [ctypes.c_int]
    lib.cnn_gp_cov_error_string.restype = ctypes.c_char_p
    _lib = types.SimpleNamespace(
        conv=lib.cnn_gp_cov_conv, pool=lib.cnn_gp_cov_pool,
        ntk_conv=lib.cnn_gp_cov_ntk_conv, ntk_pool=lib.cnn_gp_cov_ntk_pool,
        check=lib.cnn_gp_cov_check,
        error_string=lambda code: lib.cnn_gp_cov_error_string(
            code).decode())
    return seconds


def _kernel_takes(op: Op) -> bool:
    """Whether the kernels take ``op``: any pool; a tangent op's conv a
    3x3 "same" one on square maps of a side in ``WALK_MAPS`` (the
    two-field warp walk) or a 1x1 one (elementwise); any other conv of
    odd k up to ``MAX_CONV_K``, "same", on maps up to ``MAX_CONV_H``
    along H."""
    if op.kind == "pool":
        return True
    same = (op.wo, op.ho) == (op.w, op.h)
    if op.tangent:
        return same and ((op.k == 3 and op.lo == 1 and op.w == op.h
                          and op.h in WALK_MAPS)
                         or (op.k == 1 and op.lo == 0))
    return op.k % 2 == 1 and op.k <= MAX_CONV_K and op.lo == op.k // 2 \
        and same and op.h <= MAX_CONV_H


def _takes_walk(op: Op, channels: int) -> bool:
    """Whether ``op`` on images of ``channels`` channels takes its
    kernel's walk: a conv ``cov_conv_kernel``'s warp walk (a 3x3 "same"
    conv on square maps of a side in ``WALK_MAPS``, its moments, if they
    are its prologue, of ``WALK_CHANNELS``), a pool ``cov_pool_kernel``'s
    pool walk (a 2x2 pool on square maps of a side in ``POOL_WALK_MAPS``,
    its prologue the ReLU or none)."""
    if op.kind == "pool":
        return op.k == 2 and op.w == op.h and op.h in POOL_WALK_MAPS \
            and op.prologue in (NONE, RELU)
    return op.kind == "conv" and op.k == 3 and op.lo == 1 \
        and op.w == op.h and (op.wo, op.ho) == (op.w, op.h) \
        and op.h in WALK_MAPS \
        and (op.prologue != MOMENTS or channels == WALK_CHANNELS)


def _count(op: Op, walk: bool) -> None:
    """Count one launch of ``op``'s kernel (``walk``: on its walk)."""
    global conv_launches, pool_launches, conv_walk_launches
    global pool_walk_launches, ntk_conv_launches, ntk_pool_launches
    if op.tangent:
        if op.kind == "conv":
            ntk_conv_launches += 1
        else:
            ntk_pool_launches += 1
    elif op.kind == "conv":
        conv_launches += 1
        conv_walk_launches += walk
    else:
        pool_launches += 1
        pool_walk_launches += walk


def _launch(op: Op, src, x, y, vx, vy, zip_: bool, a: int, b: int,
            walk: Optional[bool] = None) -> torch.Tensor:
    """One launch of the op's kernel on ``a`` x ``b`` pairs (zipped: ``a``
    pairs, b = 1); returns the [a, b, Wo, Ho, Wo, Ho] fields.  ``walk``
    picks the kernel's walk (a conv's warp walk or a pool's pool walk
    where the kernel has it, else the slab walk or one thread an
    output); None takes ``_takes_walk``'s."""
    from .. import settings
    walk = _takes_walk(op, x.shape[1]) if walk is None else bool(walk)
    dev = x.device
    out = torch.empty((a, b, op.wo, op.ho, op.wo, op.ho),
                      dtype=torch.float32, device=dev)
    src, x, y, vx, vy = (None if t is None else t.contiguous()
                         for t in (src, x, y, vx, vy))

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = _lib.conv if op.kind == "conv" else _lib.pool
    err = fn(ptr(src), ptr(x), ptr(y), out.data_ptr(), ptr(vx), ptr(vy),
             a * b, 1 if zip_ else b, int(zip_), x.shape[1], op.w, op.h,
             op.k, op.lo, op.wo, op.ho, op.scale, op.bias, op.prologue,
             int(settings.acos_impl != "poly"), int(walk), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{op.kind} kernel launch failed: cuda error "
                           f"{err} ({_lib.error_string(err)})")
    _count(op, walk)
    return out


def _launch_ntk(op: Op, src, tsrc, vx, vy, zip_: bool, a: int, b: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of a tangent op's kernel on ``a`` x ``b`` pairs
    (zipped: ``a`` pairs, b = 1); returns the [a, b, Wo, Ho, Wo, Ho]
    fields K' and Theta'.  ``tsrc`` None: the tangent is ``src``."""
    from .. import settings
    dev = src.device
    shape = (a, b, op.wo, op.ho, op.wo, op.ho)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    tout = torch.empty(shape, dtype=torch.float32, device=dev)
    src, tsrc, vx, vy = (None if t is None else t.contiguous()
                         for t in (src, tsrc, vx, vy))

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = _lib.ntk_conv if op.kind == "conv" else _lib.ntk_pool
    err = fn(ptr(src), ptr(tsrc), out.data_ptr(), tout.data_ptr(), ptr(vx),
             ptr(vy), a * b, 1 if zip_ else b, int(zip_), op.w, op.h, op.k,
             op.lo, op.wo, op.ho, op.scale, op.bias, op.prologue,
             int(settings.acos_impl != "poly"), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tangent {op.kind} kernel launch failed: cuda "
                           f"error {err} ({_lib.error_string(err)})")
    _count(op, False)
    return out, tout


def _mismatches(which: str, lo: int, hi: int, device) -> int:
    """How many float32 bit patterns in [lo, hi] the warp walk's rounding
    without a branch (``csrc/fullcov.cu``: ``"sqrt"``, ``sqrt_unit``;
    ``"div3"``, ``div3``) rounds otherwise than CUDA's ``__fsqrt_rn(x)``
    or ``__fdiv_rn(x, 3)``, on the card ``device``."""
    build()
    dev = torch.device(device)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    err = _lib.check(("sqrt", "div3").index(which), lo, hi,
                     count.data_ptr(), dev.index,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rounding check failed: cuda error {err} "
                           f"({_lib.error_string(err)})")
    return int(count.item())


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x``'s ops take the CUDA route (the tests force that route
    on CPU tensors by patching this)."""
    return x.is_cuda


def _check_card(ops: List[Op]) -> None:
    """Raise ``NotImplementedError`` naming the first op of ``ops`` that
    the kernels do not take."""
    for op in ops:
        if op.tangent and not _kernel_takes(op):
            raise NotImplementedError(
                f"the tangent kernels take a 3x3 conv with padding 1 on "
                f"square maps of a side in {WALK_MAPS} and a 1x1 conv with "
                f"padding 0; this NTK's {op.k}x{op.k} conv with padding "
                f"{op.lo} on {op.w}x{op.h} maps is not one (its plain "
                f"version runs on CPU tensors)")
        if not _kernel_takes(op):
            raise NotImplementedError(
                f"the full-covariance conv kernel takes an odd k <= "
                f"{MAX_CONV_K}, padding k // 2 and maps up to {MAX_CONV_H} "
                f"along H; this model's {op.k}x{op.k} conv with padding "
                f"{op.lo} on {op.w}x{op.h} maps is not one (its plain "
                f"version runs on CPU tensors)")


def _run_op(op: Op, src, x, y, vx, vy, zip_: bool) -> torch.Tensor:
    """One op on fields [A, B, ...]: the kernel on CUDA tensors (the plan
    was checked by ``_shape_ops``), else the plain version."""
    if _on_card(x):
        build()
        return _launch(op, src, x, y, vx, vy, zip_, x.shape[0],
                       1 if zip_ else y.shape[0])
    return _op_reference(op, src, x, y, vx, vy, zip_)


def _run_ntk_op(op: Op, src, tsrc, vx, vy, zip_: bool, a: int, b: int):
    """A tangent op on fields [A, B, ...]: (K', Theta')."""
    if _on_card(src):
        build()
        return _launch_ntk(op, src, tsrc, vx, vy, zip_, a, b)
    return _ntk_op_reference(op, src, tsrc, vx, vy, zip_)


def _diagonal(f: torch.Tensor) -> torch.Tensor:
    """K(p, p) of zipped fields [A, 1, W, H, W, H], as [A, W, H]."""
    a, _, w, h = f.shape[:4]
    return f.reshape(a, w * h, w * h).diagonal(dim1=1, dim2=2).reshape(
        a, w, h).contiguous()


def _walk(ops: List[Op], x, y, zip_: bool, mx, my, record=None,
          ntk: bool = False):
    """The plan on x's rows against y's (zipped or every pair): the
    readout [A, B] (zipped [A]), an NTK's (``ntk``) from its tangent.
    ``mx`` / ``my`` are the factor maps per ReLU; None (the pre-pass, y
    is x, zipped) takes them from each field's own diagonal and appends
    them to ``record``."""
    f = t = None
    a, b = x.shape[0], 1 if zip_ else y.shape[0]
    for op in ops:
        vx = vy = None
        if op.prologue == RELU:
            if mx is None:
                vx = vy = factors(_diagonal(f))
                record.append(vx)
            else:
                vx, vy = mx[op.relu], my[op.relu]
        if op.tangent:
            f, t = _run_ntk_op(op, f, t, vx, vy, zip_, a, b)
        else:
            f = _run_op(op, f, x, y, vx, vy, zip_)
    if ntk and t is not None:
        f = t
    elif ntk and not any(op.kind == "conv" for op in ops):
        f = torch.zeros_like(f)        # Theta stays 0 without a conv
    return f.reshape(f.shape[0]) if zip_ else f.reshape(f.shape[:2])


def _chunk_rows(ops: List[Op], cols: int, budget: int) -> int:
    """Rows of a chunk: its largest input and output fields together
    under ``budget`` bytes (a tangent op reads one or two fields and
    writes two)."""
    per_pair = max(4 * ((1 + (op.tangent == FIELD)) * (op.w * op.h) ** 2
                        + (1 + (op.tangent > 0)) * (op.wo * op.ho) ** 2)
                   for op in ops)
    return max(1, budget // (per_pair * max(cols, 1)))


class SelfMaps(NamedTuple):
    """An image set's pre-pass: the ReLU's factors [N, W, H, 2] of the
    variance maps before each ReLU (in plan order) and the readout k(x,
    x) [N]."""
    factors: List[torch.Tensor]
    readout: torch.Tensor

    def rows(self, i0: int, n: int) -> "SelfMaps":
        return SelfMaps([v[i0:i0 + n] for v in self.factors],
                        self.readout[i0:i0 + n])

    @property
    def nbytes(self) -> int:      # as torch.Tensor.nbytes
        return 4 * (sum(v.numel() for v in self.factors)
                    + self.readout.numel())


def _shape_ops(spec: FullSpec, x: torch.Tensor) -> List[Op]:
    """The plan at x's map size; on the card, checked against what the
    kernels take."""
    if x.ndim != 4:
        raise ValueError("inputs must be [N, C, W, H]")
    ops = plan(spec, x.shape[2], x.shape[3])
    if _on_card(x):
        _check_card(ops)
    return ops


def self_maps(spec: FullSpec, x: torch.Tensor,
              budget: Optional[int] = None) -> SelfMaps:
    """The pre-pass of the image set x: each image's own full covariance
    through the model, in chunks of images."""
    ops = _shape_ops(spec, x)
    step = _chunk_rows(ops, 1, budget or CHUNK_BYTES)
    parts, outs = [], []
    for i0 in range(0, len(x), step):
        xs = x[i0:i0 + step]
        record: List[torch.Tensor] = []
        outs.append(_walk(ops, xs, xs, True, None, None, record,
                          spec.ntk))
        parts.append(record)
    if not parts:
        return SelfMaps([], x.new_empty((0,)))
    return SelfMaps([torch.cat(v) for v in zip(*parts)], torch.cat(outs))


def pair_tile(spec: FullSpec, x: torch.Tensor, z: torch.Tensor,
              mx: SelfMaps, mz: SelfMaps,
              mask: Optional[torch.Tensor] = None,
              budget: Optional[int] = None) -> torch.Tensor:
    """The [len(x), len(z)] tile: every pair through the plan in chunks
    of rows (``budget`` bytes of fields, ``CHUNK_BYTES`` by default),
    with ``mx`` / ``mz`` the rows' and columns' pre-pass maps; where
    ``mask`` marks the same image the entry is the pre-pass readout."""
    ops = _shape_ops(spec, x)
    step = _chunk_rows(ops, len(z), budget or CHUNK_BYTES)
    out = torch.empty((len(x), len(z)), dtype=torch.float32,
                      device=x.device)
    for i0 in range(0, len(x), step):
        rows = mx.rows(i0, step)
        out[i0:i0 + step] = _walk(ops, x[i0:i0 + step], z, False,
                                  rows.factors, mz.factors, ntk=spec.ntk)
    if mask is not None:
        out = torch.where(mask, mx.readout[:, None].expand_as(out), out)
    return out


def diag_pairs(spec: FullSpec, x: torch.Tensor, z: torch.Tensor,
               mx: SelfMaps, mz: SelfMaps,
               budget: Optional[int] = None) -> torch.Tensor:
    """k(x_i, z_i) [N]: the i-th images of two sets paired, in chunks."""
    ops = _shape_ops(spec, x)
    step = _chunk_rows(ops, 1, budget or CHUNK_BYTES)
    out = torch.empty((len(x),), dtype=torch.float32, device=x.device)
    for i0 in range(0, len(x), step):
        out[i0:i0 + step] = _walk(
            ops, x[i0:i0 + step], z[i0:i0 + step], True,
            mx.rows(i0, step).factors, mz.rows(i0, step).factors,
            ntk=spec.ntk)
    return out


def _same_images(x: torch.Tensor, y: torch.Tensor) -> bool:
    return x is y or (x.data_ptr() == y.data_ptr() and x.shape == y.shape)


def apply(spec: FullSpec, x: torch.Tensor, y: torch.Tensor, same: bool,
          diag: bool, diag_mask: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``kernels.apply_kernel`` for a model that needs the full
    covariance: one pre-pass per image set, then the pairs."""
    mx = self_maps(spec, x)
    my = mx if _same_images(x, y) else self_maps(spec, y)
    if diag:
        return mx.readout if same and my is mx else diag_pairs(
            spec, x, y, mx, my)
    mask = diag_mask
    if mask is None and same:
        mask = torch.eye(len(x), len(y), dtype=torch.bool, device=x.device)
    return pair_tile(spec, x, y, mx, my, mask)


# -- whole patches, layer by layer (the DSL's propagate) ------------------

def _patch_fields(kp, fn, tfn):
    """``fn`` of each field of K; with tangent fields, ``tfn(theta, k)``
    of each of them beside the new K of its place."""
    from ..kernel_patch import FullKernelPatch
    xx = fn(kp.xx)
    yy = xx if kp.yy is kp.xx else fn(kp.yy)
    xy = fn(kp.xy)
    if kp.txy is None:
        return FullKernelPatch(xy, xx, yy, kp.same, kp.diag, kp.diag_mask)
    txx = tfn(kp.txx, xx)
    tyy = txx if kp.tyy is kp.txx else tfn(kp.tyy, yy)
    return FullKernelPatch(xy, xx, yy, kp.same, kp.diag, kp.diag_mask,
                           tfn(kp.txy, xy), txx, tyy)


def patch_conv(kp, k: int, lo: int, hi: int, var_weight: float,
               var_bias: float):
    """A ``Conv2d`` of stride 1 and dilation 1 on every field of a
    ``FullKernelPatch``, in plain torch; a tangent field's box sum,
    scaled, plus the new K."""
    w, h = kp.xx.shape[1:3]
    wo, ho = w + lo + hi - k + 1, h + lo + hi - k + 1
    scale, bias = _f32(var_weight) / (k * k), _f32(var_bias)
    return _patch_fields(
        kp, lambda f: conv_reference(f, k, lo, wo, ho, scale, bias),
        lambda t, f: conv_reference(t, k, lo, wo, ho, scale, f))


def patch_pool(kp, k: int):
    """An ``AvgPool2d`` of k x k blocks on every field, in plain torch
    (with tangent fields, as a tangent op sums: ``ntk_pool_reference``)."""
    w, h = kp.xx.shape[1:3]
    pool = pool_reference if kp.txy is None else ntk_pool_reference
    return _patch_fields(
        kp, lambda f: pool(f, k, w // k, h // k, 1.0 / k ** 4),
        lambda t, f: pool(t, k, w // k, h // k, 1.0 / k ** 4))


def patch_relu(kp):
    """The arccos ReLU on every field, each image's variances the
    diagonal of its own covariance, a tangent field times the K-dot of
    its place; where the mask marks the same image the pair's fields
    are the row image's own, as after every layer."""
    from ..kernel_patch import FullKernelPatch
    fx = factors(FullKernelPatch.variances(kp.xx))
    fy = (fx if kp.yy is kp.xx
          else factors(FullKernelPatch.variances(kp.yy)))
    tangent = kp.txy is not None

    def relu(f, t, vx, vy):
        r, kdot = relu_ntk(f, vx, vy)
        return r, (t * kdot if tangent else None)
    xx, txx = relu(kp.xx, kp.txx, fx[:, :, :, None, None], fx[:, None, None])
    yy, tyy = (xx, txx) if kp.yy is kp.xx else relu(
        kp.yy, kp.tyy, fy[:, :, :, None, None], fy[:, None, None])
    if kp.diag:
        xy, txy = relu(kp.xy, kp.txy, fx[:, :, :, None, None],
                       fy[:, None, None])
        return FullKernelPatch(xy, xx, yy, kp.same, kp.diag, None, txy, txx,
                               tyy)
    xy, txy = relu(kp.xy, kp.txy, _zipped(fx, False, 0),
                   _zipped(fy, False, 1))
    mask = kp.resolve_diag_mask()
    if mask is not None:
        m = mask[:, :, None, None, None, None]
        xy = torch.where(m, xx[:, None].expand_as(xy), xy)
        if tangent:
            txy = torch.where(m, txx[:, None].expand_as(txy), txy)
    return FullKernelPatch(xy, xx, yy, kp.same, kp.diag, kp.diag_mask, txy,
                           txx, tyy)

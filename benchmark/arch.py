"""A configuration's architecture, and the work it needs.

A configuration file (``configs/<name>.json``) describes its NNGP model
as a tree of nodes:

    {"op": "conv", "kernel_size": k, "stride": s, "padding": "same" | p,
     "var_weight": w, "var_bias": b}          a Conv2d's covariance map
    {"op": "relu"}                            the arccos ReLU
    {"op": "seq", "layers": [...]}            layers in order
    {"op": "sum", "branches": [...]}          branches added

Those are the nodes of the diagonal recursion (``recursions/diagonal.py``,
which binds this module's ``parse``, ``gram_work`` and
``fit_step_work``); a configuration that names another recursion is
parsed and counted by that recursion's module.

This module resolves that tree (``Conv.pad``, map sizes) and counts the
FP32 operations and the bytes that a Gram call or a fit step needs, from
the architecture and the tile shapes alone: never from kernel names or
launch counts, so the same work reads the same whatever implements it.
The counts are a frozen copy of the arithmetic the port's smoke script
and tile sweep state (``chip_smoke.py``: ``box_adds``, ``PIXEL_OPS``,
``pair_bound``, ``prepass_bound``, ``vjp_bound``;
``scripts/cifar_sweep.py::tile_ops``), generalised to any tree:

* per pair element and pixel: the channel-mean moments (2 C), then per
  ``conv`` the separable box sum (the taps that land inside the map, less
  one, per output of each pass), the scale and the bias (2), per ``relu``
  ``RELU_PAIR_OPS`` (the arccos update 37, acos 23 of them; the
  same-example select and the halving 2), and one add per extra branch of
  a ``sum``;
* per image, once per Gram call: the same walk on its own variance maps,
  where a ``relu`` halves (1);
* bytes, each read or written once: the images of a tile's rows and
  columns, and the tile.

The paper ConvNet's 128 x 128 tile reads 4.727e9 operations, one per pair
fewer than ``chip_smoke.pair_bound`` (its readout counts ss + 2 where the
box sum has ss - 1 adds and the affine 2).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Tuple, Union

from . import recursions

ROOT = os.path.dirname(os.path.abspath(__file__))

# per pair element: relu_xy 37 (acos_f32 23 of them), the same-example
# select and the halving 2 (chip_smoke.PIXEL_OPS less the scale and bias)
RELU_PAIR_OPS = 39
RELU_SIDE_OPS = 1      # the halving of a variance map
CONV_AFFINE_OPS = 2    # scale and bias per output element


@dataclasses.dataclass(frozen=True)
class Conv:
    kernel_size: int
    stride: int
    pad: Tuple[int, int]
    dilation: int
    var_weight: float
    var_bias: float
    in_channel_multiplier: int = 1
    out_channel_multiplier: int = 1
    padding: Union[str, int] = 0   # as the configuration states it

    def out_size(self, n: int) -> int:
        eff = self.dilation * (self.kernel_size - 1) + 1
        return (n + self.pad[0] + self.pad[1] - eff) // self.stride + 1


@dataclasses.dataclass(frozen=True)
class ReLU:
    pass


@dataclasses.dataclass(frozen=True)
class Seq:
    layers: Tuple


@dataclasses.dataclass(frozen=True)
class Sum:
    branches: Tuple


def same_padding(k: int, dilation: int = 1) -> Tuple[int, int]:
    """(lo, hi) of the reference's "same": symmetric for odd kernels, one
    less before for even ones."""
    p = dilation * (k // 2)
    return (p - dilation, p) if k % 2 == 0 else (p, p)


def parse(node: dict):
    op = node["op"]
    if op == "conv":
        k = int(node["kernel_size"])
        d = int(node.get("dilation", 1))
        padding = node.get("padding", "same")
        pad = same_padding(k, d) if padding == "same" else (int(padding),) * 2
        return Conv(k, int(node.get("stride", 1)), pad, d,
                    float(node["var_weight"]), float(node["var_bias"]),
                    int(node.get("in_channel_multiplier", 1)),
                    int(node.get("out_channel_multiplier", 1)), padding)
    if op == "relu":
        return ReLU()
    if op == "seq":
        return Seq(tuple(parse(n) for n in node["layers"]))
    if op == "sum":
        return Sum(tuple(parse(n) for n in node["branches"]))
    raise ValueError(f"unknown op {op!r}")


def load_config(name: str) -> dict:
    """``configs/<name>.json`` with its recursion's module under
    ``"recursion"`` (``recursions/<r>.py``, the diagonal where the file
    names none) and its model parsed by that module under ``"tree"``."""
    with open(os.path.join(ROOT, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    rec = recursions.load(cfg.get("recursion", recursions.DEFAULT))
    cfg["recursion"] = rec
    cfg["tree"] = rec.parse(cfg["model"])
    return cfg


def convs(tree) -> List[Conv]:
    """The tree's ``Conv`` nodes in walk order (the fit's leaves come two
    to each)."""
    if isinstance(tree, Conv):
        return [tree]
    if isinstance(tree, ReLU):
        return []
    kids = tree.layers if isinstance(tree, Seq) else tree.branches
    return [c for kid in kids for c in convs(kid)]


def _taps(o: int, n: int, c: Conv) -> int:
    """Taps of output position ``o`` that land inside a map of length n."""
    start = o * c.stride - c.pad[0]
    return sum(0 <= start + a * c.dilation < n for a in range(c.kernel_size))


def box_adds(c: Conv, w: int, h: int) -> int:
    """Adds of the separable box sum over one w x h map: the W pass over
    every input row, then the H pass over every output column."""
    wo, ho = c.out_size(w), c.out_size(h)
    pass_w = h * sum(max(_taps(o, w, c) - 1, 0) for o in range(wo))
    pass_h = wo * sum(max(_taps(o, h, c) - 1, 0) for o in range(ho))
    return pass_w + pass_h


def _walk(tree, w: int, h: int, side: bool):
    """(operations per element of one field, w', h') through ``tree``: a
    pair field (``side`` False) or a variance map."""
    if isinstance(tree, Conv):
        wo, ho = tree.out_size(w), tree.out_size(h)
        return box_adds(tree, w, h) + CONV_AFFINE_OPS * wo * ho, wo, ho
    if isinstance(tree, ReLU):
        return (RELU_SIDE_OPS if side else RELU_PAIR_OPS) * w * h, w, h
    if isinstance(tree, Seq):
        ops = 0
        for layer in tree.layers:
            o, w, h = _walk(layer, w, h, side)
            ops += o
        return ops, w, h
    outs = [_walk(b, w, h, side) for b in tree.branches]
    w2, h2 = outs[0][1:]
    return sum(o for o, _, _ in outs) + (len(outs) - 1) * w2 * h2, w2, h2


def pair_ops(tree, shape) -> int:
    """FP32 operations per Gram entry: the moments and the walk."""
    c, w, h = shape
    return 2 * c * w * h + _walk(tree, w, h, False)[0]


def side_ops(tree, shape) -> int:
    """FP32 operations per image for its own variance maps."""
    c, w, h = shape
    return 2 * c * w * h + _walk(tree, w, h, True)[0]


def leaf_reduction_ops(tree, shape) -> int:
    """Per pair element of a tile VJP: the two leaf sums (d var_weight, d
    var_bias) over each conv's output (chip_smoke.vjp_bound's 2 (L + 1)
    ss, counted over the input maps as it does)."""
    _, w, h = shape
    total = 0

    def walk(t, w, h):
        nonlocal total
        if isinstance(t, Conv):
            total += 2 * w * h
            return t.out_size(w), t.out_size(h)
        if isinstance(t, ReLU):
            return w, h
        if isinstance(t, Seq):
            for layer in t.layers:
                w, h = walk(layer, w, h)
            return w, h
        return [walk(b, w, h) for b in t.branches][0]
    walk(tree, w, h)
    return total


def tile_sizes(n: int, b: int) -> List[int]:
    return [min(b, n - i) for i in range(0, n, b)]


def tiles(n: int, b: int, symmetric: bool = True) -> List[Tuple[int, int]]:
    """(rows, columns) of each tile of the upper tile triangle (or of the
    whole grid), ragged edge tiles at their size: the tiles the port's
    scheduler deals."""
    sizes = tile_sizes(n, b)
    return [(bi, bj) for i, bi in enumerate(sizes)
            for j, bj in enumerate(sizes) if not symmetric or j >= i]


@dataclasses.dataclass(frozen=True)
class Work:
    """Operations, and the least seconds the chip could take, of a piece
    of work; they add."""
    ops: float
    bound_s: float
    entries: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.bound_s + other.bound_s,
                    self.entries + other.entries)

    def __mul__(self, k: float) -> "Work":
        return Work(self.ops * k, self.bound_s * k, int(self.entries * k))


def _bound(ops: float, nbytes: float, peaks) -> float:
    return max(ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def gram_work(tree, shape, n: int, b: int, peaks) -> Work:
    """One symmetric Gram call K(x, x) over n images in b-row tiles: every
    tile of the upper triangle, and each image's variance maps once."""
    c, w, h = shape
    per_pair, per_image = pair_ops(tree, shape), side_ops(tree, shape)
    total = Work(n * per_image, n * per_image / peaks.FP32_FLOPS)
    for bi, bj in tiles(n, b):
        ops = bi * bj * per_pair
        nbytes = 4 * ((bi + bj) * c * w * h + bi * bj)
        total = total + Work(ops, _bound(ops, nbytes, peaks), bi * bj)
    return total


def vjp_work(tree, shape, n: int, b: int, peaks) -> Work:
    """One exact gradient sweep over the upper tile triangle: per tile the
    forward again and a backward of the same count, plus the leaf sums
    (chip_smoke.vjp_bound); the images and the cotangent read once; each
    image's variance maps forward and back once."""
    c, w, h = shape
    per_pair = (2 * pair_ops(tree, shape)
                + leaf_reduction_ops(tree, shape))
    per_image = 2 * side_ops(tree, shape)
    total = Work(n * per_image, n * per_image / peaks.FP32_FLOPS)
    for bi, bj in tiles(n, b):
        ops = bi * bj * per_pair
        nbytes = 4 * ((bi + bj) * c * w * h + bi * bj)
        total = total + Work(ops, _bound(ops, nbytes, peaks))
    return total


def fit_step_work(tree, shape, n: int, b: int, peaks) -> Work:
    """One exact fit step on the card: the Gram's forward and the VJP
    sweep (the host's float64 algebra is not FP32 work on the card)."""
    return gram_work(tree, shape, n, b, peaks) + vjp_work(tree, shape, n, b,
                                                          peaks)

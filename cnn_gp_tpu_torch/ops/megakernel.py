"""Whole-network ConvNet-GP Gram tile: the Hopper port of the megakernel.

PyTorch counterpart of ``cnn_gp_tpu/ops/megakernel.py``.  One call
computes a [bx, bz] Gram tile of the paper ConvNet-GP family --
``Sequential`` of L x [``Conv2d(k odd, "same", stride 1, dilation 1)``,
``ReLU``] closed by a padding-0 readout ``Conv2d`` covering the map --
with every intermediate kept on chip.  Two hand-written CUDA kernels do
it: the pre-pass (``csrc/diag_maps.cu``) computes each image's L pre-ReLU
diagonal maps once, and the pair kernel (``csrc/megakernel.cu``) runs the
per-pair recursion against them, one warp per pair.  Both are built with
``nvcc`` for ``sm_90a`` at first use into ``_build/`` (``cuda_lib``: one
``nvcc`` per source, started together) and bound with ``ctypes``.

A Gram-level caller runs the pre-pass once per image set, ``diag_maps``
on the whole set, and then ``pair_tile`` per tile on the tile's rows of
those maps (slices, read in place).  ``gram_tile`` is the one-tile form:
it runs the pre-pass on the tile's own images, then the pair kernel.
Each launches its kernels for CUDA tensors (or raises) and runs its plain
version for CPU tensors: ``pair_tile_reference`` (the per-pair recursion
reading xx and yy from the maps), ``gram_tile_reference`` (the same
network with xx and yy recomputed) and ``diag_maps_reference``;
``diag_readout`` reads the diagonal kernel k(x_i, x_i) out of the maps.
``launches`` counts pair-kernel launches (one per tile),
``prepass_launches`` pre-pass launches (one per ``diag_maps`` call, one
per side of a ``gram_tile`` call, one in all when z is x).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import time
import types
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import cuda_lib
from .arccos import F32_TINY, acos_f32
from .boxfilter import box_filter_2d_reference
from .cuda_lib import ptxas_report  # noqa: F401  (re-exported)

__all__ = ["MegaSpec", "match", "gram_tile", "gram_tile_reference",
           "pair_tile", "pair_tile_reference", "diag_maps",
           "diag_maps_reference", "diag_readout", "build", "ptxas_report",
           "launches", "prepass_launches", "COUNTERS"]

launches = 0          # pair-kernel launches by gram_tile and pair_tile
prepass_launches = 0  # pre-pass launches by gram_tile and diag_maps
COUNTERS = ("launches", "prepass_launches")
_lib = None


def _value(v) -> float:
    """A hyperparameter's current value: a float, or a learnable leaf."""
    return float(v.detach() if isinstance(v, torch.Tensor) else v)


def _f32(v: float) -> float:
    """``v`` rounded to float32: the value a learnable leaf holds."""
    return struct.unpack("f", struct.pack("f", v))[0]


class MegaSpec(NamedTuple):
    kernel_size: int
    layer_vw_vb: Tuple[Tuple[float, float], ...]   # L x (var_weight, var_bias)
    readout_k: int
    readout_vw: float
    readout_vb: float

    def layer_scales(self) -> List[Tuple[float, float]]:
        """Per layer ``(vw / k^2, vb)`` as both kernels and their plain
        versions apply them, each hyperparameter first rounded to float32:
        a static model and a learnable one (``nn.Parameter`` leaves) of the
        same values then give the same bits."""
        k2 = self.kernel_size * self.kernel_size
        return [(_f32(vw) / k2, _f32(vb)) for vw, vb in self.layer_vw_vb]

    def readout_scale(self) -> Tuple[float, float]:
        """``(vw / k^2, vb)`` of the readout, rounded as ``layer_scales``."""
        return (_f32(self.readout_vw) / (self.readout_k * self.readout_k),
                _f32(self.readout_vb))

    # the route of parallel.gram.tile_spec, on [L, N, H, W] maps
    def maps(self, x: torch.Tensor) -> torch.Tensor:
        return diag_maps(self, x)

    def rows(self, m: torch.Tensor, i0: int, n: int) -> torch.Tensor:
        return m[:, i0:i0 + n]

    def tile(self, x, z, mx, mz, mask=None) -> torch.Tensor:
        return pair_tile(self, x, z, mx, mz, mask)

    def readout(self, x: torch.Tensor) -> torch.Tensor:
        return diag_readout(self, x)

    def sizes(self, m: torch.Tensor) -> str:
        return "/".join([f"{m.shape[2]}x{m.shape[3]}"] * len(m))

    @property
    def fields(self) -> int:      # fields a pair carries: the covariance
        return 1


def match(model) -> Optional[MegaSpec]:
    """Return a MegaSpec if ``model`` is in the fusable ConvNet-GP family
    (the accept/refuse rules of ``cnn_gp_tpu.ops.megakernel.match``).
    Learnable ``Conv2d`` leaves are read at their current values, so a
    spec is a snapshot: build it again after the leaves change."""
    from ..kernels import Conv2d, ReLU, Sequential
    if not isinstance(model, Sequential):
        return None
    mods = list(model.mods)
    if len(mods) < 3 or len(mods) % 2 == 0:
        return None
    readout = mods[-1]
    if not (isinstance(readout, Conv2d) and readout.padding == 0
            and not readout.even_trick and readout.stride == 1
            and readout.dilation == 1):
        return None
    layers: List[Tuple[float, float]] = []
    k = None
    for conv, relu in zip(mods[0:-1:2], mods[1:-1:2]):
        if not (isinstance(conv, Conv2d) and isinstance(relu, ReLU)):
            return None
        if not (conv.stride == 1 and conv.dilation == 1
                and conv.kernel_size % 2 == 1
                and conv.padding == conv.kernel_size // 2
                and not conv.even_trick):
            return None
        if k is None:
            k = conv.kernel_size
        elif conv.kernel_size != k:
            return None
        layers.append((_value(conv.var_weight), _value(conv.var_bias)))
    return MegaSpec(k, tuple(layers), readout.kernel_size,
                    _value(readout.var_weight), _value(readout.var_bias))


def _recursion(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               record: Optional[list] = None,
               maps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """The per-pair recursion on [bx, bz, H, W] pair maps (xx, yy stay
    [bx, 1, H, W] and [1, bz, H, W]); returns the last ReLU's xy map.
    ``record`` collects each layer's pre-ReLU (xx, yy).  ``maps`` (dx,
    dz): the pre-pass's [L, bx, H, W] and [L, bz, H, W] maps, read as each
    layer's xx and yy instead of recomputing them (the same bits)."""
    c = x.shape[1]
    xy = xx = yy = None
    for ci in range(c):
        xc = x[:, None, ci]                  # [bx, 1, H, W]
        zc = z[None, :, ci]                  # [1, bz, H, W]
        xy = xc * zc if xy is None else xy + xc * zc
        if maps is None:
            xx = xc * xc if xx is None else xx + xc * xc
            yy = zc * zc if yy is None else yy + zc * zc
    inv_c = 1.0 / c
    xy = xy * inv_c
    if maps is None:
        xx, yy = xx * inv_c, yy * inv_c
    k = spec.kernel_size
    pad = (k // 2, k // 2)
    for li, (scale, vb) in enumerate(spec.layer_scales()):
        xy = box_filter_2d_reference(xy, k, 1, pad) * scale + vb
        if maps is None:
            xx = box_filter_2d_reference(xx, k, 1, pad) * scale + vb
            yy = box_filter_2d_reference(yy, k, 1, pad) * scale + vb
        else:
            xx, yy = maps[0][li][:, None], maps[1][li][None, :]
        if record is not None:
            record.append((xx, yy))
        xx_yy = xx * yy + F32_TINY
        cos_t = torch.clamp(xy * torch.rsqrt(xx_yy), -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(xx_yy - xy * xy, min=0.0))
        theta = acos_f32(cos_t)
        new_xy = (sin_t + (math.pi - theta) * xy) * (0.5 / math.pi)
        xx = xx * 0.5
        yy = yy * 0.5
        xy = new_xy if mask is None else torch.where(
            mask[:, :, None, None], xx.expand_as(new_xy), new_xy)
    return xy


def _readout(spec: MegaSpec, xy: torch.Tensor) -> torch.Tensor:
    r_scale, r_vb = spec.readout_scale()
    return xy.sum(dim=(-2, -1)) * r_scale + r_vb


def gram_tile_reference(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernels' network in plain torch: the same steps and the same
    (non-factored) ReLU form, on [bx, bz, H, W] pair maps, with xx and yy
    recomputed per pair: the yardstick of the math."""
    return _readout(spec, _recursion(spec, x, z, mask))


def pair_tile_reference(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
                        dx: torch.Tensor, dz: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pair kernel's network in plain torch on given maps: the per-pair
    recursion with xx and yy read from ``dx`` and ``dz`` ([L, bx, H, W]
    and [L, bz, H, W], ``diag_maps_reference`` of x and z or slices of a
    set's) and halved after each layer.  Bit for bit
    ``gram_tile_reference``, since the maps equal its xx and yy."""
    return _readout(spec, _recursion(spec, x, z, mask, maps=(dx, dz)))


def diag_maps_reference(spec: MegaSpec, x: torch.Tensor) -> torch.Tensor:
    """The pre-pass in plain torch: [L, b, H, W] pre-ReLU diagonal maps
    d_l = box(h_{l-1}) * vw/k^2 + vb with h_0 = sum_c x_c^2 * (1/C) and
    h_l = d_l * 0.5, in the per-pair recursion's order of operations (so
    equal bit for bit to its xx at every layer)."""
    c = x.shape[1]
    h = None
    for ci in range(c):
        xc = x[:, ci]
        h = xc * xc if h is None else h + xc * xc
    h = h * (1.0 / c)
    k = spec.kernel_size
    pad = (k // 2, k // 2)
    maps = []
    for scale, vb in spec.layer_scales():
        d = box_filter_2d_reference(h, k, 1, pad) * scale + vb
        maps.append(d)
        h = d * 0.5
    return torch.stack(maps)


def build() -> float:
    """Build and load the kernel libraries (``cuda_lib.build``: every
    source under ``csrc/``, one ``nvcc`` each, started together) and bind
    this module's two entry points.  Returns the seconds spent (0.0 when
    nothing was done)."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    pair, pre = cuda_lib.library("megakernel"), cuda_lib.library("diag_maps")
    pair.cnn_gp_pair_tile.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    pair.cnn_gp_pair_tile.restype = ctypes.c_int
    pre.cnn_gp_diag_maps.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    pre.cnn_gp_diag_maps.restype = ctypes.c_int
    pair.cnn_gp_megakernel_error_string.argtypes = [ctypes.c_int]
    pair.cnn_gp_megakernel_error_string.restype = ctypes.c_char_p
    _lib = types.SimpleNamespace(
        cnn_gp_pair_tile=pair.cnn_gp_pair_tile,
        cnn_gp_diag_maps=pre.cnn_gp_diag_maps,
        error_string=lambda code: pair.cnn_gp_megakernel_error_string(
            code).decode())
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=16)
def _layer_params(spec: MegaSpec, device: torch.device) -> torch.Tensor:
    """[L, 2] float32 (vw / k^2, vb) on ``device``, uploaded once."""
    return torch.tensor(spec.layer_scales(), dtype=torch.float32,
                        device=device)


def _check_images(spec: MegaSpec, name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.ndim != 4:
        raise ValueError(f"{name} must be a 4-D float32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    h, w = t.shape[2:]
    if not spec.readout_k == h == w:
        raise ValueError(f"readout kernel {spec.readout_k} must cover the "
                         f"{h}x{w} map")


def _check(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
           mask: Optional[torch.Tensor]) -> None:
    _check_images(spec, "x", x)
    _check_images(spec, "z", z)
    if x.device != z.device:
        raise ValueError(f"x on {x.device} but z on {z.device}")
    if x.shape[1] != z.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and z {tuple(z.shape)} differ "
                         f"in channels")
    if mask is not None:
        if mask.shape != (x.shape[0], z.shape[0]):
            raise ValueError(f"mask {tuple(mask.shape)} does not match the "
                             f"({x.shape[0]}, {z.shape[0]}) tile")
        if mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError(f"mask must be bool or uint8, got {mask.dtype}")
        if mask.device != x.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous and on x's device")


def _map_stride(spec: MegaSpec, name: str, d: torch.Tensor,
                x: torch.Tensor) -> int:
    """Check ``d`` as the pre-pass maps of ``x`` ([L, b, H, W] float32 on
    x's device, each image's map contiguous, layers a whole number of
    maps apart, not overlapping) and return its layer stride in images."""
    n_layers, (b, _, h, w) = len(spec.layer_vw_vb), x.shape
    if d.dtype != torch.float32 or tuple(d.shape) != (n_layers, b, h, w):
        raise ValueError(f"{name} must be the [{n_layers}, {b}, {h}, {w}] "
                         f"float32 maps of its images, got {d.dtype} "
                         f"{tuple(d.shape)}")
    if d.device != x.device:
        raise ValueError(f"{name} on {d.device} but its images on "
                         f"{x.device}")
    hw = h * w
    ld = d.stride(0) // hw if n_layers > 1 else b
    if (d.stride()[1:] != (hw, w, 1)
            or (n_layers > 1 and (d.stride(0) % hw or ld < b))):
        raise ValueError(f"{name}: each image's map must be contiguous and "
                         f"the layers whole maps apart, got strides "
                         f"{d.stride()}")
    return ld


def gram_tile(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One [bx, bz] Gram tile of the fused network, for any bx, bz.

    ``x``: [bx, C, H, W]; ``z``: [bz, C, H, W] float32; ``mask``: [bx, bz]
    bool or uint8 of same-example pairs, or None.  CUDA tensors launch the
    pre-pass (once when z is x) and the pair kernel, or the call raises;
    CPU tensors run the plain version.
    """
    _check(spec, x, z, mask)
    if x.device.type == "cpu":
        return gram_tile_reference(spec, x, z,
                                   None if mask is None else mask.bool())
    return _launch(spec, x, z, mask)


def pair_tile(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
              dx: torch.Tensor, dz: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One [bx, bz] Gram tile on given pre-pass maps: ``dx`` [L, bx, H, W]
    of x and ``dz`` [L, bz, H, W] of z, typically the tile's slices
    ``d[:, i0:i0 + bx]`` of ``diag_maps`` over a whole image set (read in
    place: each image's map contiguous, the layers any whole number of
    maps apart).  x, z and mask as in ``gram_tile``.  CUDA tensors launch
    the pair kernel, or the call raises; CPU tensors run
    ``pair_tile_reference``."""
    _check(spec, x, z, mask)
    ldx, ldz = _map_stride(spec, "dx", dx, x), _map_stride(spec, "dz", dz, z)
    if x.device.type == "cpu":
        return pair_tile_reference(spec, x, z, dx, dz,
                                   None if mask is None else mask.bool())
    _require_cuda(x)
    build()
    return _launch_pair(spec, x, z, dx, dz, ldx, ldz, mask,
                        _layer_params(spec, x.device),
                        torch.cuda.current_stream(x.device).cuda_stream)


def diag_maps(spec: MegaSpec, x: torch.Tensor) -> torch.Tensor:
    """[L, N, H, W] pre-ReLU diagonal maps of the images ``x`` ([N, C, H,
    W] float32, any N: a tile side or a whole image set): the pre-pass
    kernel for a CUDA tensor (or the call raises), ``diag_maps_reference``
    for a CPU tensor."""
    _check_images(spec, "x", x)
    if x.device.type == "cpu":
        return diag_maps_reference(spec, x)
    _require_cuda(x)
    build()
    return _launch_diag_maps(spec, x, _layer_params(spec, x.device),
                             torch.cuda.current_stream(x.device).cuda_stream)


def diag_readout(spec: MegaSpec, x: torch.Tensor) -> torch.Tensor:
    """[b] diagonal kernel k(x_i, x_i): the readout of the last halved
    pre-ReLU map of ``diag_maps`` (a same-example pair's xy equals its
    halved xx at every layer)."""
    return _readout(spec, diag_maps(spec, x)[-1] * 0.5)


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the megakernel runs on cuda tensors, not on "
                         f"{x.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"megakernel {what} launch failed: cuda error "
                           f"{err} ({_lib.error_string(err)})")


def _launch(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA path of ``gram_tile``: launch the kernels or raise."""
    _require_cuda(x)
    build()
    return _launch_kernels(spec, x, z, mask,
                           torch.cuda.current_stream(x.device).cuda_stream)


def _same_images(x: torch.Tensor, z: torch.Tensor) -> bool:
    """z is x: the same storage and shape (both contiguous)."""
    return x.data_ptr() == z.data_ptr() and x.shape == z.shape


def _launch_kernels(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
                    mask: Optional[torch.Tensor], stream) -> torch.Tensor:
    """The pre-pass for x (and for z unless z is x), then the pair
    kernel, all on ``stream``."""
    params = _layer_params(spec, x.device)
    dx = _launch_diag_maps(spec, x, params, stream)
    dz = dx if _same_images(x, z) else _launch_diag_maps(spec, z, params,
                                                         stream)
    return _launch_pair(spec, x, z, dx, dz, len(x), len(z), mask, params,
                        stream)


def _launch_diag_maps(spec: MegaSpec, x: torch.Tensor, params: torch.Tensor,
                      stream) -> torch.Tensor:
    """The pre-pass: [L, b, H, W] maps into a new scratch tensor."""
    global prepass_launches
    b, c, h, w = x.shape
    n_layers = len(spec.layer_vw_vb)
    out = torch.empty((n_layers, b, h, w), dtype=torch.float32,
                      device=x.device)
    _raise_on(_lib.cnn_gp_diag_maps(
        x.data_ptr(), params.data_ptr(), out.data_ptr(), b, c, h,
        spec.kernel_size, n_layers, x.device.index, stream), "pre-pass")
    prepass_launches += 1
    return out


def _launch_pair(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
                 dx: torch.Tensor, dz: torch.Tensor, ldx: int, ldz: int,
                 mask: Optional[torch.Tensor], params: torch.Tensor,
                 stream) -> torch.Tensor:
    """The pair kernel of one tile, on the pre-pass's maps dx, dz (their
    layers ldx and ldz images apart)."""
    global launches
    bx, c, h, _ = x.shape
    bz = z.shape[0]
    out = torch.empty((bx, bz), dtype=torch.float32, device=x.device)
    r_scale, r_vb = spec.readout_scale()
    _raise_on(_lib.cnn_gp_pair_tile(
        x.data_ptr(), z.data_ptr(), dx.data_ptr(), dz.data_ptr(),
        None if mask is None else mask.data_ptr(), params.data_ptr(),
        out.data_ptr(), bx, bz, ldx, ldz, c, h, spec.kernel_size,
        len(spec.layer_vw_vb), r_scale, r_vb, x.device.index, stream),
        "pair kernel")
    launches += 1
    return out

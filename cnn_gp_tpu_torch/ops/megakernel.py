"""Whole-network ConvNet-GP Gram tile: the Hopper port of the megakernel.

PyTorch counterpart of ``cnn_gp_tpu/ops/megakernel.py``.  One call
computes a [bx, bz] Gram tile of the paper ConvNet-GP family --
``Sequential`` of L x [``Conv2d(k odd, "same", stride 1, dilation 1)``,
``ReLU``] closed by a padding-0 readout ``Conv2d`` covering the map --
with every intermediate kept on chip.  Two hand-written CUDA kernels do
it: the pre-pass (``csrc/diag_maps.cu``) computes each image's L pre-ReLU
diagonal maps once, and the pair kernel (``csrc/megakernel.cu``) runs the
per-pair recursion against them, one warp per pair.  Both are built with
``nvcc`` for ``sm_90a`` at first use into ``_build/`` (one ``nvcc`` per
source, started together) and bound with ``ctypes``.

``gram_tile`` launches both for CUDA tensors (or raises) and runs
``gram_tile_reference``, the same network in plain torch, for CPU tensors;
``diag_maps`` does the same for the pre-pass alone, against
``diag_maps_reference``; ``diag_readout`` reads the diagonal kernel
k(x_i, x_i) out of its maps.  ``launches`` counts pair-kernel launches
(one per tile), ``prepass_launches`` pre-pass launches (one per side of a
tile, one in all when z is x, one per ``diag_maps`` call).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import struct
import subprocess
import time
import types
from typing import List, NamedTuple, Optional, Tuple

import torch

from .arccos import F32_TINY, acos_f32
from .boxfilter import box_filter_2d

__all__ = ["MegaSpec", "match", "gram_tile", "gram_tile_reference",
           "diag_maps", "diag_maps_reference", "diag_readout", "build",
           "ptxas_report", "launches", "prepass_launches"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "megakernel.cu"),
           os.path.join(_PKG, "csrc", "diag_maps.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

launches = 0          # pair-kernel launches by gram_tile
prepass_launches = 0  # pre-pass launches by gram_tile and diag_maps
_lib = None
build_log = ""        # nvcc's output (ptxas register/shared-memory report)


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
               record: Optional[list] = None) -> torch.Tensor:
    """The per-pair recursion on [bx, bz, H, W] pair maps (xx, yy stay
    [bx, 1, H, W] and [1, bz, H, W]); returns the last ReLU's xy map.
    ``record`` collects each layer's pre-ReLU (xx, yy)."""
    c = x.shape[1]
    xy = xx = yy = None
    for ci in range(c):
        xc = x[:, None, ci]                  # [bx, 1, H, W]
        zc = z[None, :, ci]                  # [1, bz, H, W]
        xy = xc * zc if xy is None else xy + xc * zc
        xx = xc * xc if xx is None else xx + xc * xc
        yy = zc * zc if yy is None else yy + zc * zc
    inv_c = 1.0 / c
    xy, xx, yy = xy * inv_c, xx * inv_c, yy * inv_c
    k = spec.kernel_size
    pad = (k // 2, k // 2)
    for scale, vb in spec.layer_scales():
        xy = box_filter_2d(xy, k, 1, pad) * scale + vb
        xx = box_filter_2d(xx, k, 1, pad) * scale + vb
        yy = box_filter_2d(yy, k, 1, pad) * scale + vb
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
        d = box_filter_2d(h, k, 1, pad) * scale + vb
        maps.append(d)
        h = d * 0.5
    return torch.stack(maps)


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the megakernel "
                           "is built from csrc/*.cu at first use")
    return found


def build() -> float:
    """Compile (or reuse from ``_build/``) one shared library per source,
    one ``nvcc`` each, all started together, and load them if they are
    not loaded yet.  Returns the seconds spent (0.0 when nothing was
    done)."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    paths = [os.path.join(BUILD_DIR, f"lib{os.path.basename(src)[:-3]}-"
                                     f"{tag}.so") for src in SOURCES]
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for src, path in zip(SOURCES, paths):
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(f"{tmp}.log", "w") as log:
                running.append((src, path, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=log,
                    stderr=subprocess.STDOUT)))
    failed = []
    for src, path, tmp, proc in running:
        code = proc.wait()
        if code != 0:
            with open(f"{tmp}.log") as f:
                failed.append(f"nvcc failed on {src}:\n{f.read()}")
            continue
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = []
    for path in paths:
        with open(f"{path}.log") as f:
            logs.append(f.read())
    pair, pre = (ctypes.CDLL(p) for p in paths)
    pair.cnn_gp_pair_tile.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
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
    build_log = "".join(logs)
    return time.perf_counter() - t0


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_TEMPLATE = re.compile(r"ILi(\d+)ELi(\d+)E")


def ptxas_report(log: str) -> List[dict]:
    """One dict per kernel in ptxas's ``-v`` output: ``kernel`` (a
    readable name: ``pair_kernel<28,7>`` for the register kernel of 28x28
    maps and k=7), ``registers``, ``spill_stores``, ``spill_loads``."""
    out: List[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            for base in ("pair_kernel_generic", "pair_kernel",
                         "diag_maps_kernel"):
                if base in name:
                    t = _TEMPLATE.search(name)
                    name = base + (f"<{t.group(1)},{t.group(2)}>"
                                   if t and base == "pair_kernel" else "")
                    break
            out.append({"kernel": name, "registers": None,
                        "spill_stores": None, "spill_loads": None})
            continue
        if not out:
            continue
        m = _SPILLS.search(line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


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


def gram_tile(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One [bx, bz] Gram tile of the fused network, for any bx, bz.

    ``x``: [bx, C, H, W]; ``z``: [bz, C, H, W] float32; ``mask``: [bx, bz]
    bool or uint8 of same-example pairs, or None.  CUDA tensors launch the
    pre-pass and the pair kernel, or the call raises; CPU tensors run the
    plain version.
    """
    _check(spec, x, z, mask)
    if x.device.type == "cpu":
        return gram_tile_reference(spec, x, z,
                                   None if mask is None else mask.bool())
    return _launch(spec, x, z, mask)


def diag_maps(spec: MegaSpec, x: torch.Tensor) -> torch.Tensor:
    """[L, b, H, W] pre-ReLU diagonal maps of the images ``x`` ([b, C, H,
    W] float32): the pre-pass kernel for a CUDA tensor (or the call
    raises), ``diag_maps_reference`` for a CPU tensor."""
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
    return _launch_pair(spec, x, z, dx, dz, mask, params, stream)


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
                 dx: torch.Tensor, dz: torch.Tensor,
                 mask: Optional[torch.Tensor], params: torch.Tensor,
                 stream) -> torch.Tensor:
    """The pair kernel of one tile, on the pre-pass's maps dx, dz."""
    global launches
    bx, c, h, _ = x.shape
    bz = z.shape[0]
    out = torch.empty((bx, bz), dtype=torch.float32, device=x.device)
    r_scale, r_vb = spec.readout_scale()
    _raise_on(_lib.cnn_gp_pair_tile(
        x.data_ptr(), z.data_ptr(), dx.data_ptr(), dz.data_ptr(),
        None if mask is None else mask.data_ptr(), params.data_ptr(),
        out.data_ptr(), bx, bz, c, h, spec.kernel_size,
        len(spec.layer_vw_vb), r_scale, r_vb, x.device.index, stream),
        "pair kernel")
    launches += 1
    return out

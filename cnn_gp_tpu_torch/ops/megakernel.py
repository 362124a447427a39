"""Whole-network ConvNet-GP Gram tile: the Hopper port of the megakernel.

PyTorch counterpart of ``cnn_gp_tpu/ops/megakernel.py``.  One call
computes a [bx, bz] Gram tile of the paper ConvNet-GP family --
``Sequential`` of L x [``Conv2d(k odd, "same", stride 1, dilation 1)``,
``ReLU``] closed by a padding-0 readout ``Conv2d`` covering the map --
with every intermediate kept on chip.  The kernel is hand-written CUDA
(``csrc/megakernel.cu``), built with ``nvcc`` for ``sm_90a`` at first use
into ``_build/`` and bound with ``ctypes``.

``gram_tile`` launches the kernel for CUDA tensors (or raises) and runs
``gram_tile_reference``, the same network in plain torch, for CPU tensors.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from .arccos import F32_TINY, acos_f32
from .boxfilter import box_filter_2d

__all__ = ["MegaSpec", "match", "gram_tile", "gram_tile_reference", "build",
           "launches"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "megakernel.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

launches = 0          # kernel launches by gram_tile
_lib = None
build_log = ""        # nvcc's output (ptxas register/shared-memory report)


class MegaSpec(NamedTuple):
    kernel_size: int
    layer_vw_vb: Tuple[Tuple[float, float], ...]   # L x (var_weight, var_bias)
    readout_k: int
    readout_vw: float
    readout_vb: float


def match(model) -> Optional[MegaSpec]:
    """Return a MegaSpec if ``model`` is in the fusable ConvNet-GP family
    (the accept/refuse rules of ``cnn_gp_tpu.ops.megakernel.match``)."""
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
        layers.append((float(conv.var_weight), float(conv.var_bias)))
    return MegaSpec(k, tuple(layers), readout.kernel_size,
                    float(readout.var_weight), float(readout.var_bias))


def gram_tile_reference(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's network in plain torch: the same steps and the same
    (non-factored) ReLU form, on [bx, bz, H, W] pair maps."""
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
    for vw, vb in spec.layer_vw_vb:
        scale = vw / (k * k)
        xy = box_filter_2d(xy, k, 1, pad) * scale + vb
        xx = box_filter_2d(xx, k, 1, pad) * scale + vb
        yy = box_filter_2d(yy, k, 1, pad) * scale + vb
        xx_yy = xx * yy + F32_TINY
        cos_t = torch.clamp(xy * torch.rsqrt(xx_yy), -1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(xx_yy - xy * xy, min=0.0))
        theta = acos_f32(cos_t)
        new_xy = (sin_t + (math.pi - theta) * xy) * (0.5 / math.pi)
        xx = xx * 0.5
        yy = yy * 0.5
        xy = new_xy if mask is None else torch.where(
            mask[:, :, None, None], xx.expand_as(new_xy), new_xy)
    r_scale = spec.readout_vw / (spec.readout_k * spec.readout_k)
    return xy.sum(dim=(-2, -1)) * r_scale + spec.readout_vb


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the megakernel "
                           "is built from csrc/megakernel.cu at first use")
    return found


def build() -> float:
    """Compile and load the kernel library if it is not loaded yet.
    Returns the seconds spent (0.0 when nothing was done)."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libmegakernel-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True)
        build_log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    fn = lib.cnn_gp_megakernel_gram_tile
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.cnn_gp_megakernel_error_string.argtypes = [ctypes.c_int]
    lib.cnn_gp_megakernel_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=16)
def _layer_params(spec: MegaSpec, device: torch.device) -> torch.Tensor:
    """[L, 2] float32 (vw / k^2, vb) on ``device``, uploaded once."""
    k2 = spec.kernel_size * spec.kernel_size
    return torch.tensor([[vw / k2, vb] for vw, vb in spec.layer_vw_vb],
                        dtype=torch.float32, device=device)


def _check(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
           mask: Optional[torch.Tensor]) -> None:
    for name, t in (("x", x), ("z", z)):
        if t.dtype != torch.float32 or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D float32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device != z.device:
        raise ValueError(f"x on {x.device} but z on {z.device}")
    if x.shape[1:] != z.shape[1:]:
        raise ValueError(f"x {tuple(x.shape)} and z {tuple(z.shape)} differ "
                         f"in channels or spatial size")
    h, w = x.shape[2:]
    if not spec.readout_k == h == w:
        raise ValueError(f"readout kernel {spec.readout_k} must cover the "
                         f"{h}x{w} map")
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
    CUDA kernel, or the call raises; CPU tensors run the plain version.
    """
    _check(spec, x, z, mask)
    if x.device.type == "cpu":
        return gram_tile_reference(spec, x, z,
                                   None if mask is None else mask.bool())
    return _launch(spec, x, z, mask)


def _launch(spec: MegaSpec, x: torch.Tensor, z: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The CUDA path of ``gram_tile``: launch the kernel or raise."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the megakernel runs on cuda tensors, not on "
                         f"{x.device}")
    build()
    bx, c, h, w = x.shape
    bz = z.shape[0]
    out = torch.empty((bx, bz), dtype=torch.float32, device=x.device)
    params = _layer_params(spec, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib.cnn_gp_megakernel_gram_tile(
        x.data_ptr(), z.data_ptr(),
        None if mask is None else mask.data_ptr(), params.data_ptr(),
        out.data_ptr(), bx, bz, c, h, w, spec.kernel_size,
        len(spec.layer_vw_vb),
        spec.readout_vw / (spec.readout_k * spec.readout_k),
        spec.readout_vb, x.device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"megakernel launch failed: cuda error {err} "
            f"({_lib.cnn_gp_megakernel_error_string(err).decode()})")
    launches += 1
    return out

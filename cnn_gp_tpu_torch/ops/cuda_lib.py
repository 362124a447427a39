"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` (one
``nvcc`` per source, all started together) and loaded with ``ctypes``.
The libraries are keyed by a hash of every source, every header
(``csrc/*.cuh``) and ``NVCC_FLAGS``, so a changed file rebuilds them all.  Nothing is built when this module is
imported: each kernel's wrapper calls ``build`` at its first launch, and
the first call builds the seven libraries at once.  ``build_log`` holds
ptxas's register report and ``ptxas_report`` parses it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List

__all__ = ["SOURCES", "HEADERS", "BUILD_DIR", "NVCC_FLAGS", "build", "library",
           "ptxas_report", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# library name -> source: the megakernel's pair kernel and pre-pass, the
# Conv2d box filter (with the fused ResNet layer), the arccos ReLU, the
# adjoints of the last two (the fit's backward), and the full-covariance
# recursion's conv and pool (ops/fullcov.py)
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("megakernel", "diag_maps", "boxfilter", "arccos",
                        "boxfilter_vjp", "arccos_vjp", "fullcov")}
HEADERS = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cuh")))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

build_log = ""        # nvcc's output (ptxas register/shared-memory report)
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are "
                           "built from csrc/*.cu at first use")
    return found


def build() -> float:
    """Compile (or reuse from ``_build/``) one shared library per source,
    one ``nvcc`` each, all started together, and load them if they are
    not loaded yet.  Returns the seconds spent (0.0 when nothing was
    done)."""
    global build_log
    if _libs:
        return 0.0
    t0 = time.perf_counter()
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [*SOURCES.values(), *HEADERS]:
        with open(src, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    paths = {name: os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
             for name in SOURCES}
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name, src in SOURCES.items():
        path = paths[name]
        if not os.path.exists(path):
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(f"{tmp}.log", "w") as log:
                running.append((src, path, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=log,
                    stderr=subprocess.STDOUT)))
    failed = []
    for src, path, tmp, proc in running:
        if proc.wait() != 0:
            with open(f"{tmp}.log") as f:
                failed.append(f"nvcc failed on {src}:\n{f.read()}")
            continue
        os.replace(f"{tmp}.log", f"{path}.log")
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = []
    for path in paths.values():
        with open(f"{path}.log") as f:
            logs.append(f.read())
    _libs.update({name: ctypes.CDLL(path) for name, path in paths.items()})
    build_log = "".join(logs)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built at the first
    call)."""
    build()
    return _libs[name]


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_TEMPLATE = re.compile(r"I((?:Li\d+E)+)E")
_KERNELS = ("pair_kernel_generic", "pair_kernel", "diag_maps_kernel",
            "diag_maps_fixed", "cov_conv_kernel", "cov_pool_kernel",
            "box_layer_staged", "box_layer_unstaged", "relu_kernel",
            "box_vjp_kernel", "relu_vjp_pair", "relu_vjp_diagonal",
            "cov_ntk_conv_kernel", "cov_ntk_pool_kernel")


def ptxas_report(log: str) -> List[dict]:
    """One dict per kernel in ptxas's ``-v`` output: ``kernel`` (a
    readable name: ``pair_kernel<28,7>`` for the register kernel of 28x28
    maps and k=7, ``box_layer_staged<28,3,1,1,28>`` for the box filter of
    28x28 maps, k=3, stride 1, lo 1, to 28x28, ``box_layer_staged<0,0,0,
    0,0>`` for its run-time geometry), ``registers``, ``spill_stores``,
    ``spill_loads``, and ``smem`` where ptxas reports static shared
    memory (its bytes; the staged box filter's planes take dynamic shared
    memory on top, ``boxfilter.plan``)."""
    out: List[dict] = []
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            for base in _KERNELS:
                if base in name:
                    t = _TEMPLATE.search(name)
                    args = re.findall(r"Li(\d+)E", t.group(1)) if t else []
                    name = base + (f"<{','.join(args)}>" if args else "")
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
            s = _SMEM.search(line)
            if s:
                out[-1]["smem"] = int(s.group(1))
    return out

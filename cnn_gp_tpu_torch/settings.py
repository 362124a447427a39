"""Global numerics settings for the kernel compute path.

PyTorch counterpart of ``cnn_gp_tpu/settings.py``: the same switches with
the same defaults, read at call time.  ``override`` swaps them for the
duration of a ``with`` block.  ``snapshot()`` has the JAX package's tuple
layout, so a posterior saved by either package records settings that the
other compares equal (``serving.GPPredictor``).
"""

from __future__ import annotations

import contextlib

import torch

from .ops import arccos as _arccos, boxfilter as _boxfilter

# The port has one lowering each for the box filter and the ReLU, which
# computes what each of the JAX package's does; these record them under
# its names (its defaults) for snapshot(), and an unknown name raises
# ValueError where JAX's would (ops/boxfilter.py::check_method: "shifts",
# "separable", "direct", "matmul"; ops/arccos.py::check_method: "auto",
# "xla"), with their DEFAULT_METHOD as the default.
conv_method = _boxfilter.DEFAULT_METHOD
relu_method = _arccos.DEFAULT_METHOD
# arccos implementation inside the ReLU transform: "poly" (Cephes-style
# polynomial, the one the megakernel evaluates) | "exact" (torch.acos).
acos_impl = "poly"
# ReLU transform structure: "fast" hoists the rsqrt/sqrt of the row and
# column variances out of the pair grid; "reference" follows the
# reference's exact op order.
relu_impl = "fast"
# Precision of the input second-moment contraction.  "highest" means full
# float32: TF32 must be off for both cuBLAS matmuls and cuDNN, which
# ``apply_kernel`` checks and the entry points (CLI scripts,
# chip_smoke.py) enforce with ``disable_tf32``.
moment_precision = "highest"
# Differentiation-safe ReLU transform: masked (same-example) entries feed a
# neutral input to the branch whose output is discarded, so leaf gradients
# through a masked tile stay finite.  Primal values are unchanged; ``fit``
# turns it on where it differentiates.
grad_safe = False


def snapshot():
    return (conv_method, relu_method, acos_impl, relu_impl,
            moment_precision, grad_safe)


def disable_tf32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN (``moment_precision="highest"``).

    ``torch.backends.cudnn.allow_tf32`` defaults to True, so without this
    a float32 convolution would silently round its inputs to TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_precision() -> None:
    """Raise if TF32 is on while ``moment_precision="highest"``."""
    if moment_precision == "highest" and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError(
            "moment_precision='highest' needs full float32, but TF32 is on "
            "(torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            f"torch.backends.cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}); call "
            "cnn_gp_tpu_torch.settings.disable_tf32() first")


def check_precision_on(device) -> None:
    """``check_precision()`` for work on ``device``: TF32 exists only on
    CUDA, so CPU work needs no check."""
    if torch.device(device).type == "cuda":
        check_precision()


@contextlib.contextmanager
def override(**kwargs):
    import cnn_gp_tpu_torch.settings as s
    old = {k: getattr(s, k) for k in kwargs}
    try:
        for k, v in kwargs.items():
            setattr(s, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(s, k, v)

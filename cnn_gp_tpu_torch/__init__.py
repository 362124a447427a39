"""PyTorch port of cnn_gp_tpu for NVIDIA Hopper (H100).

The same NNGP kernel DSL, Gram assembly, store and GP solve as the JAX
package, with its module names.  Models of the paper ConvNet-GP family
compute their Gram tiles with a hand-written CUDA kernel
(``ops/megakernel.py``, ``csrc/megakernel.cu``); every other model runs
each ``Conv2d`` and ``ReLU`` on a hand-written CUDA kernel of its own
(``csrc/boxfilter.cu``, ``csrc/arccos.cu``) and the rest on plain torch
ops.  ``finite.py`` mirrors each kernel model as S random
finite-width networks evaluated in one grouped forward.  This package
never imports jax.
"""

from .kernel_patch import KernelPatch
from .kernels import (NNGPKernel, Conv2d, ReLU, Sequential, Sum, Mixture,
                      resnet_block, kernel_fn, input_patch, apply_kernel,
                      apply_kernel_reference)
from .finite import FiniteNet, sample_nn_outputs
from . import settings

__all__ = [
    "KernelPatch", "NNGPKernel", "Conv2d", "ReLU", "Sequential", "Sum",
    "Mixture", "resnet_block", "kernel_fn", "input_patch", "apply_kernel",
    "apply_kernel_reference", "FiniteNet", "sample_nn_outputs", "settings",
]

__version__ = "0.1.0"

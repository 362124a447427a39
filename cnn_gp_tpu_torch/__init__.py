"""PyTorch port of cnn_gp_tpu for NVIDIA Hopper (H100).

The same NNGP kernel DSL, Gram assembly, store and GP solve as the JAX
package, with its module names.  Models of the paper ConvNet-GP family
compute their Gram tiles with a hand-written CUDA kernel
(``ops/megakernel.py``), a model with a pool, or the NTK of a model
(``NTK``), with the full covariance's (``ops/fullcov.py``); every other model runs each ``Conv2d`` and ``ReLU``
on one of its own (``csrc/boxfilter.cu``, ``csrc/arccos.cu``) and the
rest on plain torch ops.  ``finite.py`` mirrors each kernel model as S
random finite-width networks evaluated in one grouped forward.  This
package never imports jax.

The top level exports what ``cnn_gp_tpu``'s does (pinned by
``tests/test_torch_surface.py``), with the same meaning for ``fit``: the
name is the function ``fit.fit``, which shadows the submodule as an
attribute, and the module is ``fit_lib``.  So ``from cnn_gp_tpu_torch
import fit`` gives the function in both packages, and code that wants the
module imports ``fit_lib`` or ``cnn_gp_tpu_torch.fit``'s names
(``from cnn_gp_tpu_torch.fit import fit_large``).  Importing the package
imports neither h5py nor tensorstore: the stores load them when one is
opened.
"""

from .kernel_patch import FullKernelPatch, KernelPatch
from .kernels import (NNGPKernel, Conv2d, ReLU, AvgPool2d, NTK, Sequential,
                      Sum, Mixture, resnet_block, kernel_fn, input_patch,
                      apply_kernel, apply_kernel_reference)
from .finite import FiniteNet, sample_nn_outputs
from . import settings
from . import fit as fit_lib
from .fit import fit, neg_marginal_log_likelihood
from .data import (DatasetFromConfig, ProductIterator, DiagIterator,
                   GramStore, open_store)
from .parallel import save_K
from .utils import print_timings

__all__ = [
    "KernelPatch", "FullKernelPatch", "NNGPKernel", "Conv2d", "ReLU",
    "AvgPool2d", "NTK", "Sequential", "Sum",
    "Mixture", "resnet_block", "kernel_fn", "input_patch", "apply_kernel",
    "apply_kernel_reference", "FiniteNet", "sample_nn_outputs", "settings",
    "fit", "fit_lib", "neg_marginal_log_likelihood", "DatasetFromConfig",
    "ProductIterator", "DiagIterator", "GramStore", "open_store", "save_K",
    "print_timings",
]

__version__ = "0.1.0"

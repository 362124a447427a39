"""Model/dataset configs for the port.

The repo's ``configs/`` modules build ``cnn_gp_tpu`` (JAX) models, so the
port carries copies built from its own classes, with the same ranges and
hyperparameters (``tests/test_torch_convert.py`` holds each equal to its
JAX config).  Each config is a plain module with attributes
``dataset_name``, ``train_range`` / ``validation_range`` / ``test_range``
(index ranges into the concatenated train+test pool), ``in_channels``,
``out_channels``, ``transforms`` and ``initial_model``.

Ported: every config of the repo's ``configs/``: ``synthetic``,
``mnist_paper_convnet_gp`` (the megakernel's ConvNet GP),
``mnist_paper_residual_cnn_gp`` (eight ``Sum`` residual blocks with an
even 4x4 kernel), ``mnist_as_tf`` with its 16k and 4k rehearsal splits
``mnist_as_tf_16k`` and ``mnist_as_tf_mini``, ``mnist`` (the default
``--config`` of the drivers: ResNet-32 on the 50k/10k/10k split) and
``cifar10`` (ResNet-32 on 32x32 images, tile 350); and, the full
covariance's (``ops/fullcov.py``), ``cifar10_myrtle10`` (Myrtle-10) and
``cifar10_cntk_gap11`` (the CNTK with global average pooling at depth
11, an ``NTK``).  ``synthetic``
and ``mnist_paper_convnet_gp`` take the megakernel; the ResNets run on
the fused layer kernels (``ops/layer.py``).
"""

import importlib


def load(name: str):
    """Load a config module by name."""
    return importlib.import_module(f"cnn_gp_tpu_torch.configs.{name}")


def image_shape(config) -> tuple:
    """[C, W, H] input shape this config's dataset produces."""
    name = config.dataset_name
    if name == "MNIST":
        return (1, 28, 28)
    if name == "CIFAR10":
        return (3, 32, 32)
    return (config.in_channels, 28, 28)       # synthetic default

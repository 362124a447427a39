"""Model/dataset configs for the port.

The repo's ``configs/`` modules build ``cnn_gp_tpu`` (JAX) models, so the
port carries copies built from its own classes, with the same ranges and
hyperparameters (``tests/test_torch_convert.py`` holds each equal to its
JAX config).  Each config is a plain module with attributes
``dataset_name``, ``train_range`` / ``validation_range`` / ``test_range``
(index ranges into the concatenated train+test pool), ``in_channels``,
``out_channels``, ``transforms`` and ``initial_model``.

Ported: ``synthetic``, ``mnist_paper_convnet_gp``, ``mnist_as_tf`` and
``mnist`` (the default ``--config`` of the drivers: ResNet-32 on the
50k/10k/10k split).
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

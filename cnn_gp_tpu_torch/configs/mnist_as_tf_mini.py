"""Scaled-down mnist_as_tf for dress rehearsals: the same ResNet-32 GP on a
4k/1k/1k MNIST split (copy of ``configs/mnist_as_tf_mini.py``)."""

from cnn_gp_tpu_torch.configs.mnist_as_tf import (  # noqa: F401
    dataset_name, model_name, transforms, epochs, in_channels, out_channels,
    initial_model)

train_range = range(0, 4096)
validation_range = range(4096, 5120)
test_range = range(60000, 61024)

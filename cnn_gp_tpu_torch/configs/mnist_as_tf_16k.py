"""Production-scale rehearsal config: the mnist_as_tf ResNet-32 GP on a
16k/2k/2k MNIST split (copy of ``configs/mnist_as_tf_16k.py``)."""

from cnn_gp_tpu_torch.configs.mnist_as_tf import (  # noqa: F401
    dataset_name, model_name, transforms, epochs, in_channels, out_channels,
    initial_model)

train_range = range(0, 16384)
validation_range = range(16384, 18432)
test_range = range(60000, 62048)

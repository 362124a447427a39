"""ResNet-32 GP on MNIST with the 50k/10k/10k split (copy of
``configs/mnist.py``)."""

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
from cnn_gp_tpu_torch.configs._resnet32 import resnet32_trunk

train_range = range(50000)
validation_range = range(50000, 60000)
test_range = range(60000, 70000)

dataset_name = "MNIST"
model_name = "ResNet"
transforms = []
epochs = 0
in_channels = 1
out_channels = 10

initial_model = Sequential(
    *resnet32_trunk(),
    # No nonlinearity here, the next Conv2d substitutes the average pooling
    Conv2d(kernel_size=7, padding=0, in_channel_multiplier=4,
           out_channel_multiplier=4),
    ReLU(),
    Conv2d(kernel_size=1, padding=0, in_channel_multiplier=4),
)

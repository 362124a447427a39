"""ResNet-32 GP on CIFAR-10 (copy of ``configs/cifar10.py``)."""

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
from cnn_gp_tpu_torch.configs._resnet32 import resnet32_trunk

train_range = range(40000)
validation_range = range(40000, 50000)
test_range = range(50000, 60000)

kernel_batch_size = 350

dataset_name = "CIFAR10"
model_name = "ResNet"
transforms = []
epochs = 0
in_channels = 3
out_channels = 10

initial_model = Sequential(
    *resnet32_trunk(),
    # No nonlinearity here, the next Conv2d substitutes the average pooling
    Conv2d(kernel_size=8, padding=0, in_channel_multiplier=4,
           out_channel_multiplier=4),
    Conv2d(kernel_size=1, padding=0, in_channel_multiplier=4,
           out_channel_multiplier=4),
    ReLU(),
    Conv2d(kernel_size=1, padding=0, in_channel_multiplier=4),
)

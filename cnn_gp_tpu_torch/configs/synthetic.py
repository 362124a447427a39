"""Synthetic smoke-test config: tiny ConvNet GP on generated 28x28 data
(copy of ``configs/synthetic.py``).  Runs the whole pipeline with no
dataset files: the task is 10-class 'prototype + noise' images."""

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential

train_range = range(0, 512)
validation_range = range(512, 640)
test_range = range(640, 768)

dataset_name = "synthetic"
model_name = "ConvNet"
transforms = []
epochs = 0
in_channels = 1
out_channels = 10

var_bias = 7.86
var_weight = 2.79

initial_model = Sequential(
    Conv2d(kernel_size=7, padding="same", var_weight=var_weight * 7**2,
           var_bias=var_bias),
    ReLU(),
    Conv2d(kernel_size=7, padding="same", var_weight=var_weight * 7**2,
           var_bias=var_bias),
    ReLU(),
    Conv2d(kernel_size=28, padding=0, var_weight=var_weight,
           var_bias=var_bias),
)

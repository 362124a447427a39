"""Myrtle-10 NNGP on CIFAR-10: a full-covariance kernel with average
pooling (Shankar et al., "Neural Kernels Without Tangents", ICML 2020,
arXiv:2003.02237; the layer list of the paper's code and of Neural
Tangents' ``stax`` Myrtle network).

Three stages of ``[Conv 3x3 SAME, ReLU] x 3`` at 32x32, 16x16 and 8x8,
a 2x2 average pool after the first two and three after the last (8 -> 4
-> 2 -> 1, a global average), then the dense readout; W_std = sqrt(2)
and b_std = 0 throughout, so ``var_weight = 2`` (this DSL's ``Conv2d``
scales the box sum by ``var_weight / k^2``) and ``var_bias = 0``.  The
pools need the covariance of every pair of positions
(``ops/fullcov.py``): the megakernel refuses the model, and the
tiled fit refuses it (its kernels have no adjoints)."""

from cnn_gp_tpu_torch import AvgPool2d, Conv2d, ReLU, Sequential

train_range = range(40000)
validation_range = range(40000, 50000)
test_range = range(50000, 60000)

kernel_batch_size = 64

dataset_name = "CIFAR10"
model_name = "Myrtle10"
transforms = []
epochs = 0
in_channels = 3
out_channels = 10

VAR_WEIGHT = 2.0
VAR_BIAS = 0.0


def _stage(depth=3):
    return [layer for _ in range(depth)
            for layer in (Conv2d(3, var_weight=VAR_WEIGHT,
                                 var_bias=VAR_BIAS), ReLU())]


initial_model = Sequential(
    *_stage(), AvgPool2d(2),
    *_stage(), AvgPool2d(2),
    *_stage(), AvgPool2d(2), AvgPool2d(2), AvgPool2d(2),
    Conv2d(1, padding=0, var_weight=VAR_WEIGHT, var_bias=VAR_BIAS),
)

"""CNTK-GAP on CIFAR-10: the neural tangent kernel of a CNN with global
average pooling at depth 11 (Arora, Du, Hu, Li, Salakhutdinov and Wang,
"On Exact Computation with an Infinitely Wide Neural Net", NeurIPS 2019,
arXiv:1904.11955, section 4 and Table 1; the authors' code is
github.com/ruosongwang/CNTK).

Depth 11 read as 11 layers of weights: ten ``[Conv 3x3 SAME, ReLU]`` at
32x32, the global average (``AvgPool2d(32)``), then the dense readout (a
1x1 conv on the 1x1 map); ``var_weight = 2`` and ``var_bias = 0`` in
every layer, the first included (c_sigma = 2 of the paper, up to one
global factor, which kernel regression without a ridge does not see).
``NTK`` makes it the tangent kernel: the full-covariance route
(``ops/fullcov.py``) carries the tangent field beside the covariance;
the megakernel and the layer kernels refuse it, and the tiled fit
refuses it (its kernels have no adjoints)."""

from cnn_gp_tpu_torch import NTK, AvgPool2d, Conv2d, ReLU, Sequential

train_range = range(40000)
validation_range = range(40000, 50000)
test_range = range(50000, 60000)

kernel_batch_size = 32

dataset_name = "CIFAR10"
model_name = "CNTK_GAP11"
transforms = []
epochs = 0
in_channels = 3
out_channels = 10

VAR_WEIGHT = 2.0
VAR_BIAS = 0.0
DEPTH = 10          # conv / ReLU layers before the pool

initial_model = NTK(Sequential(
    *[layer for _ in range(DEPTH)
      for layer in (Conv2d(3, var_weight=VAR_WEIGHT, var_bias=VAR_BIAS),
                    ReLU())],
    AvgPool2d(32),
    Conv2d(1, padding=0, var_weight=VAR_WEIGHT, var_bias=VAR_BIAS),
))

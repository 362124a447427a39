"""Residual CNN GP: the paper's best randomly-searched ResNet (copy of
``configs/mnist_paper_residual_cnn_gp.py``).

The original paper sums branches *after* the ReLU nonlinearity, whose
outputs are neither Gaussian nor zero-mean, so the finite network does not
converge to a GP; the kernel itself is still valid.  The reference
replicates this deliberately for result reproducibility and so does the
port.  The correct construction is ``cnn_gp_tpu_torch.resnet_block``,
which sums after a Conv2d.

The empty ``Sequential()`` branch is the identity, and ``kernel_size=4``
with ``padding="same"`` takes the even-kernel trick (asymmetric padding).
"""

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential, Sum

train_range = range(5000, 55000)
validation_range = list(range(55000, 60000)) + list(range(0, 5000))
test_range = range(60000, 70000)

dataset_name = "MNIST"
model_name = "ResNet"
transforms = []
epochs = 0
in_channels = 1
out_channels = 10

var_bias = 4.69
var_weight = 7.27

initial_model = Sequential(
    *(Sum([
        Sequential(),
        Sequential(
            Conv2d(kernel_size=4, padding="same", var_weight=var_weight * 4**2,
                   var_bias=var_bias),
            ReLU(),
        )]) for _ in range(8)),
    Conv2d(kernel_size=4, padding="same", var_weight=var_weight * 4**2,
           var_bias=var_bias),
    ReLU(),
    Conv2d(kernel_size=28, padding=0, var_weight=var_weight,
           var_bias=var_bias),
)

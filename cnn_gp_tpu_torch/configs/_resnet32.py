"""Shared ResNet-32 trunk (copy of ``configs/_resnet32.py``): Conv3x3 stem
+ 3 stages x 5 pre-activation resnet blocks with stride-2 + projection
shortcuts at stage entries and channel multipliers 1/2/4."""

from cnn_gp_tpu_torch import Conv2d, resnet_block


def resnet32_trunk():
    return [
        Conv2d(kernel_size=3),

        # Big resnet block #1
        resnet_block(stride=1, projection_shortcut=True, multiplier=1),
        resnet_block(stride=1, projection_shortcut=False, multiplier=1),
        resnet_block(stride=1, projection_shortcut=False, multiplier=1),
        resnet_block(stride=1, projection_shortcut=False, multiplier=1),
        resnet_block(stride=1, projection_shortcut=False, multiplier=1),

        # Big resnet block #2
        resnet_block(stride=2, projection_shortcut=True, multiplier=2),
        resnet_block(stride=1, projection_shortcut=False, multiplier=2),
        resnet_block(stride=1, projection_shortcut=False, multiplier=2),
        resnet_block(stride=1, projection_shortcut=False, multiplier=2),
        resnet_block(stride=1, projection_shortcut=False, multiplier=2),

        # Big resnet block #3
        resnet_block(stride=2, projection_shortcut=True, multiplier=4),
        resnet_block(stride=1, projection_shortcut=False, multiplier=4),
        resnet_block(stride=1, projection_shortcut=False, multiplier=4),
        resnet_block(stride=1, projection_shortcut=False, multiplier=4),
        resnet_block(stride=1, projection_shortcut=False, multiplier=4),
    ]

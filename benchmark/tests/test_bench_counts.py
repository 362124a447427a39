"""The operation and byte counts come from the architecture and the tile
shapes: the paper tile, a ResNet block by hand, the tile grids."""

import pytest

from benchmark import arch, peaks


def _cfg(name):
    cfg = arch.load_config(name)
    return cfg["tree"], tuple(cfg["image_shape"])


def test_paper_tile_reads_4_73e9():
    tree, shape = _cfg("convnet_gp")
    ops = 128 * 128 * arch.pair_ops(tree, shape)
    assert round(ops / 1e9, 2) == 4.73
    # chip_smoke.pair_bound's count, ss + 2 for the readout where the box
    # sum has ss - 1 adds and the affine 2: one operation a pair more
    ss = 28 * 28
    line = sum(min(27, p + 3) - max(0, p - 3) for p in range(28))
    smoke = 2 * ss + 7 * (2 * 28 * line + 41 * ss) + ss + 2
    assert arch.pair_ops(tree, shape) == smoke - 1


def test_prepass_count_matches_the_smoke():
    tree, shape = _cfg("convnet_gp")
    ss = 28 * 28
    box = arch.box_adds(arch.convs(tree)[0], 28, 28)
    readout = ss + 1     # the readout's box sum and affine on one image
    assert arch.side_ops(tree, shape) == 2 * ss + 7 * (box + 3 * ss) + readout


def test_resnet_block_by_hand():
    """An identity block at 28 x 28: two ReLUs, two 3 x 3 "same" convs,
    the residual add; and a stride-2 projection block."""
    conv = {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
            "var_weight": 1.0, "var_bias": 0.0}
    block = arch.parse({"op": "sum", "branches": [
        {"op": "seq", "layers": []},
        {"op": "seq", "layers": [{"op": "relu"}, conv, {"op": "relu"},
                                 conv]}]})
    ss = 28 * 28
    # one 3-tap pass along a 28-long line: 26 interior outputs of 2 adds,
    # 2 edge outputs of 1
    line = 26 * 2 + 2 * 1
    box = 2 * 28 * line
    per_pair = 2 * 39 * ss + 2 * (box + 2 * ss) + ss
    assert arch._walk(block, 28, 28, False) == (per_pair, 28, 28)
    proj = arch.parse({"op": "conv", "kernel_size": 1, "stride": 2,
                       "padding": 0, "var_weight": 1.0, "var_bias": 0.0})
    # a 1 x 1 window adds nothing: the affine over the 14 x 14 output
    assert arch._walk(proj, 28, 28, False) == (2 * 14 * 14, 14, 14)
    down = arch.parse(dict(conv, stride=2))
    # 14 outputs along 28 at stride 2 from -1: the first sees 2 taps
    assert arch.box_adds(down, 28, 28) == 28 * 27 + 14 * 27
    assert down.out_size(28) == 14


@pytest.mark.parametrize("name, n, b, tiles, entries", [
    ("convnet_gp", 16384, 128, 8256, 135266304),
    ("resnet32", 8192, 200, 861, 34372864),
    ("convnet_gp", 2048, 128, 136, 2228224),
    ("convnet_gp", 24576, 128, 18528, 303562752),
])
def test_tile_grids(name, n, b, tiles, entries):
    tree, shape = _cfg(name)
    assert len(arch.tiles(n, b)) == tiles
    work = arch.gram_work(tree, shape, n, b, peaks)
    assert work.entries == entries
    # the ConvNet and the ResNet are bound by operations, not bytes
    assert work.bound_s == pytest.approx(work.ops / peaks.FP32_FLOPS,
                                         rel=1e-9)


def test_fit_step_counts_the_vjp_as_chip_smoke_does():
    tree, shape = _cfg("convnet_gp")
    fwd = arch.pair_ops(tree, shape)
    assert (arch.leaf_reduction_ops(tree, shape) == 2 * 8 * 28 * 28)
    step = arch.fit_step_work(tree, shape, 2048, 128, peaks)
    gram = arch.gram_work(tree, shape, 2048, 128, peaks)
    vjp = step.ops - gram.ops
    pairs = gram.entries
    assert vjp == (pairs * (2 * fwd + 2 * 8 * 784)
                   + 2 * 2048 * arch.side_ops(tree, shape))

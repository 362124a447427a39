"""The full-covariance recursion (``recursions/full.py``): the Myrtle-10
cell's recorded work, the counts against hand counts at a small
geometry, the per-kernel roofline readers, and the reference's blocks
and symmetric shortcut against its plain walk."""

import pytest
import torch

from benchmark import arch, harness, peaks, recursions
from benchmark.recursions import full
from benchmark.reference import fullcov as ref

from conftest import SEED

# (operations, bound seconds, entries) of one call of the cell at its own
# sizes (N 512, tile 64), as ``full.gram_work`` counts them
WORK = {"myrtle10.gram_card": (23303054468096, 0.3478067831059108, 147456)}

TINY = {"op": "seq", "layers": [
    {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
     "var_weight": 2.0, "var_bias": 0.1}, {"op": "relu"},
    {"op": "pool", "kernel_size": 2}, {"op": "pool", "kernel_size": 2},
    {"op": "conv", "kernel_size": 1, "stride": 1, "padding": 0,
     "var_weight": 2.0, "var_bias": 0.0}]}


def _driver(cell):
    c = harness.load_cell(cell)
    group = harness.Group(0, 1, torch.device("cpu"))
    return c, harness.driver(c["mix"]["driver"]).Driver(c, SEED, group)


@pytest.mark.parametrize("cell", sorted(WORK))
def test_the_work_of_a_call_is_the_recorded_one(cell):
    c, drv = _driver(cell)
    assert c["cfg"]["recursion"] is full
    w = drv.work_per_call()
    assert (w.ops, w.bound_s, w.entries) == WORK[cell]
    assert drv.tiles_per_call() == 36
    kernels = dict(w.kernels)
    assert set(kernels) == set(full.KERNELS)
    # one pass a layer: the conv and pool kernels' byte bound is ~1.2 s
    # a call, past the recursion's compute bound
    assert 1.0 < sum(kernels.values()) < 1.5


def test_counts_by_hand():
    """A 4x4 map of 2 channels: conv 3x3 same, ReLU, two 2x2 pools, a 1x1
    readout.  Per entry: moments 2 C S^2 = 1024; the conv's two passes
    18 adds each (of the 16 output pairs of a dimension, the 7 with a 0
    and the 7 with a 3 lose a tap) over 16 rows: 576, its affine 512;
    the ReLU 39 x 256; the pools 16 x 16 and 16 x 1; the readout's
    affine 2."""
    tree = full.parse(TINY)
    shape = (2, 4, 4)
    assert full.pair_ops(tree, shape) == (1024 + 576 + 512 + 39 * 256
                                          + 16 * 16 + 16 + 2)
    assert full.kernel_ops(tree, shape) == [
        ("cov_conv_kernel", 1024 + 6 * 256, 4 * 256 + 4 * 2 * 2 * 16),
        ("cov_pool_kernel", 39 * 256 + 16 * 16,
         4 * 256 + 4 * 16 + 4 * 2 * 2 * 16),
        ("cov_pool_kernel", 16, 4 * 16 + 4),
        ("cov_conv_kernel", 2, 4 + 4)]
    w = full.gram_work(tree, shape, 5, 2, peaks)
    # tiles of 2, 2 and 1 rows: the upper triangle's six
    assert w.entries == 4 + 4 + 2 + 4 + 2 + 1
    walks = w.entries + 5
    want = walks * sum(max(o / peaks.FP32_FLOPS, b / peaks.HBM_BYTES_PER_S)
                       for k, o, b in full.kernel_ops(tree, shape)
                       if k == "cov_pool_kernel")
    assert dict(w.kernels)["cov_pool_kernel"] == pytest.approx(want)


def test_a_relu_of_the_moments_rides_an_identity_pool():
    tree = full.parse({"op": "seq", "layers": [
        {"op": "relu"}, {"op": "pool", "kernel_size": 2}]})
    kinds = [(k, o) for k, o, _ in full.kernel_ops(tree, (1, 2, 2))]
    assert kinds == [("cov_pool_kernel", 2 * 16),
                     ("cov_pool_kernel", 39 * 16 + 16)]


def test_the_full_recursion_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="unknown op"):
        full.parse({"op": "sum", "branches": []})
    with pytest.raises(ValueError, match="stride 1"):
        full.parse({"op": "conv", "kernel_size": 3, "stride": 2,
                    "var_weight": 1.0, "var_bias": 0.0})
    with pytest.raises(ValueError, match="no fit"):
        full.build_model(full.parse(TINY), learnable=True)
    missing = [h for h in recursions.FIT_HOOKS if hasattr(full, h)]
    assert missing == []
    with pytest.raises(ValueError, match="fit hooks"):
        recursions.require_fit(full)


@pytest.mark.parametrize("name", ["cov_conv_roofline.gram",
                                  "cov_pool_roofline.gram"])
def test_the_kernel_roofline_readers(name):
    """A kernel's bound seconds over its device seconds in the trace; no
    number without the kernel in the trace (the parent's program) or
    without its count (a recursion that brings none)."""
    kernel = name.split("_roofline")[0] + "_kernel"
    read = harness.reader(name)
    work = full.FullWork(1.0, 0.5, 3, ((kernel, 0.02),))
    traced = [{"wall_s": 0.2, "busy_s": 0.15, "kernels": 10,
               "nccl_s": 0.0,
               "device_ops": [[kernel, 0.05], ["other", 0.1]]}]
    ctx = {"kind": "gram", "chips": 1, "calls": 1, "window_s": 1.0,
           "work_per_call": work, "units_per_call": 3, "tiles_per_call": 1,
           "traced": traced, "peaks": peaks}
    assert read(ctx) == pytest.approx(40.0)
    assert read(dict(ctx, kind="fit")) is None
    assert read(dict(ctx, traced=[dict(traced[0], device_ops=[])])) is None
    assert read(dict(ctx, work_per_call=arch.Work(1.0, 0.5, 3))) is None


def _images(n, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 2, w, w), generator=g, dtype=torch.float64)


def test_the_reference_blocks_and_shortcuts_change_nothing():
    """One pair a block against all pairs in one, the symmetric list's
    upper triangle mirrored against rows and columns taken apart, each
    against the plain walk of one pair at a time."""
    tree = full.parse(TINY)
    x = _images(5, 4, 3)
    idx = torch.arange(5)
    whole = ref.entries(tree, x, idx, idx)
    assert torch.equal(ref.entries(tree, x, idx, idx, block_bytes=1), whole)
    assert torch.equal(whole, whole.T)
    apart = ref.entries(tree, x, idx[:3], idx[2:])
    assert torch.allclose(apart, whole[:3, 2:], rtol=1e-14, atol=0)
    var, readout = ref.own(tree, x, lambda t: t)
    assert torch.equal(whole.diagonal(), readout)
    for i, j in ((0, 1), (3, 4)):
        one = ref.pairs(tree, x[[i]], x[[j]], [v[[i]] for v in var],
                        [v[[j]] for v in var], lambda t: t)
        assert float(one) == pytest.approx(float(whole[i, j]), rel=1e-14)

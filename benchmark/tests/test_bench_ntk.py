"""The NTK on the full-covariance recursion (``recursions/ntk.py``): the
CNTK-GAP cell's recorded work, the counts against hand counts at a small
geometry, the tangent kernels' roofline readers, and the reference's
blocks and symmetric shortcut against its plain walk, and its Theta
against the diagonal recursion where the two meet."""

import pytest
import torch

from benchmark import arch, harness, peaks, recursions
from benchmark.recursions import full, ntk
from benchmark.reference import ntk as ref

from conftest import SEED

# (operations, bound seconds, entries) of one call of the cell at its own
# sizes (N 256, tile 32), as ``ntk.gram_work`` counts them
WORK = {"cntk_gap11.gram_card": (20525115130880, 0.3063450019534327,
                                 36864)}

TINY = {"op": "seq", "layers": [
    {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
     "var_weight": 2.0, "var_bias": 0.1}, {"op": "relu"},
    {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
     "var_weight": 1.5, "var_bias": 0.2}, {"op": "relu"},
    {"op": "pool", "kernel_size": 4},
    {"op": "conv", "kernel_size": 1, "stride": 1, "padding": 0,
     "var_weight": 2.0, "var_bias": 0.0}]}


def _driver(cell):
    c = harness.load_cell(cell)
    group = harness.Group(0, 1, torch.device("cpu"))
    return c, harness.driver(c["mix"]["driver"]).Driver(c, SEED, group)


@pytest.mark.parametrize("cell", sorted(WORK))
def test_the_work_of_a_call_is_the_recorded_one(cell):
    c, drv = _driver(cell)
    assert c["cfg"]["recursion"] is ntk
    w = drv.work_per_call()
    assert (w.ops, w.bound_s, w.entries) == WORK[cell]
    assert drv.tiles_per_call() == 36
    kernels = dict(w.kernels)
    assert set(kernels) == {"cov_conv_kernel", "cov_ntk_conv_kernel",
                            "cov_ntk_pool_kernel"}
    # bound by bytes: 1.60e8 a walk over 37,120 walks, ~1.77 s a call,
    # 92% of it the tangent convs
    assert 1.7 < sum(kernels.values()) < 1.85
    assert kernels["cov_ntk_conv_kernel"] > 0.9 * sum(kernels.values())


def test_counts_by_hand():
    """A 4x4 map of 2 channels: conv 3x3, ReLU, conv 3x3, ReLU, a global
    average, a 1x1 readout.  K's count (``full.pair_ops``): moments 1024,
    each conv 576 adds and 512 affine, each ReLU 39 x 256, the pool 256,
    the readout 2; Theta's from the first conv on: the first ReLU's
    K-dot and product 512, the second conv's box sum 576 and scale and
    add 512, the second ReLU 512, the pool 256, the readout 2.  As
    built: the first conv on cov_conv_kernel with the moments, then the
    tangent ops, their ReLU prologues 41 an input element."""
    tree = ntk.parse(TINY)
    shape = (2, 4, 4)
    k_ops = 1024 + 2 * (576 + 512) + 2 * 39 * 256 + 256 + 2
    assert full.pair_ops(tree, shape) == k_ops
    assert ntk.pair_ops(tree, shape) == k_ops + 512 + 1088 + 512 + 256 + 2
    assert ntk.kernel_ops(tree, shape) == [
        ("cov_conv_kernel", 1024 + 6 * 256, 4 * 256 + 4 * 2 * 2 * 16),
        ("cov_ntk_conv_kernel", 41 * 256 + 2 * 6 * 256,
         4 * 256 + 8 * 256 + 4 * 2 * 2 * 16),
        ("cov_ntk_pool_kernel", 41 * 256 + 2 * 256,
         8 * 256 + 8 + 4 * 2 * 2 * 16),
        ("cov_ntk_conv_kernel", 4, 8 + 8)]
    w = ntk.gram_work(tree, shape, 5, 2, peaks)
    assert w.entries == 4 + 4 + 2 + 4 + 2 + 1
    walks = w.entries + 5
    want = walks * sum(max(o / peaks.FP32_FLOPS, b / peaks.HBM_BYTES_PER_S)
                       for k, o, b in ntk.kernel_ops(tree, shape)
                       if k == "cov_ntk_conv_kernel")
    assert dict(w.kernels)["cov_ntk_conv_kernel"] == pytest.approx(want)


def test_tangent_states_of_the_plan():
    """A pool of K before any ReLU keeps to cov_pool_kernel (Theta is K),
    a conv of a conv takes the tangent conv with K as its tangent, a
    ReLU of the moments rides an identity pool with no tangent."""
    tree = ntk.parse({"op": "seq", "layers": [
        {"op": "relu"},
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
         "var_weight": 2.0, "var_bias": 0.0},
        {"op": "pool", "kernel_size": 2},
        {"op": "conv", "kernel_size": 1, "stride": 1, "padding": 0,
         "var_weight": 2.0, "var_bias": 0.0},
        {"op": "pool", "kernel_size": 2}]})
    kinds = [k for k, _, _ in ntk.kernel_ops(tree, (1, 4, 4))]
    assert kinds == ["cov_pool_kernel", "cov_conv_kernel",
                     "cov_pool_kernel", "cov_ntk_conv_kernel",
                     "cov_ntk_pool_kernel"]


def test_the_ntk_recursion_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="unknown op"):
        ntk.parse({"op": "sum", "branches": []})
    with pytest.raises(ValueError, match="no fit"):
        ntk.build_model(ntk.parse(TINY), learnable=True)
    with pytest.raises(ValueError, match="fit hooks"):
        recursions.require_fit(ntk)


@pytest.mark.parametrize("name", ["cov_ntk_conv_roofline.gram",
                                  "cov_ntk_pool_roofline.gram"])
def test_the_tangent_kernel_roofline_readers(name):
    """A tangent kernel's bound seconds over its device seconds in the
    trace; no number without the kernel in the trace (the parent's
    program) or without its count (a recursion that brings none)."""
    kernel = name.split("_roofline")[0] + "_kernel"
    read = harness.reader(name)
    work = full.FullWork(1.0, 0.5, 3, ((kernel, 0.03),
                                       ("cov_conv_kernel", 0.01)))
    traced = [{"wall_s": 0.2, "busy_s": 0.15, "kernels": 10,
               "nccl_s": 0.0,
               "device_ops": [[kernel, 0.06], ["cov_conv_kernel", 0.1]]}]
    ctx = {"kind": "gram", "chips": 1, "calls": 1, "window_s": 1.0,
           "work_per_call": work, "units_per_call": 3, "tiles_per_call": 1,
           "traced": traced, "peaks": peaks}
    assert read(ctx) == pytest.approx(50.0)
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
    tree = ntk.parse(TINY)
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


def test_one_conv_theta_is_its_k():
    """A single conv (no ReLU, a valid readout over the map): Theta' =
    box(0) + K' = K', the full recursion's NNGP."""
    from benchmark.reference import fullcov
    tree = ntk.parse({"op": "seq", "layers": [
        {"op": "conv", "kernel_size": 4, "stride": 1, "padding": 0,
         "var_weight": 1.3, "var_bias": 0.2}]})
    x = _images(3, 4, 4)
    idx = torch.arange(3)
    assert torch.equal(ref.entries(tree, x, idx, idx),
                       fullcov.entries(tree, x, idx, idx))

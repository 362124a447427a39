"""The full-covariance recursion (``ops/fullcov.py``): a model with an
``AvgPool2d`` through ``kernel_fn``, ``gram_device``, ``compute_gram`` and
``compute_gram_diag`` against the benchmark's plain float64 reference
(``benchmark/reference/fullcov.py``, which imports nothing of the
port), the chunking, the pre-pass, the refusals, the plan of launches,
and a Monte-Carlo check of the equations with finite random networks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.recursions import full
from benchmark.reference import nngp
from benchmark import arch
from cnn_gp_tpu_torch import (AvgPool2d, Conv2d, FullKernelPatch, ReLU,
                              Sequential, Sum, kernel_fn)
from cnn_gp_tpu_torch import fit_lib
from cnn_gp_tpu_torch.configs import load
from cnn_gp_tpu_torch.kernels import apply_kernel, apply_kernel_reference
from cnn_gp_tpu_torch.ops import fullcov, megakernel
from cnn_gp_tpu_torch.parallel import gram as tgram
from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
from cnn_gp_tpu_torch.parallel.gram import (compute_gram, compute_gram_diag,
                                            gram_in_memory, tile_spec)
from cnn_gp_tpu_torch.utils import timing

# the float32 port against the float64 reference, as a share of max|K|:
# measured 1.3e-7 at 32x32 and below 1e-7 at 8x8 and 16x16; the poly
# arccos alone differs from float64's by ~1e-7
TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def myrtle_nodes(w: int, seed: int, depth: int = 2):
    """A Myrtle-shaped description at w x w (w a power of two): stages of
    ``depth`` x [conv 3x3, relu] and a 2x2 pool, down to 1x1, then a 1x1
    readout; var_weight and var_bias drawn from the seed."""
    rng = np.random.default_rng(seed)

    def conv(k=3, padding="same"):
        return {"op": "conv", "kernel_size": k, "stride": 1,
                "padding": padding,
                "var_weight": float(rng.uniform(1.5, 2.5)),
                "var_bias": float(rng.uniform(0.0, 0.2))}
    layers, s = [], w
    while s > 1:
        for _ in range(depth):
            layers += [conv(), {"op": "relu"}]
        layers.append({"op": "pool", "kernel_size": 2})
        s //= 2
    layers.append(conv(1, 0))
    return {"op": "seq", "layers": layers}


def _model(w, seed, depth=2):
    tree = full.parse(myrtle_nodes(w, seed, depth))
    return tree, full.build_model(tree)


def _x(n, w, seed, c=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, c, w, w), generator=g)


def _ref(tree, images, rows, cols):
    return full.entries(tree, images, torch.as_tensor(rows),
                        torch.as_tensor(cols))


def _err(got, want):
    got = torch.as_tensor(got).double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("w,n,b,seed", [(8, 11, 4, 1), (8, 9, 9, 2),
                                         (16, 7, 3, 3)])
def test_symmetric_gram_against_the_reference(w, n, b, seed):
    """gram_device K(x, x) with ragged edge tiles, exactly symmetric,
    within TOL of the float64 reference (masked diagonal included)."""
    tree, model = _model(w, seed)
    x = _x(n, w, seed)
    k = gram_device(model, x, batch_size=b, device="cpu")
    assert torch.equal(k, k.T)
    idx = np.arange(n)
    assert _err(k, _ref(tree, x, idx, idx)) < TOL


@pytest.mark.parametrize("w,seed", [(8, 4), (16, 5)])
def test_cross_gram_against_the_reference(w, seed):
    """K(z, x) through gram_device and compute_gram (host arrays)."""
    tree, model = _model(w, seed)
    x, z = _x(7, w, seed), _x(5, w, seed + 100)
    both = torch.cat([z, x])
    want = _ref(tree, both, np.arange(5), np.arange(5, 12))
    k = gram_device(model, z, x, batch_size=3, device="cpu")
    assert _err(k, want) < TOL
    out = compute_gram(model, z.numpy(), x.numpy(), device="cpu",
                       batch_size=3, progress=False)
    assert np.array_equal(out, k.numpy())


@pytest.mark.parametrize("w,seed", [(8, 6), (16, 7)])
def test_diagonal_calls_against_the_reference(w, seed):
    """kernel_fn(diag=True) of one set and of two, compute_gram_diag with
    and without Z."""
    tree, model = _model(w, seed)
    x, z = _x(6, w, seed), _x(6, w, seed + 1)
    k_same = _ref(tree, x, np.arange(6), np.arange(6)).diagonal()
    assert _err(kernel_fn(model, x, diag=True), k_same) < TOL
    assert _err(compute_gram_diag(model, x.numpy(), device="cpu",
                                  batch_size=4, progress=False),
                k_same) < TOL
    both = torch.cat([x, z])
    k_xz = _ref(tree, both, np.arange(6), np.arange(6, 12)).diagonal()
    assert _err(kernel_fn(model, x, z, diag=True), k_xz) < TOL
    assert _err(compute_gram_diag(model, x.numpy(), z.numpy(), device="cpu",
                                  batch_size=4, progress=False), k_xz) < TOL


def test_kernel_fn_and_the_layer_walk():
    """kernel_fn (the chunked route) bit for bit apply_kernel_reference
    (a FullKernelPatch layer by layer), symmetric and cross."""
    _, model = _model(8, 8)
    x, y = _x(5, 8, 8), _x(4, 8, 9)
    assert torch.equal(kernel_fn(model, x, y),
                       apply_kernel_reference(model, x, y, False, False))
    assert torch.equal(kernel_fn(model, x),
                       apply_kernel_reference(model, x, x, True, False))
    assert torch.equal(kernel_fn(model, x, x[[1, 0, 3, 2, 4]], diag=True),
                       apply_kernel_reference(model, x, x[[1, 0, 3, 2, 4]],
                                              False, True))


@pytest.mark.parametrize("budget", [1, 3 * 4 * 64 * 64 * 2, None])
def test_chunks_of_a_tile_give_the_same_bits(budget):
    """A tile split into chunks (one row each, a few rows, or the whole
    tile in one) gives the same bits as the whole tile."""
    _, model = _model(8, 10)
    spec = fullcov.match(model)
    x, z = _x(6, 8, 10), _x(5, 8, 11)
    mx, mz = fullcov.self_maps(spec, x), fullcov.self_maps(spec, z)
    whole = fullcov.pair_tile(spec, x, z, mx, mz, budget=1 << 40)
    assert torch.equal(fullcov.pair_tile(spec, x, z, mx, mz, budget=budget),
                       whole)
    assert torch.equal(fullcov.self_maps(spec, x, budget=budget).readout,
                       mx.readout)


def test_the_masked_diagonal_is_the_pre_pass_readout():
    """Entries whose row and column are the same image are each image's
    own covariance readout, the pre-pass's, bit for bit: in gram_device's
    diagonal tiles, in compute_gram_diag and in kernel_fn(diag=True)."""
    _, model = _model(8, 12)
    x = _x(9, 8, 12)
    readout = fullcov.self_maps(fullcov.match(model), x).readout
    k = gram_device(model, x, batch_size=4, device="cpu")
    assert torch.equal(k.diagonal(), readout)
    assert np.array_equal(compute_gram_diag(model, x.numpy(), device="cpu",
                                            batch_size=4, progress=False),
                          readout.numpy())
    assert torch.equal(kernel_fn(model, x, diag=True), readout)


def test_without_pools_the_full_recursion_is_the_diagonal_one():
    """A model without pools (so no reason for the full covariance),
    walked on the full recursion, reads at p = q what the diagonal
    reference reads: its valid readout sums the diagonal."""
    nodes = {"op": "seq", "layers": [
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
         "var_weight": 2.0, "var_bias": 0.1}, {"op": "relu"},
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
         "var_weight": 1.7, "var_bias": 0.05}, {"op": "relu"},
        {"op": "conv", "kernel_size": 6, "stride": 1, "padding": 0,
         "var_weight": 1.3, "var_bias": 0.2}]}
    tree = arch.parse(nodes)
    spec = fullcov.FullSpec(tuple(
        ("conv", c.kernel_size, *c.pad, c.var_weight, c.var_bias)
        if isinstance(c, arch.Conv) else ("relu",) for c in tree.layers))
    x, y = _x(5, 6, 13), _x(4, 6, 14)
    want = nngp.block(tree, x, y)
    got = fullcov.apply(spec, x.double(), y.double(), False, False)
    assert _err(got, want) < 1e-6          # the poly arccos's error
    got32 = fullcov.apply(spec, x, y, False, False)
    assert _err(got32, want) < TOL


def _finite(nodes, x, width, gen):
    """One draw of a finite network of ``nodes`` (conv weights N(0,
    var_weight / (k^2 C_in)), biases N(0, var_bias), plain F.conv2d /
    relu / avg_pool2d) at ``width`` channels, its readout ``width``
    outputs: the draw's empirical kernel mean_k f_k(x) f_k(x')."""
    a = x.double()
    for node in nodes["layers"]:
        if node["op"] == "conv":
            k, c_in = node["kernel_size"], a.shape[1]
            std = (node["var_weight"] / (k * k * c_in)) ** 0.5
            wgt = torch.randn((width, c_in, k, k), generator=gen,
                              dtype=torch.float64) * std
            bias = torch.randn((width,), generator=gen,
                               dtype=torch.float64) * node["var_bias"] ** 0.5
            pad = k // 2 if node["padding"] == "same" else node["padding"]
            a = F.conv2d(a, wgt, bias, padding=pad)
        elif node["op"] == "relu":
            a = F.relu(a)
        else:
            a = F.avg_pool2d(a, node["kernel_size"])
    f = a.reshape(len(x), width)
    return f @ f.T / width


def test_monte_carlo_finite_networks_converge_to_the_reference():
    """The equations themselves: D = 8 draws of width-512 random networks
    of the same description at 8 x 8.  Each draw's empirical kernel is
    an average over 512 readout units, so it scatters around the NNGP
    by ~1/sqrt(512) ~ 4% (more through the layers' own finite width);
    its mean over D draws has the standard error se = std / sqrt(D)
    estimated from the draws.  The finite width also biases the mean by
    O(1 / width) per layer: about 5 layers / 512 ~ 1% of the kernel.  So
    every entry must lie within 4 se + 2% of max|K| of the reference,
    while a wrong equation (the pool's 1/k^4 as 1/k^2, a conv's scale
    without its 1/k^2, a ReLU without its 1/(2 pi)) moves the kernel by
    a factor of 2 or more."""
    nodes = myrtle_nodes(8, seed=20, depth=1)
    tree = full.parse(nodes)
    x = _x(4, 8, 21)
    gen = torch.Generator().manual_seed(22)
    draws = torch.stack([_finite(nodes, x, 512, gen) for _ in range(8)])
    mean, se = draws.mean(0), draws.std(0) / 8 ** 0.5
    want = _ref(tree, x, np.arange(4), np.arange(4))
    scale = float(want.abs().max())
    assert ((mean - want).abs() <= 4 * se + 0.02 * scale).all(), (
        (mean - want).abs().max() / scale, float(se.max() / scale))
    port = kernel_fn(full.build_model(tree), x).double()
    assert ((mean - port).abs() <= 4 * se + 0.02 * scale).all()


def test_myrtle10_config_plan_and_match():
    """The port config: the megakernel refuses it, the Gram's tile_spec
    is the full one, and its plan is 15 launches (9 convs, 6 pools; the
    moments in the first conv, each ReLU in the prologue of its reader)."""
    model = load("cifar10_myrtle10").initial_model
    assert megakernel.match(model) is None
    spec = tile_spec(model)
    assert isinstance(spec, fullcov.FullSpec)
    ops = fullcov.plan(spec, 32, 32)
    assert [op.kind for op in ops] == (["conv"] * 3 + ["pool"]) * 3 + [
        "pool", "pool", "conv"]
    assert [op.prologue for op in ops] == [
        fullcov.MOMENTS, fullcov.RELU, fullcov.RELU, fullcov.RELU,
        fullcov.NONE, fullcov.RELU, fullcov.RELU, fullcov.RELU,
        fullcov.NONE, fullcov.RELU, fullcov.RELU, fullcov.RELU,
        fullcov.NONE, fullcov.NONE, fullcov.NONE]
    assert [op.relu for op in ops if op.prologue == fullcov.RELU] == list(
        range(9))
    assert [(op.w, op.wo) for op in ops if op.kind == "pool"] == [
        (32, 16), (16, 8), (8, 4), (4, 2), (2, 1)]
    assert ops[-1].scale == 2.0 and ops[0].scale == pytest.approx(2 / 9)


def test_diagonal_models_take_their_own_specs():
    """A model without a pool keeps its spec: the paper ConvNet the
    megakernel's, a ResNet none (apply_kernel per tile)."""
    convnet = load("mnist_paper_convnet_gp").initial_model
    assert tile_spec(convnet) == megakernel.match(convnet)
    assert fullcov.match(load("mnist_as_tf_mini").initial_model) is None
    assert tile_spec(load("mnist_as_tf_mini").initial_model) is None


def test_plan_fuses_relus_and_carries_the_rest():
    """A ReLU read by a pool or a conv rides in its prologue; a ReLU of
    a ReLU, of the moments, or one that ends the model, on an identity
    pool."""
    spec = fullcov.match(Sequential(ReLU(), ReLU(), AvgPool2d(2),
                                    Conv2d(3), ReLU()))
    ops = fullcov.plan(spec, 2, 2)
    assert [(op.kind, op.k, op.prologue, op.relu) for op in ops] == [
        ("pool", 1, fullcov.MOMENTS, -1), ("pool", 1, fullcov.RELU, 0),
        ("pool", 2, fullcov.RELU, 1), ("conv", 3, fullcov.NONE, -1),
        ("pool", 1, fullcov.RELU, 2)]
    with pytest.raises(ValueError, match="1x1"):
        fullcov.plan(spec, 4, 4)


def test_refusals():
    """A pool on a diagonal patch, a pooled model with a Sum, a strided
    conv, a pool stride other than its size, and the tiled fit."""
    from cnn_gp_tpu_torch import KernelPatch
    kp = KernelPatch(torch.zeros(1, 1, 4, 4), torch.ones(1, 4, 4),
                     torch.ones(1, 4, 4))
    with pytest.raises(ValueError, match="full covariance"):
        AvgPool2d(2).propagate(kp)
    with pytest.raises(ValueError, match="Sequential of Conv2d"):
        fullcov.match(Sequential(Sum([Conv2d(3), Conv2d(1)]), AvgPool2d(2)))
    with pytest.raises(ValueError, match="stride 1"):
        fullcov.match(Sequential(Conv2d(3, stride=2), AvgPool2d(2)))
    with pytest.raises(ValueError, match="stride"):
        AvgPool2d(2, stride=1)
    _, model = _model(4, 30)
    x, y = _x(6, 4, 30).numpy(), np.eye(2, dtype=np.float32)[
        np.arange(6) % 2]
    with pytest.raises(NotImplementedError, match="no adjoints"):
        fit_lib.fit_large(model, x, y, steps=1, device="cpu")
    with pytest.raises(NotImplementedError, match="no adjoints"):
        fit_lib.nmll_value_and_grad_tiled(model, x, y, device="cpu")


def test_full_kernel_patch_fields():
    """input_patch's full form: each pair's moments over every pair of
    positions and each image's own, whose diagonal is the diagonal
    form's variance."""
    from cnn_gp_tpu_torch.kernels import input_patch
    x, y = _x(3, 4, 31), _x(2, 4, 32)
    kp = input_patch(x, y, False, False, full=True)
    assert isinstance(kp, FullKernelPatch)
    assert kp.xy.shape == (3, 2, 4, 4, 4, 4) and kp.xx.shape == (3, 4, 4, 4,
                                                                 4)
    diag = input_patch(x, y, False, False)
    assert torch.allclose(FullKernelPatch.variances(kp.xx), diag.xx)
    assert torch.allclose(kp.xy[:, :, 1, 2, 1, 2], diag.xy[:, :, 1, 2])


class _Counted:
    """The CUDA route forced on CPU tensors: each launch counted by kind
    and run as the plain op."""

    def __init__(self, monkeypatch):
        self.kinds = []
        monkeypatch.setattr(fullcov, "_on_card", lambda x: True)
        monkeypatch.setattr(fullcov, "build", lambda: 0.0)

        def launch(op, src, x, y, vx, vy, zip_, a, b, walk=None):
            self.kinds.append(op.kind)
            fullcov._count(op, fullcov._takes_walk(op, x.shape[1])
                           if walk is None else walk)
            return fullcov._op_reference(op, src, x, y, vx, vy, zip_)
        monkeypatch.setattr(fullcov, "_launch", launch)


def test_launches_per_tile_and_set(monkeypatch):
    """Each chunk of a tile launches the plan once; the pre-pass once per
    image set and chunk of images; gram.call's span reads the counters'
    change; and a model with a conv the kernel does not take (a valid
    readout over the map) refuses before any launch."""
    counted = _Counted(monkeypatch)
    _, model = _model(4, 40)
    x = _x(5, 4, 40)
    with timing.recording() as found:
        k = gram_device(model, x, batch_size=3, device="cpu")
    plan = fullcov.plan(fullcov.match(model), 4, 4)
    # 3 tiles of the upper triangle + the set's pre-pass, one chunk each
    assert len(counted.kinds) == 4 * len(plan)
    call = next(s for s in found if s.name == "gram.call")
    assert call.attrs["fullcov.conv_launches"] == 4 * sum(
        op.kind == "conv" for op in plan)
    assert call.attrs["fullcov.pool_launches"] == 4 * sum(
        op.kind == "pool" for op in plan)
    # 4x4 maps: no conv takes the warp walk
    assert call.attrs["fullcov.conv_walk_launches"] == 0
    prepass = next(s for s in found if s.name == "gram.prepass")
    assert prepass.attrs["sets"] == 1 and prepass.attrs["images"] == 5
    assert prepass.attrs["maps"] == "4x4/4x4/2x2/2x2"
    # two (rsqrt, sqrt) factors a position of each ReLU's map, the readout
    assert prepass.attrs["bytes"] == 4 * (5 * 2 * (16 * 2 + 4 * 2) + 5)
    assert torch.equal(k, gram_device(model, x, batch_size=3, device="cpu"))
    counted.kinds.clear()
    valid = Sequential(Conv2d(3, var_weight=2.0), ReLU(), AvgPool2d(2),
                       Conv2d(2, padding=0))
    with pytest.raises(NotImplementedError,
                       match="2x2 conv with padding 0 on 2x2 maps"):
        kernel_fn(valid, _x(2, 4, 41))
    assert counted.kinds == []


def test_myrtle10_convs_take_the_warp_walk(monkeypatch):
    """On the card (the CUDA route forced on CPU tensors) a Myrtle-10 Gram
    call counts every 3x3 conv at 32x32, 16x16 and 8x8 on the warp walk
    (9 of each walk's 10 convs: all but the dense 1x1 readout), and its
    gram.call span carries the count; a 5x5 conv on 32x32 maps, one on
    16x32 maps and moments of other than 3 channels take the slab walk."""
    _Counted(monkeypatch)
    model = load("cifar10_myrtle10").initial_model
    x = _x(3, 32, 45)
    before = (fullcov.conv_launches, fullcov.conv_walk_launches)
    with timing.recording() as found:
        gram_device(model, x, batch_size=2, device="cpu")
    # tiles (0, 0), (0, 2), (2, 2) and the set's pre-pass, one chunk each
    call = next(s for s in found if s.name == "gram.call")
    assert call.attrs["fullcov.conv_launches"] == 4 * 10
    assert call.attrs["fullcov.conv_walk_launches"] == 4 * 9
    assert (fullcov.conv_launches - before[0],
            fullcov.conv_walk_launches - before[1]) == (40, 36)
    op = fullcov.Op("conv", 5, 2, 2.0 / 25, 0.0, fullcov.RELU, 0, 32, 32,
                    32, 32)
    assert not fullcov._takes_walk(op, 3)
    assert fullcov._takes_walk(op._replace(k=3, lo=1), 3)
    assert not fullcov._takes_walk(op._replace(k=3, lo=1, h=16, ho=16), 3)
    # the moments of a channel count but 3 take the slab walk
    moments = op._replace(k=3, lo=1, prologue=fullcov.MOMENTS, relu=-1)
    assert fullcov._takes_walk(moments, 3)
    assert not fullcov._takes_walk(moments, 1)
    assert fullcov._takes_walk(op._replace(k=3, lo=1), 1)


def test_myrtle10_pools_take_the_pool_walk():
    """The pool walk's chooser on the cifar10_myrtle10 plan: its 2x2 pools
    on 32x32, 16x16 and 8x8 maps (behind a ReLU) take the pool walk,
    those on 4x4 and 2x2 (no prologue) one thread an output; a pool of
    another k, on odd, non-square or smaller maps, the identity pool and
    the moments prologue never take it, nor does a conv of a pool's
    geometry."""
    model = load("cifar10_myrtle10").initial_model
    pools = [op for op in fullcov.plan(fullcov.match(model), 32, 32)
             if op.kind == "pool"]
    assert [(op.h, op.prologue, fullcov._takes_walk(op, 3))
            for op in pools] == [
        (32, fullcov.RELU, True), (16, fullcov.RELU, True),
        (8, fullcov.RELU, True), (4, fullcov.NONE, False),
        (2, fullcov.NONE, False)]
    assert fullcov.POOL_WALK_MAPS == (32, 16, 8)
    op = pools[0]
    assert fullcov._takes_walk(op._replace(prologue=fullcov.NONE, relu=-1),
                               1)
    for other in (op._replace(k=3, wo=10, ho=10),
                  op._replace(k=4, wo=8, ho=8),
                  op._replace(w=31, h=31, wo=15, ho=15),
                  op._replace(h=16, ho=8),
                  op._replace(w=16, wo=8),
                  op._replace(k=1, scale=1.0, wo=32, ho=32),
                  op._replace(prologue=fullcov.MOMENTS, relu=-1),
                  op._replace(kind="conv")):
        assert not fullcov._takes_walk(other, 3), other


def test_pool_walk_launches_on_a_gram_call(monkeypatch):
    """On the card (the CUDA route forced on CPU tensors) a Gram call of a
    model pooled 16 -> 8 -> 4 -> 2 -> 1 counts its pools on 16x16 and
    8x8 maps (behind a ReLU) on the pool walk and the others not, per
    tile and pre-pass, and its gram.call span carries the count."""
    _Counted(monkeypatch)
    model = Sequential(Conv2d(3, var_weight=2.0), ReLU(), AvgPool2d(2),
                       Conv2d(3, var_weight=2.0), ReLU(), AvgPool2d(2),
                       AvgPool2d(2), AvgPool2d(2), Conv2d(1))
    before = (fullcov.pool_launches, fullcov.pool_walk_launches)
    with timing.recording() as found:
        gram_device(model, _x(3, 16, 46), batch_size=2, device="cpu")
    # tiles (0, 0), (0, 2), (2, 2) and the set's pre-pass, one chunk each
    call = next(s for s in found if s.name == "gram.call")
    assert call.attrs["fullcov.pool_launches"] == 4 * 4
    assert call.attrs["fullcov.pool_walk_launches"] == 4 * 2
    assert (fullcov.pool_launches - before[0],
            fullcov.pool_walk_launches - before[1]) == (16, 8)
    assert call.attrs["fullcov.conv_walk_launches"] == 4 * 2


# pooled models with a conv the kernel does not take, the map side, and
# the refused conv as the error names it
_UNTAKEN = {
    "valid": (lambda: Sequential(Conv2d(3, padding=0), ReLU(),
                                 AvgPool2d(2)), 4,
              "3x3 conv with padding 0 on 4x4 maps"),
    "even": (lambda: Sequential(Conv2d(2), ReLU(), AvgPool2d(4)), 4,
             "2x2 conv with padding 0 on 4x4 maps"),
    "wide": (lambda: Sequential(Conv2d(9), ReLU(), AvgPool2d(4)), 4,
             "9x9 conv with padding 4 on 4x4 maps"),
    "tall": (lambda: Sequential(Conv2d(3), ReLU(), AvgPool2d(64)), 64,
             "3x3 conv with padding 1 on 64x64 maps"),
}


@pytest.mark.parametrize("case", sorted(_UNTAKEN))
def test_card_refuses_what_the_kernels_do_not_take(monkeypatch, case):
    """On the card (the CUDA route forced on CPU tensors) a pooled model
    with a conv the kernel does not take (valid padding, an even or
    wider than 7 kernel, maps past 32 along H) raises
    NotImplementedError naming that conv, through kernel_fn, gram_device
    and compute_gram_diag, before any launch."""
    make, w, named = _UNTAKEN[case]
    counted = _Counted(monkeypatch)
    x = _x(3, w, 42)
    for call in (lambda: kernel_fn(make(), x),
                 lambda: kernel_fn(make(), x, diag=True),
                 lambda: gram_device(make(), x, batch_size=2, device="cpu"),
                 lambda: compute_gram_diag(make(), x.numpy(), device="cpu",
                                           batch_size=2, progress=False)):
        with pytest.raises(NotImplementedError, match=named):
            call()
    assert counted.kinds == []


def test_untaken_conv_runs_plain_on_cpu_tensors():
    """Off the card the same valid-padding model runs its plain version,
    within TOL of the float64 reference."""
    tree = full.parse({"op": "seq", "layers": [
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": 0,
         "var_weight": 2.0, "var_bias": 0.1}, {"op": "relu"},
        {"op": "pool", "kernel_size": 2}]})
    model = full.build_model(tree)
    x = _x(4, 4, 43)
    idx = np.arange(4)
    assert _err(kernel_fn(model, x), _ref(tree, x, idx, idx)) < TOL


def test_gram_in_memory_and_sharded_entry():
    """The host-array Gram and the sharded entry (no group) take the full
    spec and agree with gram_device bit for bit on the upper triangle
    (they keep a diagonal tile's lower triangle as computed, where
    gram_device mirrors its upper one), and to rounding below it."""
    from cnn_gp_tpu_torch.parallel.gram_sharded import compute_gram_sharded
    from cnn_gp_tpu_torch.parallel.mesh import make_mesh
    _, model = _model(8, 50)
    x = _x(7, 8, 50)
    want = gram_device(model, x, batch_size=3, device="cpu").numpy()
    for got in (gram_in_memory(model, x.numpy(), device="cpu", batch_size=3,
                               progress=False),
                compute_gram_sharded(model, x.numpy(), batch_size=3,
                                     mesh=make_mesh(device="cpu"),
                                     progress=False)):
        assert np.array_equal(np.triu(got), np.triu(want))
        assert np.allclose(got, want, rtol=1e-6, atol=0)


def test_apply_kernel_on_the_main_route_equals_the_tile_body():
    """apply_kernel (one pre-pass per call) and _tile_body on a set's
    maps give the same tile."""
    _, model = _model(8, 60)
    x = _x(6, 8, 60)
    spec = tile_spec(model)
    maps = tgram.set_maps(spec, x, x)
    mask = torch.eye(6, dtype=torch.bool)[:4, 2:]
    got = tgram._tile_body(model, spec, x, x, 0, 2, 4, True, maps)
    want = apply_kernel(model, x[:4], x[2:6], False, False, mask)
    assert got.shape == (4, 4) and torch.allclose(got, want, rtol=1e-6)

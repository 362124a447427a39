"""The neural tangent kernel on the full-covariance path (``kernels.NTK``,
``ops/fullcov.py``'s tangent ops): small CNNs through ``kernel_fn``,
``apply_kernel``, ``gram_device``, ``compute_gram`` and
``compute_gram_diag`` against the benchmark's plain float64 reference
(``benchmark/reference/ntk.py``, which imports nothing of the port); each
tangent op's plain version against the reference's step; the diagonal;
a model without a ReLU in closed form; the refusals; and the equations
against the empirical NTK of finite networks.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import arch
from benchmark.recursions import ntk as rec
from benchmark.reference import fullcov as ref_full
from benchmark.reference import ntk as ref
from cnn_gp_tpu_torch import (NTK, AvgPool2d, Conv2d, FullKernelPatch, ReLU,
                              Sequential, kernel_fn)
from cnn_gp_tpu_torch import fit_lib
from cnn_gp_tpu_torch.configs import load
from cnn_gp_tpu_torch.kernels import (apply_kernel, apply_kernel_reference,
                                      input_patch)
from cnn_gp_tpu_torch.ops import fullcov, megakernel
from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
from cnn_gp_tpu_torch.parallel.gram import (compute_gram, compute_gram_diag,
                                            tile_spec)
from cnn_gp_tpu_torch.utils import timing

# the float32 port against the float64 reference, as a share of max|K|:
# measured below 2e-7 on these nets (the poly arccos alone differs from
# float64's by ~1e-7 a ReLU, and K-dot carries its rounding into Theta);
# ten times the full covariance's NNGP TOL would hide a missing term, so
# the same TOL
TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ntk_nodes(w: int, depth: int, pool: str, seed: int):
    """A description at w x w: ``depth`` x [conv 3x3, relu], then a global
    average (``pool`` "gap") or 2x2 pools down to 1x1 ("2x2"), then a 1x1
    readout; var_weight and var_bias drawn from the seed (biases
    nonzero)."""
    rng = np.random.default_rng(seed)

    def conv(k=3, padding="same"):
        return {"op": "conv", "kernel_size": k, "stride": 1,
                "padding": padding,
                "var_weight": float(rng.uniform(1.5, 2.5)),
                "var_bias": float(rng.uniform(0.05, 0.3))}
    layers = []
    for _ in range(depth):
        layers += [conv(), {"op": "relu"}]
    if pool == "gap":
        layers.append({"op": "pool", "kernel_size": w})
    else:
        s = w
        while s > 1:
            layers.append({"op": "pool", "kernel_size": 2})
            s //= 2
    layers.append(conv(1, 0))
    return {"op": "seq", "layers": layers}


def _tree(w, depth, pool, seed):
    return rec.parse(ntk_nodes(w, depth, pool, seed))


def _ntk_model(w, depth, pool, seed):
    return rec.build_model(_tree(w, depth, pool, seed))


def _x(n, w, seed, c=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, c, w, w), generator=g)


def _ref(tree, images, rows, cols):
    return rec.entries(tree, images, torch.as_tensor(rows),
                       torch.as_tensor(cols))


def _err(got, want):
    got = torch.as_tensor(got).double()
    return float((got - want).abs().max() / want.abs().max())


# the float32 port against the float64 reference, as a share of max|K|.
# Theta's ReLU factor (pi - theta) / (2 pi) has the slope 1 / (2 pi sin
# theta) in cos theta, so the float32 rounding of cos theta near 1 (where
# positive images' neighbouring positions sit) reaches Theta magnified:
# measured 1.05e-6 to 2.04e-6 on these 8x8 nets of 2-3 layers (4.2e-6 at
# 6 layers; 2.5e-7 to 3.8e-7 at 16x16), the same with the exact arccos;
# a term left out of the equations moves the kernel by 1e-2 or more
NTK_TOL = 1e-5


@pytest.mark.parametrize("w,depth,pool,n,b,seed", [
    (8, 2, "gap", 7, 3, 1), (8, 3, "2x2", 6, 4, 2), (8, 2, "2x2", 5, 5, 3),
    (16, 2, "gap", 4, 3, 4)])
def test_ntk_gram_against_the_reference(w, depth, pool, n, b, seed):
    """gram_device K(x, x) of an NTK with ragged edge tiles, exactly
    symmetric, within NTK_TOL of the float64 reference (masked diagonal
    included)."""
    tree = _tree(w, depth, pool, seed)
    model = rec.build_model(tree)
    x = _x(n, w, seed)
    k = gram_device(model, x, batch_size=b, device="cpu")
    assert torch.equal(k, k.T)
    idx = np.arange(n)
    assert _err(k, _ref(tree, x, idx, idx)) < NTK_TOL


def test_ntk_cross_gram_and_host_arrays():
    """K(z, x) through gram_device and compute_gram (host arrays, bit for
    bit), against the reference."""
    tree = _tree(8, 2, "gap", 5)
    model = rec.build_model(tree)
    x, z = _x(5, 8, 5), _x(4, 8, 105)
    want = _ref(tree, torch.cat([z, x]), np.arange(4), np.arange(4, 9))
    k = gram_device(model, z, x, batch_size=3, device="cpu")
    assert _err(k, want) < NTK_TOL
    out = compute_gram(model, z.numpy(), x.numpy(), device="cpu",
                       batch_size=3, progress=False)
    assert np.array_equal(out, k.numpy())


def test_ntk_kernel_fn_apply_kernel_and_the_layer_walk():
    """kernel_fn and apply_kernel (the chunked plan) bit for bit
    apply_kernel_reference (a FullKernelPatch with tangent fields, layer
    by layer), symmetric, cross and diagonal, within NTK_TOL of the
    reference."""
    tree = _tree(8, 3, "gap", 6)
    model = rec.build_model(tree)
    x, y = _x(4, 8, 6), _x(3, 8, 7)
    got = kernel_fn(model, x, y)
    assert torch.equal(got, apply_kernel(model, x, y, False, False))
    assert torch.equal(got, apply_kernel_reference(model, x, y, False,
                                                   False))
    assert torch.equal(kernel_fn(model, x),
                       apply_kernel_reference(model, x, x, True, False))
    assert torch.equal(kernel_fn(model, x, x[[1, 0, 3, 2]], diag=True),
                       apply_kernel_reference(model, x, x[[1, 0, 3, 2]],
                                              False, True))
    want = _ref(tree, torch.cat([x, y]), np.arange(4), np.arange(4, 7))
    assert _err(got, want) < NTK_TOL


def test_ntk_diagonal_is_the_pair_walk():
    """Theta(x, x): the pre-pass readout (gram_device's masked diagonal,
    compute_gram_diag, kernel_fn(diag=True)) equals the pair walk of
    each image with itself, unmasked, and the reference's."""
    tree = _tree(8, 2, "2x2", 8)
    model = rec.build_model(tree)
    x = _x(6, 8, 8)
    spec = fullcov.match(model)
    maps = fullcov.self_maps(spec, x)
    walked = fullcov.pair_tile(spec, x, x, maps, maps).diagonal()
    assert torch.allclose(walked, maps.readout, rtol=1e-6, atol=0)
    k = gram_device(model, x, batch_size=4, device="cpu")
    assert torch.equal(k.diagonal(), maps.readout)
    assert np.array_equal(compute_gram_diag(model, x.numpy(), device="cpu",
                                            batch_size=4, progress=False),
                          maps.readout.numpy())
    assert torch.equal(kernel_fn(model, x, diag=True), maps.readout)
    want = _ref(tree, x, np.arange(6), np.arange(6)).diagonal()
    assert _err(maps.readout, want) < NTK_TOL
    # two sets paired: k(x_i, z_i)
    z = _x(6, 8, 9)
    kz = _ref(tree, torch.cat([x, z]), np.arange(6), np.arange(6, 12))
    assert _err(compute_gram_diag(model, x.numpy(), z.numpy(), device="cpu",
                                  batch_size=4, progress=False),
                kz.diagonal()) < NTK_TOL


def _fields(shape, seed, lo=0.25, span=0.5):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float64) * span + lo


@pytest.mark.parametrize("case", ["conv_sigma_relu", "conv_field_relu",
                                  "conv_field_none", "conv_1x1",
                                  "pool_gap_relu", "pool_2x2_none",
                                  "pool_identity_relu"])
def test_each_tangent_op_against_the_reference_step(case):
    """Each tangent op's plain version (float32, ``fullcov._ntk_op_
    reference``) against the reference's step on the same float64 fields
    (its conv, ReLU and pool, ``benchmark/reference/ntk.py``): K' and
    Theta' within 1e-6 of their scale."""
    kind, geometry, prologue = {
        "conv_sigma_relu": ("conv", (3, 8), "relu"),
        "conv_field_relu": ("conv", (3, 8), "relu"),
        "conv_field_none": ("conv", (3, 8), "none"),
        "conv_1x1": ("conv", (1, 4), "relu"),
        "pool_gap_relu": ("pool", (8, 8), "relu"),
        "pool_2x2_none": ("pool", (2, 8), "none"),
        "pool_identity_relu": ("pool", (1, 4), "relu")}[case]
    k, w = geometry
    tangent = fullcov.SIGMA if case == "conv_sigma_relu" else fullcov.FIELD
    a, b = 3, 2
    src = _fields((a, b, w, w, w, w), 1)
    tsrc = None if tangent == fullcov.SIGMA else _fields(src.shape, 2, 0.0,
                                                         1.0)
    # variances past every |K|, so that no cosine is clamped (where it is
    # the program keeps K in the (pi - theta) K term, the reference cos
    # theta times the norm)
    vx, vy = _fields((a, w, w), 3, 1.0), _fields((b, w, w), 4, 1.0)
    if kind == "conv":
        c = arch.Conv(k, 1, (k // 2, k // 2), 1, 2.0, 0.125)
        op = fullcov.Op("conv", k, k // 2, fullcov._f32(2.0) / (k * k),
                        0.125, fullcov.RELU if prologue == "relu"
                        else fullcov.NONE, 0, w, w, w, w, tangent)
    else:
        op = fullcov.Op("pool", k, 0, 1.0 / k ** 4, 0.0,
                        fullcov.RELU if prologue == "relu" else fullcov.NONE,
                        0, w, w, w // k, w // k, tangent)
    got = fullcov._ntk_op_reference(
        op, src.float(), None if tsrc is None else tsrc.float(),
        fullcov.factors(vx.float()), fullcov.factors(vy.float()), False)
    t = src if tsrc is None else tsrc
    if prologue == "relu":
        kr, t = ref._relu(src, t, vx[:, None, :, :, None, None],
                          vy[None, :, None, None], True)
    else:
        kr = src
    if kind == "conv":
        want = ref._conv(kr, t, c, True)
    else:
        want = (ref_full._pool(kr, k), ref_full._pool(t, k))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        assert _err(g, wnt) < 1e-6


def _linear_nodes(biases):
    """Two 3x3 convs, a global average and a dense readout, no ReLU."""
    vws = (1.7, 2.3, 1.9)
    layers = [{"op": "conv", "kernel_size": 3, "stride": 1,
               "padding": "same", "var_weight": vws[0],
               "var_bias": biases[0]},
              {"op": "conv", "kernel_size": 3, "stride": 1,
               "padding": "same", "var_weight": vws[1],
               "var_bias": biases[1]},
              {"op": "pool", "kernel_size": 8},
              {"op": "conv", "kernel_size": 1, "stride": 1, "padding": 0,
               "var_weight": vws[2], "var_bias": biases[2]}]
    return {"op": "seq", "layers": layers}


def test_without_a_relu_theta_is_a_sum_of_nngps():
    """A network without a ReLU is linear in its parameters, so Theta =
    sum over layers l of the NNGP whose biases after l are 0 (each
    layer's weights and bias see the layers after it as a fixed linear
    map); with no bias at all, L times the NNGP.  Both from the port's
    own NNGP of the pooled model (the full covariance without tangent)."""
    from benchmark.recursions import full
    biases = (0.3, 0.2, 0.1)
    x = _x(4, 8, 12)
    model = rec.build_model(rec.parse(_linear_nodes(biases)))
    want = sum(kernel_fn(full.build_model(full.parse(_linear_nodes(
        biases[:l + 1] + (0.0,) * (2 - l)))), x).double() for l in range(3))
    got = kernel_fn(model, x).double()
    # three float32 Grams summed against one: measured 1.8e-6
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5
    plain = full.build_model(full.parse(_linear_nodes((0.0,) * 3)))
    zero = rec.build_model(rec.parse(_linear_nodes((0.0,) * 3)))
    assert torch.allclose(kernel_fn(zero, x), 3 * kernel_fn(plain, x),
                          rtol=1e-5, atol=0)


def test_an_ntk_without_a_pool_takes_the_full_route():
    """An NTK of a model without a pool (a valid readout over the map)
    takes the full-covariance spec (the megakernel refuses it, though it
    takes the NNGP of the same model) and agrees with the reference."""
    nodes = {"op": "seq", "layers": [
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
         "var_weight": 2.1, "var_bias": 0.1}, {"op": "relu"},
        {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
         "var_weight": 1.8, "var_bias": 0.2}, {"op": "relu"},
        {"op": "conv", "kernel_size": 6, "stride": 1, "padding": 0,
         "var_weight": 1.4, "var_bias": 0.05}]}
    tree = rec.parse(nodes)
    model = rec.build_model(tree)
    assert megakernel.match(model.model) is not None
    assert megakernel.match(model) is None
    spec = tile_spec(model)
    assert isinstance(spec, fullcov.FullSpec) and spec.ntk
    assert spec.fields == 2
    x = _x(5, 6, 13)
    k = gram_device(model, x, batch_size=2, device="cpu").double()
    idx = np.arange(5)
    want = _ref(tree, x, idx, idx)
    d = (k - want).abs() / want.abs().max()
    off = ~torch.eye(5, dtype=torch.bool)
    assert float(d[off].max()) < NTK_TOL
    # Theta(x, x) of a readout that sums the diagonal p = q alone: there
    # cos theta is 1 exactly and float32 rounds it to 1 - 2^-24 in some
    # places, where theta = 2^-11.5 = 3.5e-4 and K-dot lies 5.5e-5 below
    # 1/2; measured 4.1e-5 to 5.3e-5 of max|K| (5 seeds; the entries off
    # the diagonal 1.0e-7 to 1.9e-7).  A pool that averages every pair
    # of positions dilutes it: 32 x 32 maps weigh the diagonal 1 / 1,024
    assert float(d.diagonal().max()) < 2e-4
    # not the NNGP of the same model
    assert _err(kernel_fn(model.model, x), _ref(tree, x, idx, idx)) > 1e-2


def test_cntk_gap11_config_plan_and_match():
    """The port config: the megakernel refuses it, the Gram's tile_spec
    is the full one with the tangent, its plan is 12 launches (the first
    conv with the moments and no tangent, nine tangent convs with the
    ReLU, the global average with the ReLU, the dense readout), and a
    32-image tile takes chunks of 16 rows (two 4 MiB fields in, two
    out, under 8 GiB)."""
    model = load("cifar10_cntk_gap11").initial_model
    assert isinstance(model, NTK)
    assert megakernel.match(model) is None
    spec = tile_spec(model)
    assert isinstance(spec, fullcov.FullSpec) and spec.ntk
    ops = fullcov.plan(spec, 32, 32)
    assert [op.kind for op in ops] == ["conv"] * 10 + ["pool", "conv"]
    assert [op.tangent for op in ops] == [0, fullcov.SIGMA] + [
        fullcov.FIELD] * 10
    assert [op.prologue for op in ops] == [fullcov.MOMENTS] + [
        fullcov.RELU] * 10 + [fullcov.NONE]
    assert (ops[-2].k, ops[-2].wo) == (32, 1)
    assert (ops[-1].k, ops[-1].w, ops[-1].scale) == (1, 1, 2.0)
    assert fullcov._chunk_rows(ops, 32, fullcov.CHUNK_BYTES) == 16
    assert model.layers() == 11


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

        def launch_ntk(op, src, tsrc, vx, vy, zip_, a, b):
            self.kinds.append("ntk_" + op.kind)
            fullcov._count(op, False)
            return fullcov._ntk_op_reference(op, src, tsrc, vx, vy, zip_)
        monkeypatch.setattr(fullcov, "_launch", launch)
        monkeypatch.setattr(fullcov, "_launch_ntk", launch_ntk)


def test_tangent_launches_spans_and_prepass(monkeypatch):
    """On the card (the CUDA route forced on CPU tensors) each tile's
    chunk and the set's pre-pass launch the plan once, the tangent ops
    on the tangent kernels; gram.call carries their counters' change and
    gram.prepass the pair's fields (2; 1 for the NNGP)."""
    counted = _Counted(monkeypatch)
    model = _ntk_model(8, 2, "gap", 40)
    x = _x(5, 8, 40)
    with timing.recording() as found:
        k = gram_device(model, x, batch_size=3, device="cpu")
    plan = fullcov.plan(fullcov.match(model), 8, 8)
    walks = 3 + 1
    assert len(counted.kinds) == walks * len(plan)
    call = next(s for s in found if s.name == "gram.call")
    assert call.attrs["fullcov.ntk_conv_launches"] == walks * 2
    assert call.attrs["fullcov.ntk_pool_launches"] == walks
    assert call.attrs["fullcov.conv_launches"] == walks
    assert call.attrs["fullcov.conv_walk_launches"] == walks
    assert call.attrs["fullcov.pool_launches"] == 0
    prepass = next(s for s in found if s.name == "gram.prepass")
    assert prepass.attrs["fields"] == 2 and prepass.attrs["images"] == 5
    assert torch.equal(k, gram_device(model, x, batch_size=3, device="cpu"))
    with timing.recording() as found:
        gram_device(model.model, x, batch_size=3, device="cpu")
    prepass = next(s for s in found if s.name == "gram.prepass")
    assert prepass.attrs["fields"] == 1


_UNTAKEN = {
    "4x4": (lambda: NTK(Sequential(Conv2d(3), ReLU(), Conv2d(3), ReLU(),
                                   AvgPool2d(4))), 4,
            "3x3 conv with padding 1 on 4x4 maps"),
    "5x5": (lambda: NTK(Sequential(Conv2d(3), ReLU(), Conv2d(5), ReLU(),
                                   AvgPool2d(8))), 8,
            "5x5 conv with padding 2 on 8x8 maps"),
    "valid": (lambda: NTK(Sequential(Conv2d(3), ReLU(),
                                     Conv2d(8, padding=0))), 8,
              "8x8 conv with padding 0 on 8x8 maps"),
}


@pytest.mark.parametrize("case", sorted(_UNTAKEN))
def test_card_refuses_tangent_ops_the_kernels_do_not_take(monkeypatch,
                                                          case):
    """On the card an NTK op the tangent kernels do not take raises
    NotImplementedError naming it, through kernel_fn, gram_device and
    compute_gram_diag, before any launch; the plain version runs it on
    CPU tensors."""
    make, w, named = _UNTAKEN[case]
    x = _x(3, w, 42)
    assert torch.isfinite(kernel_fn(make(), x)).all()
    counted = _Counted(monkeypatch)
    for call in (lambda: kernel_fn(make(), x),
                 lambda: kernel_fn(make(), x, diag=True),
                 lambda: gram_device(make(), x, batch_size=2, device="cpu"),
                 lambda: compute_gram_diag(make(), x.numpy(), device="cpu",
                                           batch_size=2, progress=False)):
        with pytest.raises(NotImplementedError, match=named):
            call()
    assert counted.kinds == []


def test_refusals():
    """The tiled fit refuses an NTK (with or without a pool), an NTK
    inside a model refuses, and so does an NTK of a diagonal patch."""
    from cnn_gp_tpu_torch import KernelPatch
    x = _x(6, 8, 30).numpy()
    y = np.eye(2, dtype=np.float32)[np.arange(6) % 2]
    for model in (_ntk_model(8, 1, "gap", 30),
                  NTK(Sequential(Conv2d(3), ReLU(), Conv2d(8, padding=0)))):
        with pytest.raises(NotImplementedError, match="NTK.*no adjoints"):
            fit_lib.fit_large(model, x, y, steps=1, device="cpu")
        with pytest.raises(NotImplementedError, match="NTK.*no adjoints"):
            fit_lib.nmll_value_and_grad_tiled(model, x, y, device="cpu")
    nested = Sequential(NTK(Sequential(Conv2d(3), ReLU())), AvgPool2d(8))
    with pytest.raises(ValueError, match="NTK wraps a whole model"):
        fullcov.match(nested)
    with pytest.raises(ValueError, match="NTK wraps a whole model"):
        kernel_fn(nested, torch.as_tensor(x))
    kp = KernelPatch(torch.zeros(1, 1, 4, 4), torch.ones(1, 4, 4),
                     torch.ones(1, 4, 4))
    with pytest.raises(ValueError, match="full covariance"):
        NTK(Sequential(Conv2d(3))).propagate(kp)


def test_tangent_patch_fields():
    """An NTK's input patch starts its tangent at 0 (yy's aliasing xx's
    kept), and its output is the tangent as the kernel."""
    x = _x(3, 4, 31)
    kp = input_patch(x, x, True, False, full=True)
    t = kp.with_tangent()
    assert t.txy.shape == kp.xy.shape and not t.txy.any()
    assert t.tyy is t.txx
    assert t.with_tangent() is t
    out = t.tangent_patch()
    assert isinstance(out, FullKernelPatch) and out.xy is t.txy
    assert out.txy is None


FINITE_NODES = {"op": "seq", "layers": [
    {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
     "var_weight": 2.0, "var_bias": 0.1}, {"op": "relu"},
    {"op": "conv", "kernel_size": 3, "stride": 1, "padding": "same",
     "var_weight": 1.6, "var_bias": 0.2}, {"op": "relu"},
    {"op": "pool", "kernel_size": 6},
    {"op": "conv", "kernel_size": 1, "stride": 1, "padding": 0,
     "var_weight": 1.5, "var_bias": 0.1}]}


def _empirical_ntk(nodes, x, width, outs, gen):
    """One draw of a finite CNN of ``nodes`` in the NTK parameterization
    (every weight and bias N(0, 1), a conv's weights scaled by sqrt(
    var_weight / (k^2 C_in)) and its bias by sqrt(var_bias); plain
    F.conv2d / relu / avg_pool2d; ``width`` channels, ``outs`` outputs),
    and its empirical NTK: the parameter gradients' inner products of
    each output, averaged over the outputs."""
    convs = [n for n in nodes["layers"] if n["op"] == "conv"]
    params, c_in = [], x.shape[1]
    for i, n in enumerate(convs):
        k = n["kernel_size"]
        c_out = outs if i == len(convs) - 1 else width
        params.append(torch.randn((c_out, c_in, k, k), generator=gen,
                                  dtype=torch.float64).requires_grad_())
        params.append(torch.randn((c_out,), generator=gen,
                                  dtype=torch.float64).requires_grad_())
        c_in = c_out
    a, i = x.double(), 0
    for n in nodes["layers"]:
        if n["op"] == "conv":
            wgt, bias = params[2 * i], params[2 * i + 1]
            k = n["kernel_size"]
            std = math.sqrt(n["var_weight"] / (k * k * wgt.shape[1]))
            a = F.conv2d(a, wgt * std, bias * math.sqrt(n["var_bias"]),
                         padding=k // 2 if n["padding"] == "same" else 0)
            i += 1
        elif n["op"] == "relu":
            a = F.relu(a)
        else:
            a = F.avg_pool2d(a, n["kernel_size"])
    out = a.reshape(len(x), outs)
    jac = torch.stack([
        torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            out[r, o], params, retain_graph=True)])
        for r in range(len(x)) for o in range(outs)]).reshape(
            len(x), outs, -1)
    return torch.einsum("iop,jop->ij", jac, jac) / outs


def test_the_equations_against_finite_networks(monkeypatch):
    """The tangent equations themselves, independent of how the program
    and the reference were written: the empirical NTK of 8 seeded finite
    CNNs (6x6x3 inputs, two 3x3 convs of width 256, a global average, a
    dense readout of 4 outputs, NTK parameterization, float64 autograd)
    averaged, against the reference's analytic Theta.  The empirical NTK
    of one net scatters around its limit by O(1 / sqrt(width)); the mean
    of D draws has the standard error se = std / sqrt(D) from the draws
    (measured ~3.8% of max|K|), and the finite width biases it by O(depth
    / width), ~1%.  So every entry must lie within 4 se + 3% of max|K|
    (measured 1.1%), while the recursion with the conv's + K' left out
    reads 87% off and with the ReLU's K-dot left out 122% off: both fail.
    The port's kernel agrees within the same bound."""
    tree = rec.parse(FINITE_NODES)
    x = _x(4, 6, 5)
    gen = torch.Generator().manual_seed(6)
    draws = torch.stack([_empirical_ntk(FINITE_NODES, x, 256, 4, gen)
                         for _ in range(8)])
    mean, se = draws.mean(0), draws.std(0) / 8 ** 0.5
    idx = np.arange(4)
    want = _ref(tree, x, idx, idx)
    scale = float(want.abs().max())
    bound = 4 * se + 0.03 * scale

    def within(theta):
        return bool(((mean - theta).abs() <= bound).all())
    assert within(want), (float((mean - want).abs().max() / scale),
                          float(se.max() / scale))
    assert within(kernel_fn(rec.build_model(tree), x).double())
    conv, relu = ref._conv, ref._relu

    def no_k(k, t, c, live):         # Theta' without the + K' term
        k2 = ref_full._conv(k, c)
        return k2, (ref_full._conv(t, arch.Conv(
            c.kernel_size, c.stride, c.pad, c.dilation, c.var_weight, 0.0))
            if live else k2)
    monkeypatch.setattr(ref, "_conv", no_k)
    assert not within(_ref(tree, x, idx, idx))
    monkeypatch.setattr(ref, "_conv", conv)
    monkeypatch.setattr(ref, "_relu", lambda k, t, vx, vy, live: relu(
        k, t, vx, vy, False))       # Theta passed through, no K-dot
    assert not within(_ref(tree, x, idx, idx))

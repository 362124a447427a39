"""The fused ResNet layer on the CPU (``ops/layer.py``, the fused walk of
``kernels.apply_kernel``): ``conv_layer_reference`` bit for bit against
the unfused plain chain and against the JAX package's ``relu_transform``,
``box_filter_2d``, scale, bias and ``Sum`` add; the fused walk bit for
bit against ``apply_kernel_reference`` and against JAX's
``apply_kernel``; the CUDA route with its launch stubbed (launch counts
per config, the autograd Function's gradients); the fused launch's
wrapper with a stubbed ``_lib``; both packages' refusal of an unknown
``conv_method`` / ``relu_method``.  The kernel itself is checked on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cnn_gp_tpu
import cnn_gp_tpu_torch as T
import configs as jconfigs
from cnn_gp_tpu.ops import arccos as jarc
from cnn_gp_tpu.ops import boxfilter as jbox
from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.kernels import apply_kernel, apply_kernel_reference
from cnn_gp_tpu_torch.ops import arccos as tarc
from cnn_gp_tpu_torch.ops import boxfilter as tbox
from cnn_gp_tpu_torch.ops import layer as tlayer
from test_torch_layer_kernels import (RELU_COND, RELU_TOL, _near_unit,
                                      _plain_layer_launch, kernel_route)

assert kernel_route   # the fixture, imported for this module's tests
# the fused layer's wrapper, before any test stubs it
_LAUNCH_LAYER = tbox._launch_layer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the ResNet tiles run many small ops, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (k, stride, padding, map size): every Conv2d of mnist_as_tf (28/14/7),
# cifar10 (32/16/8), the residual config (k = 4 "same", the 28x28
# readout) and the paper ConvNet (k = 7 "same")
GEOMETRIES = [
    (3, 1, "same", 28), (3, 1, "same", 14), (3, 1, "same", 7),
    (3, 1, "same", 32), (3, 1, "same", 16), (3, 1, "same", 8),
    (3, 2, "same", 28), (3, 2, "same", 14), (3, 2, "same", 32),
    (3, 2, "same", 16), (1, 2, 0, 28), (1, 2, 0, 14), (1, 2, 0, 32),
    (1, 2, 0, 16), (1, 1, 0, 28), (1, 1, 0, 1), (7, 1, 0, 7), (8, 1, 0, 8),
    (4, 1, "same", 28), (28, 1, 0, 28), (7, 1, "same", 28),
]
# (relu_impl, acos_impl, mask)
FORMS = [(impl, acos, masked) for impl in ("fast", "reference")
         for acos in ("poly", "exact") for masked in (False, True)]


def _geom_id(g):
    k, s, p, w = g
    return f"k{k}-s{s}-p{p}-{w}x{w}"


def _arrays(nx, ny, w, wo, seed, same=False):
    """Pre-ReLU pair-patch arrays (cosines near +-1 included), a skip
    patch's arrays of the output's shape, a mask with one same-example
    pair per row where it fits."""
    r = np.random.RandomState(seed)
    xx = (r.rand(nx, w, w) + 0.2).astype(np.float32)
    yy = xx if same else (r.rand(ny, w, w) + 0.2).astype(np.float32)
    xy = (_near_unit(r, (nx, ny, w, w)) * np.sqrt(xx[:, None] * yy[None])
          ).astype(np.float32)
    skip = [r.rand(*s).astype(np.float32)
            for s in ((nx, ny, wo, wo), (nx, wo, wo), (ny, wo, wo))]
    mask = (1 + np.arange(nx))[:, None] == np.arange(ny)[None, :]
    return xy, xx, yy, skip, mask


def _patch(xy, xx, yy, mask, same=False):
    t_xx = torch.from_numpy(xx)
    t_yy = t_xx if same and yy is xx else torch.from_numpy(yy)
    return T.KernelPatch(torch.from_numpy(xy), t_xx, t_yy, same, False,
                         None if mask is None else torch.from_numpy(mask))


def _conv(k, s, p, learnable=False):
    return T.Conv2d(k, stride=s, padding=p, var_weight=2.79, var_bias=0.37,
                    learnable=learnable)


def _out_side(k, s, p, w):
    return tbox.Geometry.of(k, s, _conv(k, s, p).pad_lo_hi).out_shape(w,
                                                                      w)[0]


def _unfused_chain(kp, conv, relu, skip):
    """The layer as three separate plain steps, written out here: the
    ReLU transform, the Conv2d's three fields, the Sum's add."""
    if relu:
        kp = tarc.relu_transform_reference(kp)
    k = conv.kernel_size
    maps = [kp.xy, kp.xx] + ([] if kp.yy is kp.xx else [kp.yy])
    out = tbox.conv_maps_reference(maps, k, conv.stride, conv.pad_lo_hi,
                                   conv.dilation, conv.var_weight / (k * k),
                                   conv.var_bias)
    out = T.KernelPatch(out[0], out[1], out[-1], kp.same, kp.diag,
                        kp.diag_mask)
    return out if skip is None else skip + out


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_skip", [False, True])
def test_reference_equals_unfused_chain(geom, relu, with_skip):
    """conv_layer_reference has the bits of the unfused plain chain at
    every ResNet geometry, with and without the ReLU and the skip (each
    case in one of the ReLU's forms, with or without the mask)."""
    k, s, p, w = geom
    wo = _out_side(k, s, p, w)
    i = GEOMETRIES.index(geom) + 2 * relu + with_skip
    impl, acos, masked = FORMS[i % len(FORMS)]
    xy, xx, yy, skip, mask = _arrays(3, 4, w, wo, seed=i)
    kp = _patch(xy, xx, yy, mask if masked else None)
    sk = T.KernelPatch(*map(torch.from_numpy, skip)) if with_skip else None
    conv = _conv(k, s, p)
    with T.settings.override(relu_impl=impl, acos_impl=acos):
        got = tlayer.conv_layer_reference(kp, conv, relu, sk)
        want = _unfused_chain(kp, conv, relu, sk)
    for g, w_ in ((got.xy, want.xy), (got.xx, want.xx), (got.yy, want.yy)):
        assert g.shape == w_.shape and torch.equal(g, w_)


@pytest.mark.parametrize("impl,acos,masked", FORMS)
@pytest.mark.parametrize("same", [False, True])
def test_reference_every_form_and_same_blocks(impl, acos, masked, same):
    """Every form of the ReLU at the commonest geometry (k = 3 "same" on
    28x28), for a pair block and for a same block (yy is xx: the side
    maps filtered once), with the skip: the unfused chain's bits, and a
    same block's xy' exactly symmetric."""
    xy, xx, yy, skip, mask = _arrays(5, 5, 28, 28, seed=7, same=same)
    if same:
        i, j = np.tril_indices(5, -1)
        xy[i, j] = xy[j, i]
        mask = np.eye(5, dtype=bool)
    kp = _patch(xy, xx, yy, mask if masked or same else None, same)
    sk = T.KernelPatch(*map(torch.from_numpy, skip), same)
    conv = _conv(3, 1, "same")
    with T.settings.override(relu_impl=impl, acos_impl=acos):
        got = tlayer.conv_layer_reference(kp, conv, True, sk)
        want = _unfused_chain(kp, conv, True, sk)
        no_skip = tlayer.conv_layer_reference(kp, conv, True, None)
    for g, w_ in ((got.xy, want.xy), (got.xx, want.xx), (got.yy, want.yy)):
        assert torch.equal(g, w_)
    if same:
        assert no_skip.yy is no_skip.xx
        out = no_skip.xy.numpy()
        assert np.array_equal(out, out.transpose(1, 0, 2, 3))


BOX_TOL = 1e-6   # of max|out|: the sum order differs from JAX's


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("impl", ["fast", "reference"])
def test_reference_matches_jax(geom, impl):
    """conv_layer_reference (ReLU, Conv2d, skip) against JAX's
    relu_transform, box_filter_2d, scale, bias and the Sum's add on the
    same arrays, cosines within 1e-6 of +-1 included, masked: each
    output within BOX_TOL of max|out| plus the ReLU's bound carried
    through the filter, |scale| times the box sum of RELU_TOL max|xy'|
    plus RELU_COND sqrt(xx yy) per element (the near-unit-cosine FMA term
    of tests/test_torch_layer_kernels.py)."""
    k, s, p, w = geom
    wo = _out_side(k, s, p, w)
    xy, xx, yy, skip, mask = _arrays(3, 4, w, wo, seed=len(_geom_id(geom)))
    conv = _conv(k, s, p)
    kp = _patch(xy, xx, yy, mask)
    sk = T.KernelPatch(*map(torch.from_numpy, skip))
    with T.settings.override(relu_impl=impl):
        got = tlayer.conv_layer_reference(kp, conv, True, sk)
    jkp = cnn_gp_tpu.KernelPatch(jnp.asarray(xy), jnp.asarray(xx),
                                 jnp.asarray(yy), False, False,
                                 jnp.asarray(mask))
    with cnn_gp_tpu.settings.override(relu_impl=impl):
        r = jarc.relu_transform(jkp)
    scale = np.float32(2.79 / (k * k))
    pad = conv.pad_lo_hi
    want = [np.asarray(jbox.box_filter_2d(a, k, s, pad, 1)) * scale
            + np.float32(0.37) + b
            for a, b in zip((r.xy, r.xx, r.yy), skip)]
    relu_x = np.asarray(r.xy)
    bound = RELU_TOL * np.abs(relu_x).max() + RELU_COND * np.sqrt(
        xx[:, None] * yy[None])
    carried = abs(scale) * np.asarray(jbox.box_filter_2d(
        bound.astype(np.float32), k, s, pad, 1))
    for g, w_, extra in ((got.xy, want[0], carried), (got.xx, want[1], 0.0),
                         (got.yy, want[2], 0.0)):
        g = g.numpy().astype(np.float64)
        assert g.shape == w_.shape and np.isfinite(g).all()
        assert (np.abs(g - w_) <= BOX_TOL * np.abs(w_).max() + extra).all()


FUSED_CONFIGS = ["mnist_as_tf_mini", "cifar10", "mnist_paper_residual_cnn_gp",
                 "mnist_paper_convnet_gp"]


@pytest.mark.parametrize("name", FUSED_CONFIGS)
@pytest.mark.parametrize("masked", [False, True])
def test_fused_walk_matches_reference_and_jax(name, masked):
    """apply_kernel (the fused walk, plain versions on the CPU) on a 2x3
    tile: the bits of apply_kernel_reference (the unfused walk), and
    within 1e-5 of max|K| of JAX's apply_kernel on the same images."""
    cfg = configs.load(name)
    shape = configs.image_shape(cfg)
    r = np.random.RandomState(len(name) + masked)
    x = r.rand(2, *shape).astype(np.float32)
    z = r.rand(3, *shape).astype(np.float32)
    z[0] = x[1]
    mask = (np.arange(2)[:, None] == 1 + np.arange(3)[None, :]
            if masked else None)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got = apply_kernel(cfg.initial_model, tx, tz, False, False, tmask)
        ref = apply_kernel_reference(cfg.initial_model, tx, tz, False,
                                     False, tmask)
    assert torch.equal(got, ref)
    jmodel = jconfigs.load(name).initial_model
    want = np.asarray(cnn_gp_tpu.kernels.apply_kernel(
        jmodel, jnp.asarray(x), jnp.asarray(z), False, False,
        None if mask is None else jnp.asarray(mask)))
    got = got.numpy()
    assert got.shape == want.shape == (2, 3) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# per pair tile: box-filter launches, of them with
# the ReLU prologue and with the skip epilogue, standalone ReLU launches
TABLE = {
    "mnist_as_tf": {"box": 36, "prologue": 28, "epilogue": 15, "relu": 3},
    "mnist_as_tf_mini": {"box": 36, "prologue": 28, "epilogue": 15,
                         "relu": 3},
    "cifar10": {"box": 37, "prologue": 28, "epilogue": 15, "relu": 3},
    "mnist_paper_convnet_gp": {"box": 8, "prologue": 7, "epilogue": 0,
                               "relu": 0},
    "mnist_paper_residual_cnn_gp": {"box": 10, "prologue": 1,
                                    "epilogue": 0, "relu": 8},
}


@pytest.mark.parametrize("name", list(TABLE))
def test_launch_counts_per_config(kernel_route, name):
    """The CUDA route (launches stubbed by the plain forward) on a masked
    2x2 tile launches what the table says, chip_smoke.layer_launches
    reads the same off the model tree, and the tile keeps the plain
    walk's bits."""
    cfg = configs.load(name)
    x = torch.rand(2, *configs.image_shape(cfg),
                   generator=torch.Generator().manual_seed(3))
    mask = torch.eye(2, dtype=torch.bool)
    with torch.no_grad():
        got = apply_kernel(cfg.initial_model, x, x, False, False, mask)
        want = apply_kernel_reference(cfg.initial_model, x, x, False, False,
                                      mask)
    assert kernel_route == TABLE[name]
    assert {c: n for c, n in chip_smoke.layer_launches(
        cfg.initial_model).items() if c != "adds"} == TABLE[name]
    assert torch.equal(got, want)


def test_torch_adds_of_the_residual_config():
    """The residual config's eight Sum branches end in a ReLU: their adds
    stay torch adds, which the formula counts; the ResNet-32's all fuse."""
    for name, adds in (("mnist_paper_residual_cnn_gp", 8),
                       ("mnist_as_tf", 0), ("cifar10", 0)):
        n = chip_smoke.layer_launches(configs.load(name).initial_model)
        assert n["adds"] == adds, name


def test_fusion_rules_on_small_trees(kernel_route):
    """The rules on hand-made trees: a ReLU before a Sum with an empty
    branch, before a Sum of two Conv2d branches (two readers), before a
    Mixture, before another ReLU and at the end of the model stays a
    launch of its own; a ReLU before nested Sequentials whose first layer
    is a Conv2d fuses; a Sum of three Conv2d branches puts two adds in
    epilogues."""
    conv = lambda k=3, **kw: T.Conv2d(k, var_weight=1.3, var_bias=0.2, **kw)
    models = [
        (T.Sequential(conv(), T.ReLU(), T.Sum([T.Sequential(), conv()]),
                      conv(8, padding=0)),
         {"box": 3, "prologue": 0, "epilogue": 1, "relu": 1}),
        (T.Sequential(conv(), T.ReLU(), T.Sum([conv(), conv(1)]),
                      conv(8, padding=0)),
         {"box": 4, "prologue": 0, "epilogue": 1, "relu": 1}),
        (T.Sequential(conv(), T.ReLU(), T.Mixture([conv(), conv(1)]),
                      T.ReLU(), T.ReLU(), conv(8, padding=0)),
         {"box": 4, "prologue": 1, "epilogue": 0, "relu": 2}),
        (T.Sequential(conv(), T.ReLU(), T.Sequential(T.Sequential(conv())),
                      T.Sum([conv(), conv(1), T.Sequential(conv(),
                                                           T.ReLU(),
                                                           conv())]),
                      conv(8, padding=0), T.ReLU()),
         {"box": 7, "prologue": 2, "epilogue": 2, "relu": 1}),
    ]
    x = torch.rand(3, 2, 8, 8, generator=torch.Generator().manual_seed(5))
    mask = torch.eye(3, dtype=torch.bool)[:, [1, 0, 2]]
    for model, want in models:
        for c in kernel_route:
            kernel_route[c] = 0
        with torch.no_grad():
            got = apply_kernel(model, x, x, False, False, mask)
            ref = apply_kernel_reference(model, x, x, False, False, mask)
        assert kernel_route == want
        assert {c: n for c, n in chip_smoke.layer_launches(model).items()
                if c != "adds"} == want
        assert torch.equal(got, ref)


def _learnable_resnet():
    def conv(k, **kw):
        return T.Conv2d(k, var_weight=1.7, var_bias=0.3, learnable=True,
                        **kw)
    return T.Sequential(
        conv(3),
        T.Sequential(T.ReLU(), T.Sum([
            conv(1, stride=2, padding=0),
            T.Sequential(conv(3, stride=2), T.ReLU(), conv(3))])),
        T.Sum([T.Sequential(), T.Sequential(T.ReLU(), conv(3), T.ReLU(),
                                            conv(3))]),
        T.ReLU(), conv(4, padding=0))


@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("same", [False, True])
def test_fused_function_gives_plain_gradients(kernel_route, relu_impl,
                                              same):
    """The fused layer's autograd Function (launch stubbed) under
    grad_safe on a masked tile, a pair tile and a block of one set: the
    forward's bits, and every leaf's gradient within 1e-6 of plain
    autograd through apply_kernel_reference."""
    r = np.random.RandomState(6)
    x = torch.from_numpy(r.rand(4, 2, 8, 8).astype(np.float32))
    if same:
        z, mask = x, torch.eye(4, dtype=torch.bool)
    else:
        z = torch.cat([x[2:], torch.from_numpy(
            r.rand(3, 2, 8, 8).astype(np.float32))])
        mask = torch.arange(4)[:, None] == 2 + torch.arange(5)[None, :]
    ct = torch.from_numpy(r.rand(4, len(z)).astype(np.float32))
    model = _learnable_resnet()
    params = [p for _, p in model.named_parameters()]
    with T.settings.override(relu_impl=relu_impl, grad_safe=True):
        got_k = apply_kernel(model, x, z, same, False, mask)
        got = torch.autograd.grad((got_k * ct).sum(), params)
        want_k = apply_kernel_reference(model, x, z, same, False, mask)
        want = torch.autograd.grad((want_k * ct).sum(), params)
    assert kernel_route == {"box": 7, "prologue": 4, "epilogue": 2,
                            "relu": 1}
    assert torch.equal(got_k, want_k)
    for g, w in zip(got, want):
        g, w = g.numpy(), w.numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-3)


class _FakeLayerLib:
    def __init__(self, error=0):
        self.calls, self.error = [], error

    def cnn_gp_conv_layer(self, *args):
        self.calls.append(args)
        return self.error

    def error_string(self, code):
        return "stub error"


def _no_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the CUDA route called a plain version")

    for name in ("box_filter_2d_reference", "_plain", "conv_maps_reference"):
        monkeypatch.setattr(tbox, name, plain)
    for name in ("relu_xy_reference", "relu_transform_reference"):
        monkeypatch.setattr(tarc, name, plain)
    monkeypatch.setattr(tlayer, "_reference", plain)


@pytest.mark.parametrize("impl,acos", [("fast", "poly"),
                                       ("reference", "exact")])
def test_layer_wrapper_passes_pointers_flags_and_shapes(monkeypatch, impl,
                                                        acos):
    """One launch for a Conv2d with the ReLU prologue and the skip: the
    three maps' input, skip and output pointers, plane counts and
    prologues (the side maps halved), the pre-ReLU side maps and the mask
    as bytes, the ReLU form and acos version, the geometry, the scale
    rounded to float32 (affine), new contiguous outputs; the counts."""
    _no_plain(monkeypatch)
    lib = _FakeLayerLib()
    monkeypatch.setattr(tbox, "_lib", lib)
    xy = torch.zeros(4, 3, 28, 28).transpose(0, 1)     # not contiguous
    xx, yy = torch.ones(3, 28, 28), torch.ones(4, 28, 28)
    mask = torch.zeros(3, 4, dtype=torch.bool)
    skip = T.KernelPatch(torch.zeros(3, 4, 14, 14), torch.zeros(3, 14, 14),
                         torch.zeros(4, 14, 14))
    kp = T.KernelPatch(xy, xx, yy, False, False, mask)
    before = (tbox.launches, tbox.prologue_launches, tbox.epilogue_launches,
              tbox.copies)
    with T.settings.override(relu_impl=impl, acos_impl=acos):
        out = tlayer._route(kp, T.Conv2d(3, stride=2, var_weight=2.79,
                                         var_bias=0.1), True, skip, 0)
    assert (tbox.launches, tbox.prologue_launches, tbox.epilogue_launches,
            tbox.copies) == (before[0] + 1, before[1] + 1, before[2] + 1,
                             before[3] + 1)
    (args,) = lib.calls
    assert args[0] != xy.data_ptr()                   # the contiguous copy
    assert args[1:5] == (skip.xy.data_ptr(), out.xy.data_ptr(), 12,
                         tbox.RELU)
    assert args[5:10] == (xx.data_ptr(), skip.xx.data_ptr(),
                          out.xx.data_ptr(), 3, tbox.HALF)
    assert args[10:15] == (yy.data_ptr(), skip.yy.data_ptr(),
                           out.yy.data_ptr(), 4, tbox.HALF)
    assert args[15:18] == (xx.data_ptr(), yy.data_ptr(), mask.data_ptr())
    assert args[18:21] == (4, int(impl == "reference"), int(acos == "exact"))
    assert args[21:30] == (28, 28, 14, 14, 3, 2, 1, 1, 1)   # affine
    assert args[30] == float(np.float32(2.79 / 9)) != 2.79 / 9
    assert args[31] == float(np.float32(0.1))
    # the "fast" form's factor table (allocated by the wrapper); the fixed
    # geometry's kernel where there is one; the stream
    assert args[32:34] == (None, None)
    assert (args[34] is None) == (impl == "reference")
    assert args[35] == 0 and args[37] == 0
    assert [tuple(t.shape) for t in (out.xy, out.xx, out.yy)] == [
        (3, 4, 14, 14), (3, 14, 14), (4, 14, 14)]
    assert all(t.is_contiguous() for t in (out.xy, out.xx, out.yy))
    tbox._launch_layer(tbox.Geometry.of(3, 1, "same", 1), [xx], [tbox.AS_IS],
                       [None], None, 1.0, 0.0, 0, runtime_geometry=True)
    assert lib.calls[-1][35] == 1                 # the run-time indices


def test_layer_wrapper_same_block_and_no_prologue(monkeypatch):
    """A same block after the ReLU filters its side map once (two maps,
    yy' is xx'), unless the skip's yy is a map of its own (a third map
    over xx); without the ReLU nothing is halved and no side operands
    are passed; a learnable scale on the CPU is read as its value."""
    _no_plain(monkeypatch)
    lib = _FakeLayerLib()
    monkeypatch.setattr(tbox, "_lib", lib)
    xx = torch.ones(3, 8, 8)
    kp = T.KernelPatch(torch.zeros(3, 3, 8, 8), xx, xx.clone(), True, False)
    conv = T.Conv2d(3, var_weight=2.0, var_bias=0.5)
    out = tlayer._route(kp, conv, True, None, 0)
    args = lib.calls[-1]
    assert out.yy is out.xx and args[13] == 0 and args[4] == tbox.RELU
    # the pre-ReLU side maps, and the eye mask of a block of one set
    assert args[15:17] == (kp.xx.data_ptr(), kp.yy.data_ptr())
    assert args[17] is not None
    s = torch.zeros(3, 8, 8)
    skip = T.KernelPatch(torch.zeros(3, 3, 8, 8), s, s.clone(), True, False)
    out = tlayer._route(kp, conv, True, skip, 0)
    args = lib.calls[-1]
    assert out.yy is not out.xx
    assert args[10] == xx.data_ptr() and args[11] == skip.yy.data_ptr()
    assert args[14] == tbox.HALF
    out = tlayer._route(kp, T.Conv2d(1, learnable=True, var_weight=3.0),
                        False, None, 0)
    args = lib.calls[-1]
    assert args[4] == args[9] == args[14] == tbox.AS_IS
    assert args[15:18] == (None, None, None)
    assert args[30] == 3.0 and args[32:34] == (None, None)


def test_layer_wrapper_raises(monkeypatch):
    """A non-zero return code, a wrong dtype or shape, a skip of the wrong
    shape, the ReLU prologue on a diagonal patch and a non-CUDA device
    all raise; nothing falls back to the plain version."""
    _no_plain(monkeypatch)
    monkeypatch.setattr(tbox, "_lib", _FakeLayerLib(error=700))
    kp = T.KernelPatch(torch.ones(2, 3, 8, 8), torch.ones(2, 8, 8),
                       torch.ones(3, 8, 8))
    conv = T.Conv2d(3)
    before = tbox.launches
    with pytest.raises(RuntimeError, match="cuda error 700"):
        tlayer._route(kp, conv, True, None, 0)
    assert tbox.launches == before
    monkeypatch.setattr(tbox, "_lib", _FakeLayerLib())
    bad = T.KernelPatch(kp.xy.double(), kp.xx, kp.yy)
    with pytest.raises(ValueError, match="float32"):
        tlayer._route(bad, conv, True, None, 0)
    bad = T.KernelPatch(kp.xy, kp.yy, kp.xx)
    with pytest.raises(ValueError, match="ReLU prologue takes"):
        tlayer._route(bad, conv, True, None, 0)
    skip = T.KernelPatch(torch.ones(2, 3, 4, 4), torch.ones(2, 4, 4),
                         torch.ones(3, 4, 4))
    with pytest.raises(ValueError, match="a skip must be"):
        tlayer._route(kp, conv, False, skip, 0)
    diag = T.KernelPatch(torch.ones(2, 8, 8), torch.ones(2, 8, 8),
                         torch.ones(2, 8, 8), False, True)
    with pytest.raises(ValueError, match="pair patches"):
        tlayer._route(diag, conv, True, None, 0)
    meta = T.KernelPatch(*(torch.empty(s, device="meta") for s in
                           ((2, 3, 8, 8), (2, 8, 8), (3, 8, 8))))
    with pytest.raises(ValueError, match="cuda tensors"):
        tlayer.conv_layer(meta, conv, True, None)


# (map side, k, stride, padding, relu_impl, runtime_geometry): whether a
# launch with the ReLU prologue takes the kernel's relu_run
RELU_RUN_CASES = [
    (28, 3, 1, "same", "fast", False, True),
    (28, 3, 1, "same", "reference", False, False),
    (28, 3, 1, "same", "fast", True, False),
    (28, 7, 1, "same", "fast", False, True),     # the fit's ConvNet
    (28, 5, 1, "same", "fast", False, False),
    (14, 3, 2, "same", "fast", False, True),
    (7, 3, 1, "same", "fast", False, True),
    (32, 3, 1, "same", "fast", False, True),     # cifar10
    (12, 3, 1, "same", "fast", False, False),
]


@pytest.mark.parametrize("w,k,st,pad,impl,runtime,takes", RELU_RUN_CASES)
def test_relu_run_launches_follow_the_launch_shape(monkeypatch, w, k, st,
                                                   pad, impl, runtime,
                                                   takes):
    """relu_run_launches counts a ReLU-prologue launch when its planes
    take the kernel's relu_run: the "fast" form on a geometry of
    FIXED_GEOMETRIES, not forced onto the run-time kernel; a launch
    without the ReLU never counts."""
    _no_plain(monkeypatch)
    monkeypatch.setattr(tbox, "_lib", _FakeLayerLib())
    assert "relu_run_launches" in tbox.COUNTERS
    xx, yy = torch.ones(3, w, w), torch.ones(2, w, w)
    form = tarc.PAIR_FAST if impl == "fast" else tarc.PAIR_REFERENCE
    geom = tbox.Geometry.of(k, st, pad, 1)
    before = (tbox.prologue_launches, tbox.relu_run_launches)
    tbox._launch_layer(geom, [torch.zeros(3, 2, w, w), xx, yy],
                       [tbox.RELU, tbox.HALF, tbox.HALF], [None] * 3,
                       (xx, yy, None, form, 0), 1.0, 0.0, 0,
                       runtime_geometry=runtime)
    assert (tbox.prologue_launches - before[0],
            tbox.relu_run_launches - before[1]) == (1, int(takes))
    tbox._launch_layer(geom, [xx], [tbox.AS_IS], [None], None, 1.0, 0.0, 0,
                       runtime_geometry=runtime)
    assert tbox.relu_run_launches - before[1] == int(takes)


@pytest.mark.parametrize("name,prologues,runs", [
    ("mnist_as_tf", 28, 27), ("mnist_paper_convnet_gp", 0, 0)])
def test_relu_run_launches_on_the_gram_call_span(monkeypatch, kernel_route,
                                                 name, prologues, runs):
    """A Gram call's gram.call span carries relu_run_launches with the
    other counters: on the CUDA route (each fused launch through the real
    wrapper, a stubbed library, then its plain forward) an mnist_as_tf
    tile's 28 ReLU prologues take relu_run but for the last, the dense
    1x1 readout's on 1x1 maps (a run-time geometry); the ConvNet's tiles
    take the megakernel and launch no box filter."""
    from cnn_gp_tpu_torch.parallel import gram_device
    from cnn_gp_tpu_torch.utils import timing
    stub = tbox._launch_layer
    monkeypatch.setattr(tbox, "_lib", _FakeLayerLib())

    def launch(geom, maps, pros, skips, side, scale, bias, stream):
        _LAUNCH_LAYER(geom, maps, pros, skips, side, scale, bias, stream)
        return stub(geom, maps, pros, skips, side, scale, bias, stream)
    monkeypatch.setattr(tbox, "_launch_layer", launch)
    x = torch.rand(3, 1, 28, 28, generator=torch.Generator().manual_seed(5))
    with timing.recording() as found, torch.no_grad():
        gram_device(configs.load(name).initial_model, x, batch_size=2,
                    device="cpu")
    call, = [s for s in found if s.name == "gram.call"]
    assert call.attrs["tiles"] == 3
    assert (call.attrs["boxfilter.prologue_launches"],
            call.attrs["boxfilter.relu_run_launches"]) == (3 * prologues,
                                                           3 * runs)


@pytest.mark.parametrize("setting,value", [
    ("conv_method", "bogus"), ("relu_method", "bogus"),
    ("conv_method", "shifts"), ("relu_method", "xla")])
def test_both_packages_check_the_method_names(setting, value):
    """An mnist_as_tf 2x2 tile with an unknown settings.conv_method or
    relu_method: both packages raise ValueError (the port on the plain
    route, the unfused walk and the kernel route's check); a name JAX
    knows gives the same tile as the default."""
    x = np.random.RandomState(1).rand(2, 1, 28, 28).astype(np.float32)
    jmodel = jconfigs.load("mnist_as_tf").initial_model
    tmodel = configs.load("mnist_as_tf").initial_model
    tx = torch.from_numpy(x)

    def tiles():
        t = apply_kernel(tmodel, tx, tx, True, False)
        r = apply_kernel_reference(tmodel, tx, tx, True, False)
        j = cnn_gp_tpu.kernels.apply_kernel(jmodel, jnp.asarray(x),
                                            jnp.asarray(x), True, False)
        return t, r, np.asarray(j)

    with torch.no_grad():
        default = tiles()
        with T.settings.override(**{setting: value}), \
                cnn_gp_tpu.settings.override(**{setting: value}):
            if value == "bogus":
                with pytest.raises(ValueError, match="unknown"):
                    apply_kernel(tmodel, tx, tx, True, False)
                with pytest.raises(ValueError, match="unknown"):
                    apply_kernel_reference(tmodel, tx, tx, True, False)
                with pytest.raises(ValueError, match="unknown"):
                    cnn_gp_tpu.kernels.apply_kernel(
                        jmodel, jnp.asarray(x), jnp.asarray(x), True, False)
                check = (tbox.check_method if setting == "conv_method"
                         else tarc.check_method)
                with pytest.raises(ValueError, match="unknown"):
                    check()
                return
            t, r, j = tiles()
    assert torch.equal(t, default[0]) and torch.equal(r, default[1])
    assert np.abs(j - default[2]).max() <= 1e-6 * np.abs(default[2]).max()

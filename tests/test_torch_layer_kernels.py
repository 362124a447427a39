"""The layer kernels' modules on the CPU: the plain box filter and arccos
ReLU (``ops/boxfilter.py``, ``ops/arccos.py``) against the JAX package's
on the same numpy inputs, both CUDA wrappers with a stubbed ``_lib``, the
``autograd.Function``s with a stub that computes the plain forward,
``apply_kernel_reference`` against ``apply_kernel``, and the launch
formula of ``chip_smoke.py``'s ResNet-32 phase.  The kernels themselves
are checked on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cnn_gp_tpu
import cnn_gp_tpu_torch as T
from cnn_gp_tpu.ops import arccos as jarc
from cnn_gp_tpu.ops import boxfilter as jbox
from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.kernels import apply_kernel, apply_kernel_reference
from cnn_gp_tpu_torch.ops import arccos as tarc
from cnn_gp_tpu_torch.ops import boxfilter as tbox
from cnn_gp_tpu_torch.ops import layer as tlayer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the ResNet tiles run many small ops, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (k, stride, padding, dilation, map size): every Conv2d of the ResNet
# configs (mnist_as_tf at 28/14/7, cifar10 at 32/16/8, the residual
# config's even kernel and 28x28 readout), and dilation 2
BOX_CASES = [
    (3, 1, "same", 1, 28), (3, 1, "same", 1, 14), (3, 1, "same", 1, 7),
    (3, 1, "same", 1, 32), (3, 1, "same", 1, 16), (3, 1, "same", 1, 8),
    (3, 2, "same", 1, 28), (3, 2, "same", 1, 14), (3, 2, "same", 1, 32),
    (3, 2, "same", 1, 16), (1, 2, 0, 1, 28), (1, 2, 0, 1, 14),
    (1, 2, 0, 1, 32), (1, 2, 0, 1, 16), (1, 1, 0, 1, 28), (1, 1, 0, 1, 1),
    (7, 1, 0, 1, 7), (8, 1, 0, 1, 8), (4, 1, "same", 1, 28),
    (28, 1, 0, 1, 28), (3, 1, "same", 2, 28), (4, 1, "same", 2, 14),
]
BOX_TOL = 1e-6   # relative to max|out|: the sum order differs from JAX's


def _box_id(case):
    k, s, p, d, w = case
    return f"k{k}-s{s}-p{p}-d{d}-{w}x{w}"


@pytest.mark.parametrize("case", BOX_CASES, ids=_box_id)
@pytest.mark.parametrize("method", ["separable", "shifts", "direct",
                                    "matmul"])
def test_plain_box_filter_matches_jax(case, method):
    """box_filter_2d_reference on [b1, b2, W, H] and [b, W, H] against
    JAX's box_filter_2d in each of its four lowerings, 1e-6 relative."""
    k, s, p, d, w = case
    rng = np.random.RandomState(k * 100 + w)
    for shape in ((3, 4, w, w), (5, w, w)):
        x = rng.rand(*shape).astype(np.float32)
        want = np.asarray(jbox.box_filter_2d(x, k, s, p, d, method=method))
        got = tbox.box_filter_2d_reference(torch.from_numpy(x), k, s, p,
                                           d).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() / np.abs(want).max() <= BOX_TOL


def _near_unit(rng, shape):
    """Cosines in [-1, 1], a share of them within 1e-6 of +-1 and some
    exactly +-1."""
    c = rng.uniform(-1.0, 1.0, shape)
    flat = c.reshape(-1)
    flat[0::11] = 1.0 - rng.uniform(0.0, 1e-6, flat[0::11].shape)
    flat[1::11] = -1.0 + rng.uniform(0.0, 1e-6, flat[1::11].shape)
    flat[2::23] = 1.0
    flat[3::23] = -1.0
    return c


def _patch_arrays(nx, ny, diag, same, seed, w=4, h=5):
    r = np.random.RandomState(seed)
    xx = (r.rand(nx, w, h) + 0.2).astype(np.float32)
    yy = xx if same else (r.rand(ny, w, h) + 0.2).astype(np.float32)
    if diag:
        xy = _near_unit(r, (nx, w, h)) * np.sqrt(xx * yy)
    else:
        xy = _near_unit(r, (nx, ny, w, h)) * np.sqrt(xx[:, None] * yy[None])
    return xy.astype(np.float32), xx, yy


# (nx, ny, same, diag, mask kind)
RELU_PATCHES = [
    (6, 9, False, False, None),
    (6, 9, False, False, "global"),
    (8, 8, True, False, None),
    (8, 8, True, False, "eye"),
    (8, 8, False, False, "eye"),
    (7, 7, False, True, None),
    (7, 7, True, True, None),
]
RELU_TOL = 1e-5   # of max|xy'|: the repo's kernel parity rule
# Plus, per element, the float32 conditioning of the reference form near
# |cos| = 1: its sine is sqrt(xx*yy - xy*xy), which there cancels to a few
# ulps of xx*yy, so a difference of 2^-22 xx*yy in it (XLA's CPU code
# contracts xx*yy - xy*xy into an FMA, torch rounds xy*xy first) moves xy'
# by 2^-11 sqrt(xx*yy) / (2 pi).  The bound is twice that.
RELU_COND = 2.0 ** -11 / np.pi


def _masks(kind, nx, ny):
    if kind == "global":
        return (3 + np.arange(nx))[:, None] == np.arange(ny)[None, :]
    if kind == "eye":
        return np.eye(nx, ny, dtype=bool)
    return None


@pytest.mark.parametrize("nx,ny,same,diag,mask_kind", RELU_PATCHES)
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_plain_relu_matches_jax_near_unit_cosines(nx, ny, same, diag,
                                                  mask_kind, relu_impl,
                                                  acos_impl):
    """relu_transform_reference against JAX's _relu_xla with cosines
    within 1e-6 of +-1, in both forms and both acos versions, pair and
    diagonal, with and without the mask: within 1e-5 of max|xy'| plus
    RELU_COND sqrt(xx yy) per element (xx', yy' within 1e-5); the
    same-example entries equal xx' exactly."""
    xy, xx, yy = _patch_arrays(nx, ny, diag, same, seed=nx + 10 * ny)
    mask = _masks(mask_kind, nx, ny)
    jkp = cnn_gp_tpu.KernelPatch(
        jnp.asarray(xy), jnp.asarray(xx), jnp.asarray(yy), same, diag,
        None if mask is None else jnp.asarray(mask))
    tkp = T.KernelPatch(
        torch.from_numpy(xy), torch.from_numpy(xx), torch.from_numpy(yy),
        same, diag, None if mask is None else torch.from_numpy(mask))
    with cnn_gp_tpu.settings.override(relu_impl=relu_impl,
                                      acos_impl=acos_impl):
        want = jarc._relu_xla(jkp)
    with T.settings.override(relu_impl=relu_impl, acos_impl=acos_impl):
        got = tarc.relu_transform_reference(tkp)
    scale = np.sqrt(xx * yy if diag else xx[:, None] * yy[None])
    for g, w, cond in ((got.xy, want.xy, RELU_COND * scale),
                       (got.xx, want.xx, 0.0), (got.yy, want.yy, 0.0)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert (np.abs(g.astype(np.float64) - w)
                <= RELU_TOL * np.abs(w).max() + cond).all()
    resolved = tkp.resolve_diag_mask()
    if resolved is not None:
        i, j = np.nonzero(resolved.numpy())
        np.testing.assert_array_equal(got.xy.numpy()[i, j],
                                      got.xx.numpy()[i])


@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_plain_relu_exactly_symmetric_when_z_is_x(relu_impl, acos_impl):
    """A block of one set (x is z: xx and yy equal, xy symmetric) gives an
    exactly symmetric xy'."""
    r = np.random.RandomState(4)
    xx = (r.rand(9, 4, 5) + 0.2).astype(np.float32)
    xy = (_near_unit(r, (9, 9, 4, 5)) * np.sqrt(xx[:, None] * xx[None])
          ).astype(np.float32)
    i, j = np.tril_indices(9, -1)
    xy[i, j] = xy[j, i]                  # mirror the upper triangle
    assert np.array_equal(xy, xy.transpose(1, 0, 2, 3))
    t_xx = torch.from_numpy(xx)
    kp = T.KernelPatch(torch.from_numpy(xy), t_xx, t_xx.clone(), False,
                       False, torch.eye(9, dtype=torch.bool))
    with T.settings.override(relu_impl=relu_impl, acos_impl=acos_impl):
        out = tarc.relu_transform_reference(kp).xy.numpy()
    assert np.array_equal(out, out.transpose(1, 0, 2, 3))


class _FakeBoxLib:
    def __init__(self, error=0):
        self.calls, self.error = [], error

    def cnn_gp_conv_layer(self, *args):
        self.calls.append(args)
        return self.error

    def error_string(self, code):
        return "stub error"


class _FakeReluLib:
    def __init__(self, error=0):
        self.calls, self.error = [], error

    def cnn_gp_relu(self, *args):
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


def test_box_wrapper_passes_shapes_scale_and_counts(monkeypatch):
    """One launch for three fields: the pointers, plane counts, geometry,
    the scale rounded to float32, contiguous inputs (a non-contiguous one
    copied and counted), new contiguous outputs."""
    _no_plain(monkeypatch)
    lib = _FakeBoxLib()
    monkeypatch.setattr(tbox, "_lib", lib)
    xy = torch.zeros(6, 5, 28, 28).transpose(0, 1)     # not contiguous
    xx, yy = torch.zeros(5, 28, 28), torch.zeros(6, 28, 28)
    geom = tbox.Geometry.of(3, 2, "same", 1)
    before = (tbox.launches, tbox.copies)
    outs = tbox._launch(geom, [xy, xx, yy], 2.79 / 9, 0.1, 0)
    assert (tbox.launches, tbox.copies) == (before[0] + 1, before[1] + 1)
    (args,) = lib.calls
    # (input, skip, output, planes, prologue) per map: no skip, as is
    assert args[1:5] == (None, outs[0].data_ptr(), 30, tbox.AS_IS)
    assert args[0] != xy.data_ptr()                  # the contiguous copy
    assert args[5:10] == (xx.data_ptr(), None, outs[1].data_ptr(), 5,
                          tbox.AS_IS)
    assert args[10:15] == (yy.data_ptr(), None, outs[2].data_ptr(), 6,
                           tbox.AS_IS)
    assert args[15:21] == (None, None, None, 0, 0, 0)   # no ReLU operands
    assert args[21:30] == (28, 28, 14, 14, 3, 2, 1, 1, 1)
    assert args[30] == float(np.float32(2.79 / 9)) != 2.79 / 9
    assert args[31] == float(np.float32(0.1))
    assert args[32:34] == (None, None)
    assert [tuple(o.shape) for o in outs] == [(5, 6, 14, 14), (5, 14, 14),
                                              (6, 14, 14)]
    assert all(o.is_contiguous() and o.dtype == torch.float32 for o in outs)


def test_box_wrapper_one_map_and_tensor_operands(monkeypatch):
    """box_filter_2d's launch has no scale or bias (affine 0) and unused
    slots; a 0-d CPU tensor scale is read as its float32 value."""
    _no_plain(monkeypatch)
    lib = _FakeBoxLib()
    monkeypatch.setattr(tbox, "_lib", lib)
    x = torch.zeros(4, 7, 7)
    (out,) = tbox._launch(tbox.Geometry.of(7, 1, 0, 1), [x], None, None, 0)
    args = lib.calls[-1]
    assert args[3] == 4
    assert args[5:15] == (None, None, None, 0, tbox.AS_IS) * 2
    assert args[21:30] == (7, 7, 1, 1, 7, 1, 0, 1, 0)
    assert tuple(out.shape) == (4, 1, 1)
    scale = torch.tensor(3.0) / 9
    tbox._launch(tbox.Geometry.of(3, 1, "same", 1), [x], scale,
                 torch.tensor(0.5), 0)
    args = lib.calls[-1]
    assert args[29:34] == (1, float(scale), 0.5, None, None)
    assert tbox.launches >= 2


def test_box_wrapper_raises(monkeypatch):
    """A non-zero return code, a wrong dtype, mismatched maps and a
    non-CUDA device all raise; nothing falls back to the plain version."""
    _no_plain(monkeypatch)
    monkeypatch.setattr(tbox, "_lib", _FakeBoxLib(error=700))
    geom = tbox.Geometry.of(3, 1, "same", 1)
    before = tbox.launches
    with pytest.raises(RuntimeError, match="cuda error 700"):
        tbox._launch(geom, [torch.zeros(2, 8, 8)], 1.0, 0.0, 0)
    assert tbox.launches == before
    monkeypatch.setattr(tbox, "_lib", _FakeBoxLib())
    with pytest.raises(ValueError, match="float32"):
        tbox._launch(geom, [torch.zeros(2, 8, 8, dtype=torch.float64)], 1.0,
                     0.0, 0)
    with pytest.raises(ValueError, match="maps differ"):
        tbox._launch(geom, [torch.zeros(2, 8, 8), torch.zeros(2, 7, 7)], 1.0,
                     0.0, 0)
    with pytest.raises(ValueError, match="float32 scalars"):
        tbox._launch(geom, [torch.zeros(2, 8, 8)], torch.ones(2), 0.0, 0)
    meta = torch.empty(2, 8, 8, device="meta")
    with pytest.raises(ValueError, match="cuda tensors"):
        tbox.conv_maps([meta], 3, 1, "same", 1, 1.0, 0.0)
    with pytest.raises(ValueError, match="cuda tensors"):
        tbox.box_filter_2d(meta, 3)


@pytest.mark.parametrize("mode_name,diag", [("fast", False),
                                            ("reference", False),
                                            ("fast", True)])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_relu_wrapper_passes_shapes_and_counts(monkeypatch, mode_name, diag,
                                               acos_impl):
    """The pair and diagonal launches: pointers, sizes, mode, acos
    version, the mask as bytes, contiguous inputs, one count."""
    _no_plain(monkeypatch)
    lib = _FakeReluLib()
    monkeypatch.setattr(tarc, "_lib", lib)
    if diag:
        xy, xx, yy = (torch.zeros(5, 4, 3) for _ in range(3))
        mask = None
    else:
        xy = torch.zeros(5, 6, 4, 3)
        xx, yy = torch.zeros(5, 4, 3), torch.zeros(6, 4, 3)
        mask = torch.zeros(6, 5, dtype=torch.bool).T       # not contiguous
    before = (tarc.launches, tarc.copies)
    with T.settings.override(relu_impl=mode_name, acos_impl=acos_impl):
        out = tarc._route(xy, xx, yy, mask, diag, 0)
    (args,) = lib.calls
    assert args[:3] == (xy.data_ptr(), xx.data_ptr(), yy.data_ptr())
    assert args[4] == out.data_ptr()
    mode = (tarc.DIAGONAL if diag else
            tarc.PAIR_FAST if mode_name == "fast" else tarc.PAIR_REFERENCE)
    assert args[5:10] == ((5, 1, 12, mode) if diag else (5, 6, 12, mode)) + (
        int(acos_impl == "exact"),)
    if diag:
        assert args[3] is None
        assert (tarc.launches, tarc.copies) == (before[0] + 1, before[1])
    else:
        assert args[3] not in (None, mask.data_ptr())        # the copy
        assert (tarc.launches, tarc.copies) == (before[0] + 1, before[1] + 1)
    assert out.shape == xy.shape and out.is_contiguous()


def test_relu_wrapper_raises(monkeypatch):
    _no_plain(monkeypatch)
    monkeypatch.setattr(tarc, "_lib", _FakeReluLib(error=9))
    xy, xx, yy = torch.zeros(2, 3, 4, 4), torch.zeros(2, 4, 4), torch.zeros(
        3, 4, 4)
    before = tarc.launches
    with pytest.raises(RuntimeError, match="cuda error 9"):
        tarc._route(xy, xx, yy, None, False, 0)
    assert tarc.launches == before
    monkeypatch.setattr(tarc, "_lib", _FakeReluLib())
    with pytest.raises(ValueError, match="float32"):
        tarc._route(xy.double(), xx, yy, None, False, 0)
    with pytest.raises(ValueError, match="pair mode"):
        tarc._route(xy, yy, xx, None, False, 0)
    with pytest.raises(ValueError, match="mask must be bool"):
        tarc._route(xy, xx, yy, torch.zeros(2, 3, dtype=torch.uint8), False,
                    0)
    with pytest.raises(ValueError, match="diagonal mode takes no mask"):
        tarc._launch(xy[:, 0], xx, xx, torch.zeros(2, 2, dtype=torch.bool),
                     tarc.DIAGONAL, 0, 0)
    meta = T.KernelPatch(*(torch.empty(s, device="meta") for s in
                           ((2, 3, 4, 4), (2, 4, 4), (3, 4, 4))))
    with pytest.raises(ValueError, match="cuda tensors"):
        tarc.relu_transform(meta)


def _plain_layer_launch(geom, maps, prologues, skips, side, scale, bias):
    """What one fused launch computes, map by map, in plain torch: the
    prologue, the scaled box filter, the skip added."""
    outs = []
    for x, pro, skip in zip(maps, prologues, skips):
        if pro == tbox.RELU:
            xx, yy, mask, _, _ = side
            x = tarc.relu_xy_reference(x, xx, yy, mask, False)
        elif pro == tbox.HALF:
            x = x * 0.5
        out = tbox.conv_maps_reference([x], *geom, scale, bias)[0]
        outs.append((out if skip is None else skip + out).contiguous())
    return outs


@pytest.fixture()
def kernel_route(monkeypatch):
    """The CUDA route of the layers on CPU tensors: the launches are
    stubbed by the plain forward (under no_grad, as a kernel computes
    it), so everything around them, the autograd Functions included,
    runs as on the card; the backward's launches of the adjoint kernels
    are stubbed by their plain versions.  Counts every stubbed forward
    launch: every box-filter launch ("box"), of them those with the ReLU
    prologue ("prologue") and with the skip epilogue ("epilogue"), and
    the standalone ReLU launches ("relu")."""
    counts = {"box": 0, "prologue": 0, "epilogue": 0, "relu": 0}

    def box_launch(geom, maps, scale, bias, stream):
        counts["box"] += 1
        with torch.no_grad():
            return [o.contiguous() for o in tbox.conv_maps_reference(
                maps, *geom, scale, bias)]

    def layer_launch(geom, maps, prologues, skips, side, scale, bias,
                     stream):
        counts["box"] += 1
        counts["prologue"] += tbox.RELU in prologues
        counts["epilogue"] += any(s is not None for s in skips)
        with torch.no_grad():
            return _plain_layer_launch(geom, maps, prologues, skips, side,
                                       scale, bias)

    def relu_launch(xy, xx, yy, mask, mode, exact, stream):
        counts["relu"] += 1
        with torch.no_grad():
            return tarc.relu_xy_reference(xy, xx, yy, mask,
                                          mode == tarc.DIAGONAL)

    def box_vjp_launch(*args):
        tbox.vjp_launches += 1
        return tbox._vjp_reference(*args[:-1])

    def relu_vjp_launch(*args):
        tarc.vjp_launches += 1
        return tarc._vjp_reference(*args[:-1])

    monkeypatch.setattr(tbox, "_launch", box_launch)
    monkeypatch.setattr(tbox, "_launch_layer", layer_launch)
    monkeypatch.setattr(tarc, "_launch", relu_launch)
    # the backward's launches, by the adjoints' plain versions (counted
    # in the modules' own vjp_launches, as the kernels' wrappers count)
    monkeypatch.setattr(tbox, "_launch_vjp", box_vjp_launch)
    monkeypatch.setattr(tarc, "_launch_vjp", relu_vjp_launch)
    monkeypatch.setattr(
        tlayer, "conv_layer", lambda kp, conv, relu=False, skip=None:
        tlayer._route(kp, conv, relu, skip, 0))
    monkeypatch.setattr(
        tbox, "conv_maps", lambda maps, k, s, p, d, scale, bias: tbox._route(
            tbox.Geometry.of(k, s, p, d), list(maps), scale, bias, 0))
    monkeypatch.setattr(
        tarc, "relu_transform", lambda kp: tarc._transform(
            kp, lambda *a: tarc._route(*a, 0)))
    return counts


def _small_resnet(learnable):
    """A small ResNet with learnable leaves and a Mixture: stem, a
    projection block at stride 2, a plain block, the readout."""
    def conv(k, **kw):
        return T.Conv2d(k, var_weight=1.7, var_bias=0.3,
                        learnable=learnable, **kw)
    return T.Sequential(
        conv(3),
        T.Sequential(T.ReLU(), T.Sum([
            conv(1, stride=2, padding=0),
            T.Sequential(conv(3, stride=2), T.ReLU(), conv(3))])),
        T.Mixture([T.Sequential(),
                   T.Sequential(T.ReLU(), conv(3), T.ReLU(), conv(4))],
                  logit_proportions=[0.3, -0.2]),
        T.ReLU(), conv(4, padding=0))


# one pair tile of _small_resnet through the fused walk: 7 Conv2d; the
# projection block's ReLU (two readers) one standalone launch, the four
# ReLUs before a single Conv2d in its prologue; the second branch's add
# in the epilogue of its last convolution
SMALL_RESNET_LAUNCHES = {"box": 7, "prologue": 4, "epilogue": 1, "relu": 1}


def _leaf_grads(model, x, z, mask, ct):
    with T.settings.override(grad_safe=True):
        k = apply_kernel(model, x, z, False, False, mask)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad((k * ct).sum(), params)
    return k.detach(), {n: g for (n, _), g in zip(model.named_parameters(),
                                                  grads)}


@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_autograd_functions_give_plain_gradients(kernel_route, relu_impl):
    """Leaf gradients (var_weight, var_bias, logit) of a small masked
    ResNet tile through the fused layer's and the ReLU's autograd
    Functions equal plain autograd's (apply_kernel_reference, no
    Function) within 1e-6; the forward has the same bits."""
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.rand(5, 2, 8, 8).astype(np.float32))
    z = torch.cat([x[3:], torch.from_numpy(
        r.rand(4, 2, 8, 8).astype(np.float32))])
    # rows 3, 4 are columns 0, 1 (the same examples)
    mask = torch.arange(5)[:, None] == 3 + torch.arange(6)[None, :]
    ct = torch.from_numpy(r.rand(5, 6).astype(np.float32))
    model = _small_resnet(learnable=True)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    assert len(params) == 15
    with T.settings.override(relu_impl=relu_impl, grad_safe=True):
        got_k = apply_kernel(model, x, z, False, False, mask)
        got = torch.autograd.grad((got_k * ct).sum(), params)
        assert kernel_route == SMALL_RESNET_LAUNCHES
        want_k = apply_kernel_reference(model, x, z, False, False, mask)
        want = torch.autograd.grad((want_k * ct).sum(), params)
    assert kernel_route == SMALL_RESNET_LAUNCHES
    assert torch.equal(got_k, want_k)
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), w.numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-3), name


def _small_residual(learnable):
    """A small net of the residual config's form: Sum branches that end
    in a ReLU, each a standalone ReLU launch and a torch add."""
    def conv(k, **kw):
        return T.Conv2d(k, var_weight=1.7, var_bias=0.3,
                        learnable=learnable, **kw)
    return T.Sequential(
        conv(3),
        T.Sum([T.Sequential(), T.Sequential(conv(4), T.ReLU())]),
        T.Sum([T.Sequential(), T.Sequential(conv(3), T.ReLU())]),
        conv(3), T.ReLU(), conv(8, padding=0))


@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("leg", ["residual", "diagonal"])
def test_standalone_functions_give_plain_gradients(kernel_route, monkeypatch,
                                                   relu_impl, leg):
    """The standalone launches' autograd Functions under grad_safe, each
    seen on the path: the ReLU's (_ReluXY) on a masked pair tile of
    _small_residual, the box filter's (_ConvMaps) on a diagonal of
    _small_resnet (the unfused walk).  The forward has the bits of
    apply_kernel_reference and every leaf's gradient is within 1e-6 of
    plain autograd's."""
    applied = {"relu": 0, "box": 0}
    for name, fn in (("relu", tarc._ReluXY), ("box", tbox._ConvMaps)):
        def counted(*args, _name=name, _apply=fn.apply):
            applied[_name] += 1
            return _apply(*args)
        monkeypatch.setattr(fn, "apply", counted)
    r = np.random.RandomState(7)
    x = torch.from_numpy(r.rand(5, 2, 8, 8).astype(np.float32))
    if leg == "residual":
        model = _small_residual(learnable=True)
        z = torch.cat([x[3:], torch.from_numpy(
            r.rand(4, 2, 8, 8).astype(np.float32))])
        mask = torch.arange(5)[:, None] == 3 + torch.arange(6)[None, :]
        args = (x, z, False, False, mask)
        ct = torch.from_numpy(r.rand(5, 6).astype(np.float32))
        want_counts = {"box": 5, "prologue": 1, "epilogue": 0, "relu": 2}
    else:
        model = _small_resnet(learnable=True)
        args = (x, x, True, True)
        ct = torch.from_numpy(r.rand(5).astype(np.float32))
        want_counts = {"box": 7, "prologue": 0, "epilogue": 0, "relu": 0}
    params = [p for _, p in model.named_parameters()]
    with T.settings.override(relu_impl=relu_impl, grad_safe=True):
        got_k = apply_kernel(model, *args)
        got = torch.autograd.grad((got_k * ct).sum(), params)
        assert kernel_route == want_counts
        assert applied[{"residual": "relu", "diagonal": "box"}[leg]] > 0
        want_k = apply_kernel_reference(model, *args)
        want = torch.autograd.grad((want_k * ct).sum(), params)
    assert torch.equal(got_k, want_k)
    for (name, _), g, w in zip(model.named_parameters(), got, want):
        g, w = g.numpy(), w.numpy()
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-3), name


def test_autograd_functions_leave_inputs_without_grad(kernel_route):
    """Under no_grad, and where nothing requires a gradient, the launch
    goes straight to the kernel: no Function, no saved tensors."""
    model = _small_resnet(learnable=True)
    x = torch.rand(3, 2, 8, 8)
    with torch.no_grad():
        k = apply_kernel(model, x, x, True, False)
    assert k.grad_fn is None and kernel_route == SMALL_RESNET_LAUNCHES
    k = apply_kernel(_small_resnet(learnable=True).requires_grad_(False), x,
                     x, True, False)
    assert k.grad_fn is None and kernel_route == {
        name: 2 * n for name, n in SMALL_RESNET_LAUNCHES.items()}


RESNETS = ["mnist_as_tf", "mnist_as_tf_mini", "cifar10",
           "mnist_paper_residual_cnn_gp"]


@pytest.mark.parametrize("name", RESNETS + ["mnist_paper_convnet_gp"])
@pytest.mark.parametrize("diag", [False, True])
def test_apply_kernel_reference_equals_apply_kernel_on_cpu(name, diag):
    """On the CPU both walk the model on the plain versions: the same
    bits, for the four ResNet configs and the ConvNet, on a masked 3x4
    tile and on a diagonal."""
    cfg = configs.load(name)
    shape = configs.image_shape(cfg)
    r = np.random.RandomState(len(name))
    x = torch.from_numpy(r.rand(3, *shape).astype(np.float32))
    z = torch.from_numpy(r.rand(4 if not diag else 3, *shape).astype(
        np.float32))
    z[0] = x[2]
    mask = None if diag else torch.from_numpy(
        np.arange(3)[:, None] == 2 + np.arange(4)[None, :])
    with torch.no_grad():
        got = apply_kernel(cfg.initial_model, x, z, False, diag, mask)
        want = apply_kernel_reference(cfg.initial_model, x, z, False, diag,
                                      mask)
    assert got.shape == ((3,) if diag else (3, 4))
    assert torch.equal(got, want)


def test_launch_formula_matches_counted_launches(kernel_route):
    """chip_smoke.py's per-tile launch formula, read off the model tree
    with the fusion rules, against the launches counted on a mnist_as_tf
    tile through the CUDA route (stubbed), on a masked pair tile (the
    fused walk) and on a diagonal batch of one set (one box filter per
    Conv2d, no ReLU launch)."""
    model = configs.load("mnist_as_tf").initial_model
    want = {"box": 36, "prologue": 28, "epilogue": 15, "relu": 3}
    assert chip_smoke.layer_launches(model) == dict(want, adds=0)
    x = torch.rand(2, 1, 28, 28)
    with torch.no_grad():
        apply_kernel(model, x, x[:1], False, False, torch.tensor([[False],
                                                                  [True]]))
        assert kernel_route == want
        apply_kernel(model, x, x, True, True)
    assert kernel_route == dict(want, box=72)

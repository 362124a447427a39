"""The layer kernels' adjoints on the CPU (the fit's tile VJP): the plain
closed-form VJPs of the arccos ReLU (``arccos.relu_xy_vjp_reference``),
of the box filter (``boxfilter.box_filter_2d_vjp_reference``, and
``_vjp_reference`` with the leaf sums) and of the fused layer
(``layer.conv_layer_vjp_reference``) against ``jax.vjp`` of the JAX
package's ``_relu_xla`` and ``box_filter_2d`` and against autograd of the
port's plain forwards; whole-tile leaf gradients from the plain VJPs
against ``jax.grad`` of JAX's ``apply_kernel``; the adjoint kernels'
wrappers with a stubbed ``_lib``.  The kernels themselves are checked on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances.  The closed form of the ReLU's adjoint and autodiff of the
plain forward (JAX's or torch's) are two float32 evaluations of one
derivative: autodiff sums d sin/d xy and d theta/d xy, two terms of size
|cos theta| / sin theta that cancel, and takes the polynomial arccos's
own slope, so its error grows as |cos theta| nears 1, where the closed
form's does not.  So the comparisons with autodiff keep |cos theta| <=
COS_MAX = 0.98, and a float64 oracle holds the closed form to the same
RELU_VJP_TOL up to |cos theta| = 1 - 1e-4.  RELU_VJP_TOL (1e-5 of the
largest entry of each gradient) is the repo's kernel parity rule.  The
box filter's adjoint adds at most k^2
positive terms per pixel in another order than autodiff: 1e-6.  Leaf
gradients of a whole tile: 3e-3 of the leaf's largest entry, the bound
of tests/test_torch_fit.py's masked tile against JAX (the two packages'
forwards differ by float32 rounding through eight layers, and a tile's
gradient sums 10^4-10^5 such terms)."""

import copy
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.kernels import apply_kernel as japply
from cnn_gp_tpu.ops import arccos as jarc
from cnn_gp_tpu.ops import boxfilter as jbox
from cnn_gp_tpu_torch import fit as tfit
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.ops import arccos as tarc
from cnn_gp_tpu_torch.ops import boxfilter as tbox
from cnn_gp_tpu_torch.ops import layer as tlayer
from test_torch_layer_kernels import kernel_route

assert kernel_route   # the fixture, imported for this module's tests

jfit_paper = importlib.import_module("scripts.fit_paper_scale")

RELU_VJP_TOL = 1e-5
BOX_VJP_TOL = 1e-6
LEAF_TOL = 3e-3
COS_MAX = 0.98
ORACLE_COS_MAX = 1.0 - 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, and several test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().numpy()
    return np.asarray(a)


def _close(got, want, tol, name=""):
    got = _np(got).astype(np.float64)
    want = _np(want).astype(np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(),
                                                 1e-30), name


# -- the ReLU's adjoint -------------------------------------------------

# (name, nx, ny, same block (yy is xx), diagonal, mask kind)
RELU_CASES = [
    ("pair", 6, 9, False, False, None),
    ("masked", 6, 9, False, False, "global"),
    ("same block", 8, 8, True, False, None),
    ("same block masked", 8, 8, True, False, "eye"),
    ("diagonal", 7, 7, False, True, None),
]


def _relu_inputs(nx, ny, same, diag, mask_kind, seed, cos_max=COS_MAX):
    """Pre-ReLU maps with cosines in [-cos_max, cos_max], a positive
    cotangent and the mask, as numpy float32."""
    r = np.random.RandomState(seed)
    w, h = 4, 5
    xx = (r.rand(nx, w, h) + 0.2).astype(np.float32)
    yy = xx if same else (r.rand(ny, w, h) + 0.2).astype(np.float32)
    shape = (nx, w, h) if diag else (nx, ny, w, h)
    cos = r.uniform(-cos_max, cos_max, shape)
    flat = cos.reshape(-1)
    flat[0::7] = np.sign(flat[0::7]) * cos_max       # the range's ends
    scale = np.sqrt(xx * yy) if diag else np.sqrt(xx[:, None] * yy[None])
    xy = (cos * scale).astype(np.float32)
    g = (0.5 + r.rand(*shape)).astype(np.float32)
    mask = None
    if mask_kind == "global":
        mask = (3 + np.arange(nx))[:, None] == np.arange(ny)[None, :]
    elif mask_kind == "eye":
        mask = np.eye(nx, ny, dtype=bool)
    return xy, xx, yy, g, mask


def _torch_vjp(xy, xx, yy, g, mask, diag, same):
    t = [torch.from_numpy(a) for a in (xy, xx, g)]
    yy_t = t[1] if same else torch.from_numpy(yy)
    mask_t = None if mask is None else torch.from_numpy(mask)
    return tarc.relu_xy_vjp_reference(t[2], t[0], t[1], yy_t, mask_t, diag)


@pytest.mark.parametrize("case", RELU_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_relu_vjp_matches_jax(case, relu_impl, acos_impl):
    """relu_xy_vjp_reference against jax.vjp of _relu_xla's xy' map (under
    grad_safe) with respect to xy, xx and yy: both forms, both acos
    versions, pair and diagonal, masked, a same block (JAX's one xx
    argument then takes both side sums, as the port's g_xx does)."""
    _, nx, ny, same, diag, mask_kind = case
    xy, xx, yy, g, mask = _relu_inputs(nx, ny, same, diag, mask_kind,
                                       nx * 10 + ny)

    def f(xy_, xx_, yy_):
        kp = G.KernelPatch(xy_, xx_, xx_ if same else yy_, False, diag,
                           None if mask is None else jnp.asarray(mask))
        return jarc._relu_xla(kp).xy

    with jsettings.override(relu_impl=relu_impl, acos_impl=acos_impl,
                            grad_safe=True):
        _, pull = jax.vjp(f, jnp.asarray(xy), jnp.asarray(xx),
                          jnp.asarray(yy))
        want = pull(jnp.asarray(g))
    with T.settings.override(relu_impl=relu_impl, acos_impl=acos_impl):
        got = _torch_vjp(xy, xx, yy, g, mask, diag, same)
    if same:
        assert got[2] is None
        got = got[:2]
    for name, a, b in zip(("xy", "xx", "yy"), got, want):
        _close(a.numpy(), b, RELU_VJP_TOL, name)


@pytest.mark.parametrize("case", RELU_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_relu_vjp_matches_autograd(case, relu_impl, acos_impl):
    """relu_xy_vjp_reference against torch autograd through
    relu_xy_reference (grad_safe) over the same cases."""
    _, nx, ny, same, diag, mask_kind = case
    xy, xx, yy, g, mask = _relu_inputs(nx, ny, same, diag, mask_kind,
                                       nx * 10 + ny + 1)
    xy_t = torch.from_numpy(xy).requires_grad_()
    xx_t = torch.from_numpy(xx).requires_grad_()
    yy_t = xx_t if same else torch.from_numpy(yy).requires_grad_()
    mask_t = None if mask is None else torch.from_numpy(mask)
    leaves = [xy_t, xx_t] + ([] if same else [yy_t])
    with T.settings.override(relu_impl=relu_impl, acos_impl=acos_impl,
                             grad_safe=True):
        out = tarc.relu_xy_reference(xy_t, xx_t, yy_t, mask_t, diag)
        want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        got = _torch_vjp(xy, xx, yy, g, mask, diag, same)
    for name, a, b in zip(("xy", "xx", "yy"), got, want):
        _close(a.numpy(), b.numpy(), RELU_VJP_TOL, name)


@pytest.mark.parametrize("case", RELU_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_relu_vjp_near_unit_cosines_matches_float64(case, relu_impl,
                                                    acos_impl):
    """The closed form in float32 up to |cos theta| = 1 - 1e-4 against
    float64 autograd of the plain forward (the reference form, torch.acos)
    on the same float32 inputs, within RELU_VJP_TOL: near the unit cosine,
    where float32 autodiff loses digits, the closed form keeps them."""
    _, nx, ny, same, diag, mask_kind = case
    xy, xx, yy, g, mask = _relu_inputs(nx, ny, same, diag, mask_kind,
                                       nx * 10 + ny + 2, ORACLE_COS_MAX)
    xy_t = torch.from_numpy(xy).double().requires_grad_()
    xx_t = torch.from_numpy(xx).double().requires_grad_()
    yy_t = xx_t if same else torch.from_numpy(yy).double().requires_grad_()
    mask_t = None if mask is None else torch.from_numpy(mask)
    leaves = [xy_t, xx_t] + ([] if same else [yy_t])
    with T.settings.override(relu_impl="reference", acos_impl="exact",
                             grad_safe=True):
        out = tarc.relu_xy_reference(xy_t, xx_t, yy_t, mask_t, diag)
        want = torch.autograd.grad(out, leaves,
                                   torch.from_numpy(g).double())
    with T.settings.override(relu_impl=relu_impl, acos_impl=acos_impl):
        got = _torch_vjp(xy, xx, yy, g, mask, diag, same)
    for name, a, b in zip(("xy", "xx", "yy"), got, want):
        _close(a, b, RELU_VJP_TOL, name)


def test_relu_vjp_finite_at_clipped_cosines():
    """At |cos theta| = 1, where autograd of the plain forward is NaN or
    infinite, the closed form gives the limits: d/d xy = (pi - theta) /
    2 pi (1/2 at cos 1, 0 at cos -1), no side-map term."""
    # cos theta = xy / 4 exactly in both forms (rsqrt(4) = 0.5)
    xx = torch.full((2, 1, 1), 4.0)
    yy = torch.full((2, 1, 1), 4.0)
    xy = torch.tensor([[4.0, -4.0], [4.5, -4.5]]).view(2, 2, 1, 1)
    g = torch.ones(2, 2, 1, 1)
    for impl in ("fast", "reference"):
        with T.settings.override(relu_impl=impl):
            g_xy, g_xx, g_yy = tarc.relu_xy_vjp_reference(g, xy, xx, yy,
                                                          None, False)
        np.testing.assert_allclose(g_xy.view(2, 2).numpy(),
                                   [[0.5, 0.0], [0.5, 0.0]], atol=1e-6)
        np.testing.assert_allclose(g_xx.numpy(), 0.0, atol=1e-6)
        np.testing.assert_allclose(g_yy.numpy(), 0.0, atol=1e-6)


# -- the box filter's adjoint -------------------------------------------

# (k, stride, padding, dilation, map size): every Conv2d geometry of the
# configs (tests/test_torch_layer_kernels.py's BOX_CASES), the paper's k
# = 7 "same", stride 2 on an odd map and stride 3
BOX_CASES = [
    (3, 1, "same", 1, 28), (3, 1, "same", 1, 14), (3, 1, "same", 1, 7),
    (3, 1, "same", 1, 32), (3, 1, "same", 1, 16), (3, 1, "same", 1, 8),
    (3, 2, "same", 1, 28), (3, 2, "same", 1, 14), (3, 2, "same", 1, 32),
    (3, 2, "same", 1, 16), (1, 2, 0, 1, 28), (1, 2, 0, 1, 14),
    (1, 2, 0, 1, 32), (1, 2, 0, 1, 16), (1, 1, 0, 1, 28), (1, 1, 0, 1, 1),
    (7, 1, 0, 1, 7), (8, 1, 0, 1, 8), (4, 1, "same", 1, 28),
    (28, 1, 0, 1, 28), (3, 1, "same", 2, 28), (4, 1, "same", 2, 14),
    (7, 1, "same", 1, 28), (5, 2, "same", 1, 13), (2, 3, 1, 1, 11),
]


def _box_id(case):
    k, s, p, d, w = case
    return f"k{k}-s{s}-p{p}-d{d}-{w}x{w}"


@pytest.mark.parametrize("case", BOX_CASES, ids=_box_id)
def test_box_vjp_matches_jax(case):
    """box_filter_2d_vjp_reference against jax.vjp of JAX's box_filter_2d
    (its default lowering) on [b1, b2, W, H] and [b, W, H] maps."""
    k, s, p, d, w = case
    r = np.random.RandomState(k * 100 + w)
    for shape in ((3, 4, w, w), (5, w, w)):
        x = r.rand(*shape).astype(np.float32)
        out, pull = jax.vjp(lambda a: jbox.box_filter_2d(a, k, s, p, d),
                            jnp.asarray(x))
        g = (0.5 + r.rand(*out.shape)).astype(np.float32)
        (want,) = pull(jnp.asarray(g))
        got = tbox.box_filter_2d_vjp_reference(torch.from_numpy(g), (w, w),
                                               k, s, p, d)
        _close(got.numpy(), want, BOX_VJP_TOL)


@pytest.mark.parametrize("case", BOX_CASES, ids=_box_id)
def test_conv_maps_vjp_matches_autograd(case):
    """boxfilter._vjp_reference (the maps' cotangents, d scale = sum
    <box^T(g), a>, d bias = sum g) against autograd of
    conv_maps_reference with a learnable scale and bias, three fields."""
    k, s, p, d, w = case
    r = np.random.RandomState(k * 7 + w)
    maps = [torch.from_numpy(r.rand(*shape).astype(np.float32))
            .requires_grad_() for shape in ((3, 4, w, w), (3, w, w),
                                            (4, w, w))]
    scale = torch.tensor(2.79 / (k * k), requires_grad=True)
    bias = torch.tensor(0.5, requires_grad=True)
    outs = tbox.conv_maps_reference(maps, k, s, p, d, scale, bias)
    grads = [torch.from_numpy((0.5 + r.rand(*o.shape)).astype(np.float32))
             for o in outs]
    want = torch.autograd.grad(outs, maps + [scale, bias], grads)
    g_maps, d_scale, d_bias = tbox._vjp_reference(
        tbox.Geometry.of(k, s, p, d), grads, [m.detach() for m in maps],
        [tbox.AS_IS] * 3, [True] * 3, scale.detach(), True)
    for a, b in zip(g_maps, want[:3]):
        _close(a.numpy(), b.numpy(), BOX_VJP_TOL)
    _close(d_scale.numpy(), want[3].numpy(), RELU_VJP_TOL, "scale")
    _close(d_bias.numpy(), want[4].numpy(), RELU_VJP_TOL, "bias")


# -- the fused layer's adjoint ------------------------------------------

# (k, stride, padding, map size) of the fused layer's checks
LAYER_GEOMETRIES = [(3, 1, "same", 8), (3, 2, "same", 8), (1, 2, 0, 8),
                    (7, 1, "same", 7), (4, 1, "same", 6), (6, 1, 0, 6)]


def _layer_inputs(r, nx, ny, w, wo, same, masked, skip, yy_is_xx):
    xx = torch.from_numpy((r.rand(nx, w, w) + 0.2).astype(np.float32))
    yy = xx if yy_is_xx else torch.from_numpy(
        (r.rand(ny, w, w) + 0.2).astype(np.float32))
    cos = r.uniform(-COS_MAX, COS_MAX, (nx, ny, w, w))
    xy = torch.from_numpy((cos * np.sqrt(xx[:, None].numpy()
                                         * yy[None].numpy())).astype(
                                             np.float32))
    mask = (torch.arange(nx)[:, None] == torch.arange(ny)[None] + 1
            if masked else None)
    kp = T.KernelPatch(xy, xx, yy, same, False, mask)
    sk = None
    if skip:
        s_xx = torch.from_numpy(r.rand(nx, wo, wo).astype(np.float32))
        sk = T.KernelPatch(
            torch.from_numpy(r.rand(nx, ny, wo, wo).astype(np.float32)),
            s_xx, s_xx if same else torch.from_numpy(
                r.rand(ny, wo, wo).astype(np.float32)), same, False, mask)
    return kp, sk


LAYER_FORMS = [(relu, skip, same) for relu in (False, True)
               for skip in (False, True) for same in (False, True)]


@pytest.mark.parametrize("geom", LAYER_GEOMETRIES,
                         ids=lambda g: f"k{g[0]}-s{g[1]}-p{g[2]}-{g[3]}")
@pytest.mark.parametrize("relu,skip,same", LAYER_FORMS)
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_conv_layer_vjp_matches_autograd(geom, relu, skip, same,
                                         relu_impl):
    """conv_layer_vjp_reference against autograd of conv_layer_reference
    (grad_safe, masked where the ReLU runs on a block of one set): the
    gradients of the scale, the bias, the input patch's fields and the
    skip's; with and without the ReLU and the skip, pair blocks and
    blocks of one set (yy is xx)."""
    k, s, p, w = geom
    conv = T.Conv2d(k, stride=s, padding=p, var_weight=2.79, var_bias=0.5,
                    learnable=True)
    wo = tbox.Geometry.of(k, s, conv.pad_lo_hi).out_shape(w, w)[0]
    r = np.random.RandomState(k * 31 + w + 2 * relu + skip)
    ny = 4 if same else 5
    kp, sk = _layer_inputs(r, 4, ny, w, wo, same, relu and same, skip,
                           yy_is_xx=same)
    leaves_kp = [kp.xy.requires_grad_(), kp.xx.requires_grad_()] + (
        [] if kp.yy is kp.xx else [kp.yy.requires_grad_()])
    leaves_sk = [] if sk is None else [sk.xy.requires_grad_(),
                                       sk.xx.requires_grad_()] + (
        [] if sk.yy is sk.xx else [sk.yy.requires_grad_()])
    with T.settings.override(relu_impl=relu_impl, grad_safe=True):
        out = tlayer.conv_layer_reference(kp, conv, relu, sk)
        outs = [out.xy, out.xx] + ([] if out.yy is out.xx else [out.yy])
        grads = [torch.from_numpy((0.5 + r.rand(*o.shape)).astype(
            np.float32)) for o in outs]
        want = torch.autograd.grad(
            outs, [conv.var_weight, conv.var_bias] + leaves_kp + leaves_sk,
            grads)
        # the layer's distinct outputs: the plain chain's skip add makes
        # yy' a tensor of its own even where the layer has yy' = xx'
        if tlayer._spec(kp, conv, relu, sk).n_out < len(outs):
            grads = [grads[0], grads[1] + grads[2]]
        xx_d = kp.xx.detach()
        d_scale, d_bias, g_kp, g_sk = tlayer.conv_layer_vjp_reference(
            T.KernelPatch(kp.xy.detach(), xx_d,
                          xx_d if kp.yy is kp.xx else kp.yy.detach(), same,
                          False, kp.diag_mask), conv, relu, sk, grads)
    # the layer's scale is var_weight / k^2
    _close(_np(d_scale) / (k * k), want[0], RELU_VJP_TOL, "scale")
    _close(d_bias, want[1], RELU_VJP_TOL, "bias")
    got_kp = [g for g in g_kp if g is not None]
    assert len(got_kp) == len(leaves_kp)
    for name, a, b in zip(("xy", "xx", "yy"), got_kp,
                          want[2:2 + len(leaves_kp)]):
        _close(a, b, RELU_VJP_TOL, name)
    got_sk = [g for g in g_sk if g is not None]
    assert len(got_sk) == len(leaves_sk)
    for a, b in zip(got_sk, want[2 + len(leaves_kp):]):
        _close(a, b, 0.0)


def test_conv_layer_vjp_refuses_a_masked_relu_without_grad_safe():
    """A masked ReLU's adjoint needs grad_safe in the forward, whose
    plain gradient is NaN otherwise: the plain VJP raises, naming it."""
    r = np.random.RandomState(0)
    kp, _ = _layer_inputs(r, 4, 4, 8, 8, True, True, False, True)
    grads = [torch.ones(4, 4, 8, 8), torch.ones(4, 8, 8)]
    with pytest.raises(ValueError, match="grad_safe"):
        tlayer.conv_layer_vjp_reference(kp, T.Conv2d(3), True, None, grads)


# -- whole tiles: leaf gradients from the plain VJPs against JAX ------------

def _jax_small_resnet():
    """The small learnable ResNet with a Mixture of
    tests/test_torch_cuda.py's layer-kernel VJP test."""
    def conv(k, **kw):
        return G.Conv2d(k, var_weight=1.7, var_bias=0.3, learnable=True,
                        **kw)
    return G.Sequential(
        conv(3), G.Sequential(G.ReLU(), G.Sum([
            conv(1, stride=2, padding=0),
            G.Sequential(conv(3, stride=2), G.ReLU(), conv(3))])),
        G.Sum([G.Sequential(), G.Sequential(conv(3), G.ReLU())]),
        G.Mixture([G.Sequential(), G.Sequential(G.ReLU(), conv(3))]),
        G.ReLU(), conv(7, padding=0))


# (name, JAX model, image shape, tile rows, tile columns, rows' offset)
TILE_MODELS = {
    "paper ConvNet": (lambda: jfit_paper.paper_convnet(1.0, 1.0,
                                                       learnable=True),
                      (1, 28, 28), 5, 6, 3),
    "small ResNet": (_jax_small_resnet, (1, 14, 14), 6, 9, 3),
}


def _jax_grads(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", sorted(TILE_MODELS))
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_tile_leaf_gradients_match_jax(kernel_route, name, relu_impl):
    """A masked tile's leaf gradients by fit._tile_vjp_sweep, its backward
    composed of the plain VJPs (the adjoint launches stubbed by them, as
    the card's backward composes the kernels), against jax.grad of JAX's
    apply_kernel on the same tile, within LEAF_TOL per leaf; the backward
    launched the adjoints as chip_smoke.vjp_launches counts them."""
    make, shape, bi, bj, off = TILE_MODELS[name]
    r = np.random.RandomState(len(name))
    x = r.rand(off + bi, *shape).astype(np.float32)
    ct = (0.5 + r.rand(bi, bj)).astype(np.float32)
    jmodel = make()
    model = from_jax_model(jmodel)
    before = (tbox.vjp_launches, tarc.vjp_launches)
    with T.settings.override(relu_impl=relu_impl):
        got = tfit._tile_vjp_sweep(
            model, torch.from_numpy(x), [(off, 0, 1.0)],
            lambda *a: torch.from_numpy(ct), max(bi, bj))
    n = chip_smoke.vjp_launches(model)
    assert (tbox.vjp_launches - before[0], tarc.vjp_launches - before[1]) \
        == (n["box_vjp"], n["relu_vjp"])
    rows, cols = off + np.arange(bi), np.arange(bj)
    mask = jnp.asarray(rows[:, None] == cols[None, :])

    def tile_loss(m):
        return jnp.sum(jnp.asarray(ct) * japply(
            m, jnp.asarray(x[off:off + bi]), jnp.asarray(x[:bj]), False,
            False, mask))
    with jsettings.override(grad_safe=True, relu_impl=relu_impl):
        want = _jax_grads(jax.grad(tile_loss)(jmodel))
    assert sorted(got) == sorted(want) and len(got) == {
        "paper ConvNet": 16, "small ResNet": 15}[name]
    for k in want:
        _close(got[k], want[k], LEAF_TOL, k)


def test_vjp_launch_formula(kernel_route):
    """chip_smoke.vjp_launches on the paper ConvNet (8 box-filter adjoints,
    7 ReLU adjoints) and a ResNet config made learnable, against the
    launches counted through the stubbed route."""
    paper = from_jax_model(jfit_paper.paper_convnet(1.0, 1.0,
                                                    learnable=True))
    assert chip_smoke.vjp_launches(paper) == {"box_vjp": 8, "relu_vjp": 7}
    model = copy.deepcopy(T.configs.load("mnist_as_tf_mini").initial_model)
    for m in model.modules():
        if isinstance(m, T.Conv2d):
            m.learnable = True
            m.var_weight = torch.nn.Parameter(torch.tensor(m.var_weight))
            m.var_bias = torch.nn.Parameter(torch.tensor(m.var_bias))
    x = torch.rand(3, 1, 28, 28)
    before = (tbox.vjp_launches, tarc.vjp_launches)
    tfit._tile_vjp_sweep(model, x, [(1, 0, 1.0)], lambda *a: torch.ones(2, 3),
                         3)
    n = chip_smoke.vjp_launches(model)
    assert (tbox.vjp_launches - before[0], tarc.vjp_launches - before[1]) \
        == (n["box_vjp"], n["relu_vjp"])


# -- the CUDA wrappers with a stubbed library -----------------------------

class _FakeVjpLibs:
    """Records the adjoint entry points' calls; the scratch queries give
    fixed sizes."""

    def __init__(self, error=0):
        self.box, self.relu, self.error = [], [], error

    def cnn_gp_box_filter_vjp(self, *args):
        self.box.append(args)
        return self.error

    def cnn_gp_box_filter_vjp_partials(self, w, h, wo, ho, device, out):
        out._obj.value = 2 * 132
        return 0

    def cnn_gp_relu_vjp(self, *args):
        self.relu.append(args)
        return self.error

    def cnn_gp_relu_vjp_scratch(self, b1, b2, s, mode, device, out):
        out._obj.value = 0 if mode == tarc.DIAGONAL else 1000
        return 0

    def error_string(self, code):
        return "stub error"


@pytest.fixture()
def libs(monkeypatch):
    fake = _FakeVjpLibs()
    monkeypatch.setattr(tbox, "_lib", fake)
    monkeypatch.setattr(tarc, "_lib", fake)

    def plain(*a, **k):
        raise AssertionError("the CUDA route called a plain version")
    for name in ("box_filter_2d_vjp_reference", "_vjp_reference"):
        monkeypatch.setattr(tbox, name, plain)
    for name in ("relu_xy_vjp_reference", "_vjp_reference",
                 "relu_xy_reference"):
        monkeypatch.setattr(tarc, name, plain)
    return fake


def test_box_vjp_wrapper_passes_pointers_and_counts(libs):
    """One launch for three maps: each (cotangent, input, output, planes,
    mode) slot, no output where none is wanted, the geometry, the scale,
    the two leaf sums and the partials sized by the library's query."""
    geom = tbox.Geometry.of(3, 2, "same", 1)
    maps = [torch.zeros(5, 6, 28, 28), torch.zeros(5, 28, 28),
            torch.zeros(6, 28, 28)]
    grads = [torch.zeros(*m.shape[:-2], 14, 14) for m in maps]
    scale = torch.tensor(0.31)
    before = tbox.vjp_launches
    outs, dscale, dbias = tbox._launch_vjp(
        geom, grads, maps, [tbox.RELU, tbox.HALF, tbox.HALF],
        [True, False, True], scale, True, 7)
    assert tbox.vjp_launches == before + 1
    (args,) = libs.box
    assert args[0:5] == (grads[0].data_ptr(), maps[0].data_ptr(),
                         outs[0].data_ptr(), 30, tbox.RELU)
    assert args[5:10] == (grads[1].data_ptr(), maps[1].data_ptr(), None, 5,
                          tbox.HALF)
    assert args[10:15] == (grads[2].data_ptr(), maps[2].data_ptr(),
                           outs[2].data_ptr(), 6, tbox.HALF)
    assert args[15:23] == (28, 28, 14, 14, 3, 2, 1, 1)
    assert args[23] == pytest.approx(0.31) and args[24] is None
    assert args[25] == 1
    assert args[26:28] == (dscale.data_ptr(), dbias.data_ptr())
    assert args[28] is not None and args[30] == 7
    assert outs[1] is None
    assert [tuple(o.shape) for o in (outs[0], outs[2])] == [
        (5, 6, 28, 28), (6, 28, 28)]
    assert dscale.shape == dbias.shape == ()


def test_box_vjp_wrapper_without_leaves_or_scale(libs):
    """box_filter_2d's adjoint (no scale: affine 0) asks no leaf sums and
    passes no partials."""
    geom = tbox.Geometry.of(7, 1, 0, 1)
    (out,), dscale, dbias = tbox._launch_vjp(
        geom, [torch.zeros(4, 1, 1)], [torch.zeros(4, 7, 7)], [tbox.AS_IS],
        [True], None, False, 0)
    args = libs.box[-1]
    assert args[3] == 4 and args[5:15] == (None, None, None, 0,
                                           tbox.AS_IS) * 2
    assert args[25] == 0 and args[26:29] == (None, None, None)
    assert dscale is None and dbias is None and out.shape == (4, 7, 7)


def test_box_vjp_wrapper_raises(libs, monkeypatch):
    geom = tbox.Geometry.of(3, 1, "same", 1)
    with pytest.raises(ValueError, match="takes a cotangent"):
        tbox._launch_vjp(geom, [torch.zeros(2, 7, 7)], [torch.zeros(2, 8, 8)],
                         [tbox.AS_IS], [True], 1.0, False, 0)
    with pytest.raises(ValueError, match="float32"):
        tbox._launch_vjp(geom, [torch.zeros(2, 8, 8, dtype=torch.float64)],
                         [torch.zeros(2, 8, 8)], [tbox.AS_IS], [True], 1.0,
                         False, 0)
    monkeypatch.setattr(tbox, "_lib", _FakeVjpLibs(error=700))
    before = tbox.vjp_launches
    with pytest.raises(RuntimeError, match="cuda error 700"):
        tbox._launch_vjp(geom, [torch.zeros(2, 8, 8)], [torch.zeros(2, 8, 8)],
                         [tbox.AS_IS], [True], 1.0, True, 0)
    assert tbox.vjp_launches == before


@pytest.mark.parametrize("mode", [tarc.PAIR_FAST, tarc.PAIR_REFERENCE,
                                  tarc.DIAGONAL])
@pytest.mark.parametrize("exact", [0, 1])
def test_relu_vjp_wrapper_passes_pointers_and_counts(libs, mode, exact):
    """One launch: the cotangent, maps, mask bytes, outputs, the
    accumulators, the scratch, the dot, the cotangent's scale on the card,
    sizes, mode and acos version."""
    diag = mode == tarc.DIAGONAL
    if diag:
        xy, xx, yy = (torch.zeros(5, 4, 3) for _ in range(3))
        mask, acc, dot = None, None, None
    else:
        xy = torch.zeros(5, 6, 4, 3)
        xx, yy = torch.zeros(5, 4, 3), torch.zeros(6, 4, 3)
        mask = torch.zeros(5, 6, dtype=torch.bool)
        acc, dot = torch.zeros(5, 4, 3), torch.zeros(())
    t = torch.zeros(xy.shape)
    gscale = torch.tensor(0.5)
    before = tarc.vjp_launches
    outs = tarc._launch_vjp(t, xy, xx, yy, mask, mode, exact, gscale,
                            (True, True, True), acc, None, dot, 3)
    assert tarc.vjp_launches == before + 1
    (args,) = libs.relu
    assert args[:5] == (t.data_ptr(), xy.data_ptr(), xx.data_ptr(),
                        yy.data_ptr(), None if mask is None
                        else mask.data_ptr())
    assert args[5:8] == tuple(o.data_ptr() for o in outs)
    assert args[8:10] == (None if acc is None else acc.data_ptr(), None)
    assert args[11] == (None if dot is None else dot.data_ptr())
    assert args[12:14] == (0.5, None)
    assert args[14:21] == ((5, 1, 12) if diag else (5, 6, 12)) + (
        mode, exact, None, 3)
    assert [o.shape for o in outs] == [xy.shape, xx.shape, yy.shape]


@pytest.mark.parametrize("view", [False, True])
def test_relu_vjp_wrapper_one_side(libs, view):
    """When yy is xx both side sums go to g_xx: no g_yy pointer, and an
    accumulator of yy's is merged into xx's before the launch.  A
    non-contiguous xx is copied once and passed as both sides, so the
    kernel too sees a same block."""
    xx = torch.zeros(4, 3, 3)
    if view:
        xx = xx.transpose(1, 2)
    acc_x, acc_y = torch.ones(4, 3, 3), torch.full((4, 3, 3), 2.0)
    copies = tarc.copies
    g_xy, g_xx, g_yy = tarc._launch_vjp(
        torch.zeros(4, 4, 3, 3), torch.zeros(4, 4, 3, 3), xx, xx, None,
        tarc.PAIR_FAST, 0, None, (True, True, True), acc_x, acc_y, None, 0)
    args = libs.relu[-1]
    assert g_yy is None and args[7] is None and args[9] is None
    assert args[8] not in (None, acc_x.data_ptr(), acc_y.data_ptr())
    assert args[12:14] == (1.0, None)
    assert args[2] == args[3]
    assert (args[2] == xx.data_ptr()) == (not view)
    assert tarc.copies - copies == int(view)


def test_vjp_scratch_sizes_asked_once(libs, monkeypatch):
    """The scratch and partials sizes are asked of the library once per
    sizes and device, and again for another library."""
    asked = []
    for name in ("cnn_gp_box_filter_vjp_partials", "cnn_gp_relu_vjp_scratch"):
        def query(*a, _fn=getattr(libs, name), _name=name):
            asked.append(_name)
            return _fn(*a)
        monkeypatch.setattr(libs, name, query, raising=False)
    cpu = torch.device("cpu")
    for _ in range(3):
        assert tbox.vjp_partials(8, 8, 4, 4, cpu) == 2 * 132
        assert tarc.vjp_scratch(2, 3, 4, tarc.PAIR_FAST, cpu) == 1000
    assert tarc.vjp_scratch(2, 3, 5, tarc.PAIR_FAST, cpu) == 1000
    assert asked == ["cnn_gp_box_filter_vjp_partials",
                     "cnn_gp_relu_vjp_scratch", "cnn_gp_relu_vjp_scratch"]
    other = _FakeVjpLibs()
    monkeypatch.setattr(tbox, "_lib", other)
    monkeypatch.setattr(other, "cnn_gp_box_filter_vjp_partials",
                        lambda *a: asked.append("other") or 0,
                        raising=False)
    tbox.vjp_partials(8, 8, 4, 4, cpu)
    assert asked[-1] == "other"


def test_relu_vjp_wrapper_raises(libs, monkeypatch):
    xy, xx, yy = torch.zeros(2, 3, 4, 4), torch.zeros(2, 4, 4), torch.zeros(
        3, 4, 4)
    with pytest.raises(ValueError, match="pair mode"):
        tarc._launch_vjp(xy, xy, yy, xx, None, tarc.PAIR_FAST, 0, None,
                         (True,) * 3, None, None, None, 0)
    with pytest.raises(ValueError, match="diagonal mode takes no mask"):
        tarc._launch_vjp(xy[:, 0], xy[:, 0], xx, xx,
                         torch.zeros(2, 2, dtype=torch.bool), tarc.DIAGONAL,
                         0, None, (True,) * 3, None, None, None, 0)
    monkeypatch.setattr(tarc, "_lib", _FakeVjpLibs(error=9))
    before = tarc.vjp_launches
    with pytest.raises(RuntimeError, match="cuda error 9"):
        tarc._launch_vjp(xy, xy, xx, yy, None, tarc.PAIR_FAST, 0, None,
                         (True,) * 3, None, None, None, 0)
    assert tarc.vjp_launches == before


@pytest.mark.parametrize("grad_safe", [False, True])
def test_masked_relu_backward_needs_grad_safe(monkeypatch, grad_safe):
    """The ReLU's Function and the fused layer's refuse a masked pair
    map's backward when the forward ran without grad_safe (ValueError
    naming it), and launch the adjoints (a stubbed library) when it ran
    with it."""
    fake = _FakeVjpLibs()
    monkeypatch.setattr(tbox, "_lib", fake)
    monkeypatch.setattr(tarc, "_lib", fake)
    from test_torch_layer_kernels import _plain_layer_launch

    # the forward launches by the plain forward, the backward's by the
    # wrappers on the stubbed library
    def relu_launch(xy, xx, yy, mask, mode, exact, stream):
        with torch.no_grad():
            return tarc.relu_xy_reference(xy, xx, yy, mask,
                                          mode == tarc.DIAGONAL)

    def layer_launch(geom, maps, prologues, skips, side, scale, bias,
                     stream):
        with torch.no_grad():
            return _plain_layer_launch(geom, maps, prologues, skips, side,
                                       scale, bias)
    monkeypatch.setattr(tarc, "_launch", relu_launch)
    monkeypatch.setattr(tbox, "_launch_layer", layer_launch)
    r = np.random.RandomState(1)
    kp, _ = _layer_inputs(r, 3, 3, 6, 6, False, True, False, False)
    kp = T.KernelPatch(kp.xy.requires_grad_(), kp.xx, kp.yy, False, False,
                       kp.diag_mask)
    conv = T.Conv2d(3, learnable=True)
    with T.settings.override(grad_safe=grad_safe):
        relu_out = tarc._route(kp.xy, kp.xx, kp.yy, kp.diag_mask, False, 0)
        layer_out = tlayer._route(kp, conv, True, None, 0)
    before = (tarc.vjp_launches, tbox.vjp_launches)
    for out in (relu_out, layer_out.xy):
        if grad_safe:
            torch.autograd.grad(out.sum(), kp.xy)
        else:
            with pytest.raises(ValueError, match="grad_safe"):
                torch.autograd.grad(out.sum(), kp.xy)
    assert tarc.vjp_launches - before[0] == (2 if grad_safe else 0)
    assert tbox.vjp_launches - before[1] == 1


def test_cpu_tensors_never_enter_the_functions(monkeypatch):
    """A CPU tensor takes the plain forward and plain autograd: none of
    the three Functions is applied and no adjoint launches."""
    for fn in (tarc._ReluXY, tbox._ConvMaps, tlayer._ConvLayer):
        def refuse(*a, **k):
            raise AssertionError("a CPU tensor entered a Function")
        monkeypatch.setattr(fn, "apply", refuse)
    before = (tbox.vjp_launches, tarc.vjp_launches)
    model = from_jax_model(_jax_small_resnet())
    x = torch.rand(4, 1, 14, 14)
    with T.settings.override(grad_safe=True):
        k = T.apply_kernel(model, x, x, False, False, torch.eye(4).bool())
        grads = torch.autograd.grad(k.sum(), list(model.parameters()))
        kd = T.apply_kernel(model, x, x, True, True)
        torch.autograd.grad(kd.sum(), list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert (tbox.vjp_launches, tarc.vjp_launches) == before


def test_cuda_backward_without_a_kernel_raises(monkeypatch, tmp_path):
    """The adjoints on a CUDA tensor with no kernel to build (no nvcc)
    raise; nothing falls back to a plain version."""
    from cnn_gp_tpu_torch.ops import cuda_lib
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(tarc, "_lib", None)
    monkeypatch.setattr(tbox, "_lib", None)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tarc.vjp_scratch(2, 2, 4, tarc.PAIR_FAST, card.device)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tbox.vjp_partials(8, 8, 8, 8, card.device)

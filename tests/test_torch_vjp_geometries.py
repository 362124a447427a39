"""The adjoints' plain versions at every geometry and map size that their
CUDA kernels specialise (csrc/boxfilter_vjp.cu's kFixedGeometries,
csrc/arccos_vjp.cu's map sizes), against ``jax.vjp`` of the JAX
package's ``box_filter_2d`` and ``_relu_xla``; the kernels' tables read
from their sources, so every specialisation is covered here; and the
box filter's adjoint wrapper's ``runtime_geometry`` switch through a
stubbed library.  The kernels themselves are held bit for bit against
these plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` (phase 3c).

Tolerances are those of ``tests/test_torch_layer_vjp.py``: the box
filter's adjoint adds at most k^2 positive terms per pixel in another
order than autodiff (1e-6 of the largest entry); the ReLU's closed form
against autodiff at |cos theta| <= 0.98, 1e-5 of each gradient's largest
entry."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.ops import arccos as jarc
from cnn_gp_tpu.ops import boxfilter as jbox
from cnn_gp_tpu_torch.ops import arccos as tarc
from cnn_gp_tpu_torch.ops import boxfilter as tbox
from test_torch_layer_vjp import (BOX_VJP_TOL, COS_MAX, RELU_VJP_TOL,
                                  _FakeVjpLibs, _close)

CSRC = os.path.join(os.path.dirname(tbox.__file__), os.pardir, "csrc")

# (k, stride, padding, map side) of every fixed geometry of the box
# filter's adjoint: the ResNet configs' (mnist_as_tf at 28/14/7, cifar10 at
# 32/16/8, the residual config's even kernel), the paper ConvNet's k = 7
# and its 28x28 readout
FIXED = [
    (3, 1, "same", 28), (1, 1, 0, 28), (1, 2, 0, 28), (3, 2, "same", 28),
    (4, 1, "same", 28), (7, 1, "same", 28), (28, 1, 0, 28),
    (3, 1, "same", 14), (1, 2, 0, 14), (3, 2, "same", 14),
    (3, 1, "same", 7), (7, 1, 0, 7),
    (3, 1, "same", 32), (1, 1, 0, 32), (1, 2, 0, 32), (3, 2, "same", 32),
    (3, 1, "same", 16), (1, 2, 0, 16), (3, 2, "same", 16),
    (3, 1, "same", 8), (8, 1, 0, 8),
]
# map sides whose pair maps the ReLU's adjoint specialises
RELU_SIDES = (28, 14, 7, 32, 16, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geometry_id(case):
    k, s, p, w = case
    return f"k{k}-s{s}-p{p}-{w}x{w}"


def _table(name: str, array: str):
    """The (map side, k, stride, lo, output side) rows of a geometry table
    in csrc/<name>."""
    with open(os.path.join(CSRC, name)) as f:
        src = f.read()
    body = src[src.index(f"constexpr Fixed {array}[]"):]
    body = body[:body.index("};")]
    return {tuple(int(v) for v in row) for row in re.findall(
        r"\{(\d+), (\d+), (\d+), (\d+), (\d+),", body)}


def test_fixed_geometries_are_the_kernels_table():
    """FIXED is the adjoint kernel's table, which holds every row of the
    forward's and the paper ConvNet's readout besides."""
    want = set()
    for k, s, p, w in FIXED:
        geom = tbox.Geometry.of(k, s, p, 1)
        want.add((w, k, s, geom.pad[0], geom.out_shape(w, w)[0]))
    vjp = _table("boxfilter_vjp.cu", "kFixedGeometries")
    forward = _table("boxfilter.cu", "kFixedGeometries")
    assert vjp == want
    assert vjp - forward == {(28, 28, 1, 0, 1)}


def test_forward_fixed_geometries_are_the_kernels_table():
    """boxfilter.FIXED_GEOMETRIES, which relu_run_launches reads, is the
    forward kernel's table of template instantiations."""
    assert tbox.FIXED_GEOMETRIES == _table("boxfilter.cu",
                                           "kFixedGeometries")


def test_relu_sizes_are_the_kernels_sizes():
    """The map sizes with an instantiation of their own in the ReLU's
    adjoint are the squares of RELU_SIDES."""
    with open(os.path.join(CSRC, "arccos_vjp.cu")) as f:
        src = f.read()
    body = src[src.index("const void* pick_size(int S, bool vec)"):]
    body = body[:body.index("\n}\n")]
    sizes = {int(v) for v in re.findall(r"case (\d+):", body)}
    sizes |= {int(v) for v in re.findall(r"S == (\d+)", body)}
    assert sizes == {s * s for s in RELU_SIDES}


@pytest.mark.parametrize("case", FIXED, ids=_geometry_id)
def test_box_vjp_reference_matches_jax_at_fixed_geometry(case):
    """box_filter_2d_vjp_reference against jax.vjp of JAX's box_filter_2d
    (its default lowering) on [b1, b2, W, H] and [b, W, H] maps."""
    k, s, p, w = case
    r = np.random.RandomState(k * 1000 + s * 100 + w)
    for shape in ((3, 4, w, w), (5, w, w)):
        x = r.rand(*shape).astype(np.float32)
        out, pull = jax.vjp(lambda a: jbox.box_filter_2d(a, k, s, p, 1),
                            jnp.asarray(x))
        g = (0.5 + r.rand(*out.shape)).astype(np.float32)
        (want,) = pull(jnp.asarray(g))
        got = tbox.box_filter_2d_vjp_reference(torch.from_numpy(g), (w, w),
                                               k, s, p, 1)
        _close(got.numpy(), want, BOX_VJP_TOL)


@pytest.mark.parametrize("case", FIXED, ids=_geometry_id)
def test_box_vjp_launch_sums_match_autograd_at_fixed_geometry(case):
    """_vjp_reference (what one launch computes: three maps' cotangents,
    the side maps halved behind a ReLU, d scale and d bias) against
    autograd of the plain forward with a learnable scale and bias."""
    k, s, p, w = case
    r = np.random.RandomState(k * 7 + s * 3 + w)
    maps = [torch.from_numpy(r.rand(*shape).astype(np.float32))
            .requires_grad_() for shape in ((3, 4, w, w), (3, w, w),
                                            (4, w, w))]
    scale = torch.tensor(2.79 / (k * k), requires_grad=True)
    bias = torch.tensor(0.5, requires_grad=True)
    halved = [maps[0]] + [m * 0.5 for m in maps[1:]]
    outs = tbox.conv_maps_reference(halved, k, s, p, 1, scale, bias)
    grads = [torch.from_numpy((0.5 + r.rand(*o.shape)).astype(np.float32))
             for o in outs]
    want = torch.autograd.grad(outs, maps + [scale, bias], grads)
    g_maps, d_scale, d_bias = tbox._vjp_reference(
        tbox.Geometry.of(k, s, p, 1), grads, [m.detach() for m in maps],
        [tbox.AS_IS, tbox.HALF, tbox.HALF], [True] * 3, scale.detach(),
        True)
    for a, b in zip(g_maps, want[:3]):
        _close(a.numpy(), b.numpy(), BOX_VJP_TOL)
    _close(d_scale.numpy(), want[3].numpy(), RELU_VJP_TOL, "scale")
    _close(d_bias.numpy(), want[4].numpy(), RELU_VJP_TOL, "bias")


def _relu_inputs(side, nx, ny, same, masked, seed):
    """Pre-ReLU side maps of side x side, a pair map with cosines in
    [-COS_MAX, COS_MAX] (the ends included), a positive cotangent and the
    mask (a same block's is its diagonal, as in a fit), as numpy float32."""
    r = np.random.RandomState(seed)
    xx = (r.rand(nx, side, side) + 0.2).astype(np.float32)
    yy = xx if same else (r.rand(ny, side, side) + 0.2).astype(np.float32)
    cos = r.uniform(-COS_MAX, COS_MAX, (nx, ny, side, side))
    flat = cos.reshape(-1)
    flat[0::7] = np.sign(flat[0::7]) * COS_MAX
    xy = (cos * np.sqrt(xx[:, None] * yy[None])).astype(np.float32)
    g = (0.5 + r.rand(*xy.shape)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.eye(nx, ny, dtype=bool) if same else
                (2 + np.arange(nx))[:, None] == np.arange(ny)[None, :])
    return xy, xx, yy, g, mask


@pytest.mark.parametrize("side", [28, 14, 7])
@pytest.mark.parametrize("kind", ["masked", "same block",
                                  "same block masked"])
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_relu_vjp_reference_matches_jax_at_map_size(side, kind, relu_impl):
    """relu_xy_vjp_reference against jax.vjp of _relu_xla's xy' map under
    grad_safe, at the ResNet configs' map sizes: a masked pair block and a
    same block (JAX's one xx argument then takes both side sums, as the
    port's g_xx does), masked on its diagonal or not."""
    same, masked = kind.startswith("same"), kind.endswith("masked")
    nx, ny = (5, 5) if same else (4, 6)
    xy, xx, yy, g, mask = _relu_inputs(side, nx, ny, same, masked,
                                       side * 10 + nx + masked)

    def f(xy_, xx_, yy_):
        kp = G.KernelPatch(xy_, xx_, xx_ if same else yy_, False, False,
                           None if mask is None else jnp.asarray(mask))
        return jarc._relu_xla(kp).xy

    with jsettings.override(relu_impl=relu_impl, acos_impl="poly",
                            grad_safe=True):
        _, pull = jax.vjp(f, jnp.asarray(xy), jnp.asarray(xx),
                          jnp.asarray(yy))
        want = pull(jnp.asarray(g))
    xx_t = torch.from_numpy(xx)
    with T.settings.override(relu_impl=relu_impl, acos_impl="poly"):
        got = tarc.relu_xy_vjp_reference(
            torch.from_numpy(g), torch.from_numpy(xy), xx_t,
            xx_t if same else torch.from_numpy(yy),
            None if mask is None else torch.from_numpy(mask), False)
    if same:
        assert got[2] is None
        got = got[:2]
    for name, a, b in zip(("xy", "xx", "yy"), got, want):
        _close(a.numpy(), b, RELU_VJP_TOL, name)


def test_box_vjp_bound_of_the_readout():
    """chip_smoke's bound of the readout adjoint (28x28 -> 1x1) on a
    128x128 tile and its side maps: bytes (each g read, each input read
    and each cotangent written once), the passes' adds besides."""
    geom = tbox.Geometry.of(28, 1, 0, 1)
    planes = 128 * 128 + 2 * 128
    ms, by = chip_smoke.box_vjp_bound(geom, planes, 28, 28)
    assert by == "bytes"
    assert ms == pytest.approx(4 * planes * (2 * 784 + 1)
                               / chip_smoke.HBM_RATE * 1e3)


# -- the box filter's adjoint wrapper with a stubbed library -------------

class _Libs(_FakeVjpLibs):
    """_FakeVjpLibs with the run-time geometry's entry point, recorded
    apart."""

    def __init__(self):
        super().__init__()
        self.runtime = []

    def cnn_gp_box_filter_vjp_runtime_geometry(self, *args):
        self.runtime.append(args)
        return self.error


@pytest.fixture()
def libs(monkeypatch):
    fake = _Libs()
    monkeypatch.setattr(tbox, "_lib", fake)

    def plain(*a, **k):
        raise AssertionError("the CUDA route called a plain version")
    for name in ("box_filter_2d_vjp_reference", "_vjp_reference"):
        monkeypatch.setattr(tbox, name, plain)
    return fake


@pytest.mark.parametrize("runtime", [False, True])
def test_box_vjp_runtime_geometry_reaches_the_launch(libs, runtime):
    """runtime_geometry=True calls the run-time kernel's entry point with
    the arguments the fixed one takes; the default calls the fixed one.
    Both count a launch."""
    geom = tbox.Geometry.of(7, 1, "same", 1)
    maps = [torch.zeros(3, 4, 28, 28), torch.zeros(3, 28, 28),
            torch.zeros(4, 28, 28)]
    grads = [torch.zeros(m.shape) for m in maps]
    before = tbox.vjp_launches
    outs, dscale, dbias = tbox._launch_vjp(
        geom, grads, maps, [tbox.AS_IS] * 3, [True] * 3, 0.4, True, 5,
        runtime_geometry=runtime)
    assert tbox.vjp_launches == before + 1
    called, other = ((libs.runtime, libs.box) if runtime
                     else (libs.box, libs.runtime))
    assert other == [] and len(called) == 1
    args = called[0]
    assert args[:5] == (grads[0].data_ptr(), maps[0].data_ptr(),
                        outs[0].data_ptr(), 12, tbox.AS_IS)
    assert args[15:23] == (28, 28, 28, 28, 7, 1, 3, 1)
    assert args[26:28] == (dscale.data_ptr(), dbias.data_ptr())
    assert args[30] == 5


def test_box_vjp_partials_asked_once_per_shape_on_both_routes(libs,
                                                              monkeypatch):
    """The partials size is asked of the library once per shape, whichever
    kernel the launches take."""
    asked = []

    def query(*a, _fn=libs.cnn_gp_box_filter_vjp_partials):
        asked.append(a[:4])
        return _fn(*a)
    monkeypatch.setattr(libs, "cnn_gp_box_filter_vjp_partials", query,
                        raising=False)
    monkeypatch.setattr(tbox, "_partials_sizes", (None, {}))
    for w, k in ((28, 7), (14, 3)):
        geom = tbox.Geometry.of(k, 1, "same", 1)
        for runtime in (False, True, False):
            tbox._launch_vjp(geom, [torch.zeros(2, w, w)],
                             [torch.zeros(2, w, w)], [tbox.AS_IS], [True],
                             1.0, True, 0, runtime_geometry=runtime)
    assert asked == [(28, 28, 28, 28), (14, 14, 14, 14)]
    assert len(libs.box) == 4 and len(libs.runtime) == 2

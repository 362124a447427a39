"""The megakernel's pre-pass run once per image set (cnn_gp_tpu_torch.ops.
megakernel.pair_tile and parallel.gram.set_maps) on the CPU.

A Gram-level call computes each image set's pre-pass maps once and every
tile reads its slices of them.  Here, where the plain versions stand in
for the kernels: ``pair_tile_reference`` on a tile's slices of a set's
maps against ``gram_tile_reference`` (the same bits) and the JAX Pallas
kernel in interpret mode; every hoisted Gram-level caller against the
per-tile route (``gram_tile`` per tile, its own pre-pass: the same
bits); and the callers' launches through the CUDA launch code with a
stubbed ``_lib`` (one pre-pass per set per call, the pair kernel's
pointers and layer strides at ragged edges).  A model with a pool takes
the full covariance's spec through the same seam (``gram.tile_spec``,
``set_maps``, the spec's ``rows`` and ``tile``): every caller against
``apply_kernel`` per tile, and its pre-pass spans.  The kernels run on
the card in tests/test_torch_cuda.py and chip_smoke.py."""

import ctypes

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
from cnn_gp_tpu.ops import megakernel as jmk
import cnn_gp_tpu_torch as T
from cnn_gp_tpu_torch.kernels import apply_kernel
from cnn_gp_tpu_torch.ops import fullcov
from cnn_gp_tpu_torch.ops import megakernel as tmk
from cnn_gp_tpu_torch.parallel import (IncrementalGP, classify_device_large,
                                       compute_gram, compute_gram_sharded,
                                       gram, gram_device, make_mesh)
from cnn_gp_tpu_torch.parallel import device_large
from cnn_gp_tpu_torch.utils import timing

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread (the other port test files do the same: six
    xdist workers' OpenMP pools otherwise stall each other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def convnet(M, k, n_layers, s):
    mods = []
    for li in range(n_layers):
        mods += [M.Conv2d(k, var_weight=1.5 + 0.25 * li,
                          var_bias=0.1 + li), M.ReLU()]
    return M.Sequential(*mods, M.Conv2d(s, padding=0))


def _images(n, c, s, seed):
    return np.random.RandomState(seed).rand(n, c, s, s).astype(np.float32)


def _bits(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.int32)


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


# tiles of an 8-row Gram over a 20-image set: (kind, i0, j0)
TILES = [("full", 8, 0), ("ragged", 16, 8), ("masked diagonal", 8, 8)]


@pytest.mark.parametrize("kind,i0,j0", TILES)
@pytest.mark.parametrize("s,c", [(8, 1), (8, 3), (28, 1), (28, 3)])
def test_pair_tile_reference_on_set_slices(s, c, kind, i0, j0):
    """pair_tile_reference on its tile's slices of a 20-image set's maps
    (layer stride 20) equals gram_tile_reference bit for bit and the JAX
    Pallas kernel in interpret mode within 1e-5 of max|K| (the bound of
    tests/test_torch_megakernel.py).  JAX takes 8-row, 128-column tiles:
    its inputs are padded with other images and its tile cut back."""
    k = 3 if s == 8 else 7
    xs = _images(20, c, s, seed=s + c)
    spec = tmk.match(convnet(T, k, 2, s))
    tx = torch.from_numpy(xs)
    maps = tmk.diag_maps_reference(spec, tx)
    b = 8
    x, z = tx[i0:i0 + b], tx[j0:j0 + b]
    mask = None
    if i0 == j0:
        mask = ((i0 + torch.arange(len(x)))[:, None]
                == (j0 + torch.arange(len(z)))[None, :])
    dx, dz = maps[:, i0:i0 + b], maps[:, j0:j0 + b]
    assert dx.stride(0) == 20 * s * s              # a view of the set's
    got = tmk.pair_tile_reference(spec, x, z, dx, dz, mask)
    want = tmk.gram_tile_reference(spec, x, z, mask)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(tmk.pair_tile(spec, x, z, dx, dz, mask)), _bits(want))

    pad_x = np.concatenate([x.numpy(), xs[:b - len(x)]])
    pad_z = np.concatenate([z.numpy(), np.resize(xs, (128 - len(z), c, s,
                                                       s))])
    pad_mask = np.zeros((b, 128), bool)
    if mask is not None:
        pad_mask[:len(x), :len(z)] = mask.numpy()
    jax_tile = np.asarray(jmk.gram_tile(
        jmk.match(convnet(G, k, 2, s)), pad_x, pad_z,
        None if mask is None else pad_mask, rows_per_step=8,
        interpret=True))[:len(x), :len(z)]
    assert got.shape == (len(x), len(z))
    assert _scaled(got.numpy(), jax_tile) < 1e-5


def test_pair_tile_checks_its_maps():
    spec = tmk.match(convnet(T, 3, 2, 8))
    x = torch.from_numpy(_images(6, 1, 8, 0))
    maps = tmk.diag_maps_reference(spec, x)
    with pytest.raises(ValueError, match="float32 maps"):
        tmk.pair_tile(spec, x, x, maps[:, :5], maps)
    with pytest.raises(ValueError, match="float32 maps"):
        tmk.pair_tile(spec, x, x, maps.double(), maps)
    with pytest.raises(ValueError, match="contiguous"):
        t = maps.transpose(2, 3)
        tmk.pair_tile(spec, x, x, t, maps)
    with pytest.raises(ValueError, match="on meta"):
        tmk.pair_tile(spec, x, x, maps.to("meta"), maps)


def _per_tile_route(monkeypatch):
    """Send every pair_tile call down gram_tile instead: each tile's own
    pre-pass, the route of every Gram before the hoist."""
    monkeypatch.setattr(tmk, "pair_tile",
                        lambda spec, x, z, dx, dz, mask=None:
                        tmk.gram_tile(spec, x, z, mask))


def _model():
    return convnet(T, 3, 2, 8)


X = _images(40, 3, 8, seed=1)
Z = _images(19, 3, 8, seed=2)
Y = np.random.RandomState(3).randint(0, 4, size=40)


def _run(name, model=None):
    model = _model() if model is None else model
    if name == "compute_gram":
        return [compute_gram(model, X, device=CPU, batch_size=16,
                             progress=False),
                compute_gram(model, Z, X, device=CPU, batch_size=16,
                             progress=False)]
    if name == "gram_device":
        return [gram_device(model, X, batch_size=16, device=CPU),
                gram_device(model, Z, X, batch_size=16, device=CPU)]
    if name == "compute_gram_sharded":
        mesh = make_mesh(device="cpu")
        return [compute_gram_sharded(model, X, batch_size=16, mesh=mesh,
                                     progress=False),
                compute_gram_sharded(model, Z, X, batch_size=16, mesh=mesh,
                                     progress=False)]
    if name.startswith("classify_device_large"):
        variances = name.endswith("variances")
        accs, info = classify_device_large(
            model, X, Y, (Z, Y[:19]), batch_size=16, block=16, jitter=1e-3,
            residual_check="full", refine_iters=1, variances=variances,
            verbose=False, device=CPU)
        out = [info["alpha"], info["scores"][0], info["rel_residual"]]
        if variances:
            out.append(info["variances"][0])
        return out
    if name.startswith("IncrementalGP"):
        gp = IncrementalGP(model, capacity=64, batch_size=16, block=16,
                           jitter=1e-3, refine_iters=2,
                           retain_gram=name.endswith("retained"),
                           device=CPU)
        out = []
        for lo, hi in ((0, 24), (24, 40)):
            info = gp.add(X[lo:hi], Y[lo:hi])
            out.append(info["rel_residual"])
        scores, var = gp.predict(Z)
        return out + [gp._alpha, scores, var]
    if name == "make_scores_fn":
        a = np.random.RandomState(4).rand(40, 3).astype(np.float32)
        fn = device_large.make_scores_fn(model, X, a, batch_size=16,
                                         device=CPU)
        return [fn(Z), fn(X[:21])]
    raise ValueError(name)


CALLERS = ["compute_gram", "gram_device", "compute_gram_sharded",
           "classify_device_large", "classify_device_large variances",
           "IncrementalGP retained", "IncrementalGP regen",
           "make_scores_fn"]


@pytest.mark.parametrize("name", CALLERS)
def test_hoisted_caller_equals_the_per_tile_route(name, monkeypatch):
    """Each caller that tiles a matched model's Gram, with one pre-pass
    per image set, gives the bits of the per-tile route (gram_tile per
    tile) on ragged 16-row tiles of 40 and 19 images."""
    got = _run(name)
    _per_tile_route(monkeypatch)
    want = _run(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(g, w)


def _pooled():
    """A small pooled model on 8x8 images: its Gram takes the full
    covariance (the megakernel refuses it)."""
    return T.Sequential(T.Conv2d(3, var_weight=1.7, var_bias=0.1), T.ReLU(),
                        T.AvgPool2d(2), T.Conv2d(3, var_weight=1.3), T.ReLU(),
                        T.AvgPool2d(4), T.Conv2d(1, padding=0))


@pytest.mark.parametrize("name", CALLERS)
def test_pooled_caller_equals_the_per_tile_route(name, monkeypatch):
    """Each caller takes a pooled model's full-covariance spec from
    gram.tile_spec, with one pre-pass per image set, and gives the values
    of apply_kernel per tile (each tile its own pre-pass) within 1e-6."""
    model = _pooled()
    assert isinstance(gram.tile_spec(model), fullcov.FullSpec)
    got = _run(name, model)
    monkeypatch.setattr(fullcov.FullSpec, "tile",
                        lambda spec, x, z, mx, mz, mask=None:
                        apply_kernel(model, x, z, False, False, mask))
    want = _run(name, model)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_pooled_regen_sweeps_and_scores_run_one_prepass_per_set():
    """For a pooled model, as for the megakernel's: a regenerating matvec
    sweep records one gram.prepass (one set, all its images);
    make_scores_fn one when it is made and one per call."""
    model = _pooled()
    x_all = gram._on_device(X, CPU)
    s = torch.ones(40)
    a = torch.ones(40, 2)
    with torch.no_grad(), timing.recording() as found:
        device_large._matvec_scan(model, x_all, s, a, 16, 40)
        made = len(found)
        fn = device_large.make_scores_fn(model, X,
                                         np.ones((40, 2), np.float32),
                                         batch_size=16, device=CPU)
        fn(Z)
        fn(Z)
    pre = [sp for sp in found if sp.name == "gram.prepass"]
    assert [(sp.attrs["sets"], sp.attrs["images"]) for sp in pre] == [
        (1, 40), (1, 40), (1, 19), (1, 19)]
    assert [sp.name for sp in found[:made]].count("gram.prepass") == 1
    assert pre[0].attrs["maps"] == "8x8/4x4"


class _Lib:
    """Stands in for the built kernel libraries on CPU tensors: records
    each launch and writes zeros where the kernel writes."""

    def __init__(self):
        self.calls = []

    def cnn_gp_diag_maps(self, x, layers, out, b, c, s, k, n_layers, *rest):
        self.calls.append(("pre-pass", (x, out, b)))
        ctypes.memset(out, 0, 4 * n_layers * b * s * s)
        return 0

    def cnn_gp_pair_tile(self, x, z, dx, dz, mask, layers, out, bx, bz,
                         ldx, ldz, *rest):
        self.calls.append(("pair", (x, z, dx, dz, bx, bz, ldx, ldz)))
        ctypes.memset(out, 0, 4 * bx * bz)
        return 0

    def error_string(self, code):
        return "stub error"


@pytest.fixture()
def stub_route(monkeypatch):
    """``diag_maps`` and ``pair_tile`` on CPU tensors through their CUDA
    launch code (``_launch_diag_maps``, ``_launch_pair``, with the same
    checks) on a stubbed ``_lib``; the plain versions raise."""
    lib = _Lib()
    monkeypatch.setattr(tmk, "_lib", lib)

    def diag_maps(spec, x):
        tmk._check_images(spec, "x", x)
        return tmk._launch_diag_maps(spec, x, tmk._layer_params(spec, CPU),
                                     0)

    def pair_tile(spec, x, z, dx, dz, mask=None):
        tmk._check(spec, x, z, mask)
        ldx = tmk._map_stride(spec, "dx", dx, x)
        ldz = tmk._map_stride(spec, "dz", dz, z)
        return tmk._launch_pair(spec, x, z, dx, dz, ldx, ldz, mask,
                                tmk._layer_params(spec, CPU), 0)

    def plain(*a, **k):
        raise AssertionError("the CUDA route ran a plain version")

    monkeypatch.setattr(tmk, "diag_maps", diag_maps)
    monkeypatch.setattr(tmk, "pair_tile", pair_tile)
    for name in ("gram_tile_reference", "pair_tile_reference",
                 "diag_maps_reference"):
        monkeypatch.setattr(tmk, name, plain)
    return lib


@pytest.mark.parametrize("fn", ["compute_gram", "gram_device"])
@pytest.mark.parametrize("cross", [False, True])
def test_one_prepass_per_set_and_the_pair_kernels_slices(stub_route, fn,
                                                         cross):
    """A Gram of 40 (x) by 19 (z) images in 16-row tiles, or of x by x:
    one pre-pass per set (the set's pointer, all its images), then per
    tile the pair kernel on the tile's images and its rows of the maps,
    whose layers lie a whole set apart (ldx = 40, ldz = 19 or 40), the
    last tiles ragged (8 and 3 rows)."""
    model = _model()
    before = (tmk.launches, tmk.prepass_launches)
    x_all = gram._on_device(X, CPU)
    z_all = gram._on_device(Z, CPU) if cross else None
    with torch.no_grad():
        if fn == "compute_gram":
            compute_gram(model, x_all, z_all, device=CPU, batch_size=16,
                         progress=False)
        else:
            gram_device(model, x_all, z_all, batch_size=16, device=CPU)
    calls = stub_route.calls
    pre = [args for name, args in calls if name == "pre-pass"]
    pairs = [args for name, args in calls if name == "pair"]
    assert [name for name, _ in calls[:len(pre)]] == ["pre-pass"] * len(pre)
    img = 3 * 8 * 8 * 4                    # bytes per image
    plane = 8 * 8 * 4                      # bytes per map
    n2 = 19 if cross else 40
    if cross:
        # compute_gram(x_all, z_all) tiles K(x, z); the uploads are
        # new tensors, so the pointers are read back from the pre-pass
        assert [p[2] for p in pre] == [40, 19]
    else:
        assert [p[2] for p in pre] == [40]
    (x_ptr, dx_ptr, _), (z_ptr, dz_ptr, _) = pre[0], pre[-1]
    offsets = [(i0, j0) for i0 in range(0, 40, 16)
               for j0 in range(0 if cross else i0, n2, 16)]
    assert len(pairs) == len(offsets)
    for (i0, j0), (x, z, dx, dz, bx, bz, ldx, ldz) in zip(offsets, pairs):
        assert (x, z) == (x_ptr + i0 * img, z_ptr + j0 * img)
        assert (dx, dz) == (dx_ptr + i0 * plane, dz_ptr + j0 * plane)
        assert (bx, bz) == (min(16, 40 - i0), min(16, n2 - j0))
        assert (ldx, ldz) == (40, n2)
    assert (tmk.launches - before[0],
            tmk.prepass_launches - before[1]) == (len(offsets), len(pre))


def test_regen_sweeps_and_scores_run_one_prepass_per_set(stub_route):
    """A regenerating matvec sweep runs one pre-pass; make_scores_fn one
    when it is made (the training set's, kept) and one per call."""
    model = _model()
    x_all = gram._on_device(X, CPU)
    s = torch.ones(40)
    a = torch.ones(40, 2)
    before = tmk.prepass_launches
    with torch.no_grad():
        device_large._matvec_scan(model, x_all, s, a, 16, 40)
    assert tmk.prepass_launches == before + 1
    fn = device_large.make_scores_fn(model, X, np.ones((40, 2), np.float32),
                                     batch_size=16, device=CPU)
    assert tmk.prepass_launches == before + 2
    fn(Z)
    fn(Z)
    assert tmk.prepass_launches == before + 4


def test_set_maps_reuses_x_when_z_is_x():
    spec = tmk.match(_model())
    x = torch.from_numpy(X)
    dx, dz = gram.set_maps(spec, x)
    assert dz is dx
    dx, dz = gram.set_maps(spec, x, x)
    assert dz is dx
    dx, dz = gram.set_maps(spec, x, torch.from_numpy(Z))
    assert dz is not dx and dz.shape == (2, 19, 8, 8)
    assert gram.set_maps(None, x) is None

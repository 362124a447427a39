"""Port megakernel module (cnn_gp_tpu_torch.ops.megakernel) on the CPU:
``match`` against the JAX package's rules, the plain version
``gram_tile_reference`` against the JAX Pallas kernel in interpret mode
and against the port's ``apply_kernel``, and the wrapper's device rules.
The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py
and chip_smoke.py."""

import hashlib
import math

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import megakernel as jmk
from cnn_gp_tpu_torch.kernels import apply_kernel
from cnn_gp_tpu_torch.ops import megakernel as tmk
from cnn_gp_tpu_torch.ops.boxfilter import box_filter_2d


def small(M):
    """2 layers, k=3, on 8x8 maps: the C=3 spec of the JAX test."""
    return M.Sequential(M.Conv2d(3, var_weight=2.0, var_bias=0.5), M.ReLU(),
                        M.Conv2d(3, var_weight=1.5, var_bias=0.1), M.ReLU(),
                        M.Conv2d(8, padding=0))


REFUSED = {
    "residual": lambda M: M.Sum([M.Sequential(), M.Sequential()]),
    "strided": lambda M: M.Sequential(M.Conv2d(3, stride=2), M.ReLU(),
                                      M.Conv2d(7, padding=0)),
    "even_kernel": lambda M: M.Sequential(M.Conv2d(4), M.ReLU(),
                                          M.Conv2d(7, padding=0)),
    "padded_readout": lambda M: M.Sequential(M.Conv2d(3), M.ReLU(),
                                             M.Conv2d(7)),
    "dilated": lambda M: M.Sequential(M.Conv2d(3, dilation=2), M.ReLU(),
                                      M.Conv2d(7, padding=0)),
    "mixed_k": lambda M: M.Sequential(M.Conv2d(3), M.ReLU(), M.Conv2d(5),
                                      M.ReLU(), M.Conv2d(7, padding=0)),
    "no_relu": lambda M: M.Sequential(M.Conv2d(3), M.Conv2d(3),
                                      M.Conv2d(7, padding=0)),
}


def test_match_convnet_gp():
    import configs
    from cnn_gp_tpu_torch.configs import load
    got = tmk.match(load("mnist_paper_convnet_gp").initial_model)
    want = jmk.match(configs.load("mnist_paper_convnet_gp").initial_model)
    assert got is not None and tuple(got) == tuple(want)
    assert got.kernel_size == 7 and len(got.layer_vw_vb) == 7
    assert got.readout_k == 28 and got.layer_vw_vb[0] == (2.79 * 49, 7.86)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_match_refuses_what_jax_refuses(name):
    assert jmk.match(REFUSED[name](G)) is None
    assert tmk.match(REFUSED[name](T)) is None


def test_match_small_spec():
    assert tuple(tmk.match(small(T))) == tuple(jmk.match(small(G)))


def _pair(use_mask):
    x, _, _, _ = synthetic_arrays(n_train=8, n_test=0, shape=(3, 8, 8))
    z, _, _, _ = synthetic_arrays(n_train=128, n_test=0, shape=(3, 8, 8),
                                  seed=2)
    if not use_mask:
        return x, z, None
    # rows 0..7 are columns 4..11 of the same global examples (unmasked,
    # such pairs sit at cos(theta) = 1, where acos amplifies rounding)
    z[4:12] = x
    mask = (4 + np.arange(8))[:, None] == np.arange(128)[None, :]
    return x, z, mask


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


def _tile_float64(spec, x, z, mask):
    """The same tile in float64 with the exact arc-cosine: the value both
    float32 evaluations approximate."""
    x, z = torch.from_numpy(x).double(), torch.from_numpy(z).double()
    xy = (x[:, None] * z[None]).mean(2)
    xx = (x * x).mean(1)[:, None].expand_as(xy)
    yy = (z * z).mean(1)[None].expand_as(xy)
    k = spec.kernel_size
    for vw, vb in spec.layer_vw_vb:
        xy, xx, yy = (box_filter_2d(m, k, 1, (k // 2, k // 2)) * (vw / k ** 2)
                      + vb for m in (xy, xx, yy))
        norm = torch.sqrt(xx * yy)
        theta = torch.acos(torch.clamp(xy / norm, -1.0, 1.0))
        new_xy = (norm * torch.sin(theta) + (math.pi - theta) * xy) / (
            2 * math.pi)
        xx, yy = xx / 2, yy / 2
        xy = new_xy if mask is None else torch.where(
            torch.from_numpy(mask)[:, :, None, None], xx, new_xy)
    r_scale = spec.readout_vw / spec.readout_k ** 2
    return (xy.sum((-2, -1)) * r_scale + spec.readout_vb).numpy()


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("use_mask", [False, True])
def test_reference_matches_jax_interpret(use_mask):
    """The port's plain version against the Pallas kernel in interpret
    mode (1e-5 of max|K|), and each of them against the float64 tile
    (1e-5 as well; both sit near 2e-7 of it).  A failure names the side
    that moved: it prints both outputs' digests and each side's error
    against the float64 tile."""
    x, z, mask = _pair(use_mask)
    want = np.asarray(jmk.gram_tile(jmk.match(small(G)), x, z, mask,
                                    rows_per_step=8, interpret=True))
    got = tmk.gram_tile_reference(
        tmk.match(small(T)), torch.from_numpy(x), torch.from_numpy(z),
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == (8, 128)
    exact = _tile_float64(tmk.match(small(T)), x, z, mask)
    errs = {"jax": _scaled(want, exact), "port": _scaled(got, exact)}
    record = (f"sha256 jax {_digest(want)}, port {_digest(got)}; against "
              f"the float64 tile: jax {errs['jax']:.4e}, port "
              f"{errs['port']:.4e}")
    assert _scaled(got, want) < 1e-5, record
    for side, err in errs.items():
        assert err < 1e-5, f"{side} moved: {record}"


@pytest.mark.parametrize("use_mask", [False, True])
def test_reference_matches_apply_kernel(use_mask):
    x, z, mask = _pair(use_mask)
    model = small(T)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    tmask = None if mask is None else torch.from_numpy(mask)
    want = apply_kernel(model, tx, tz, False, False, tmask)
    got = tmk.gram_tile_reference(tmk.match(model), tx, tz, tmask)
    assert _scaled(got.numpy(), want.numpy()) < 1e-5


def test_reference_paper_shape_symmetric():
    """Full-width paper ConvNet on a diagonal tile: matches apply_kernel
    and is exactly symmetric."""
    from cnn_gp_tpu_torch.configs import load
    model = load("mnist_paper_convnet_gp").initial_model
    x, _, _, _ = synthetic_arrays(n_train=6, n_test=0)
    tx = torch.from_numpy(x)
    mask = torch.eye(6, dtype=torch.bool)
    got = tmk.gram_tile_reference(tmk.match(model), tx, tx, mask).numpy()
    want = apply_kernel(model, tx, tx, False, False, mask).numpy()
    assert _scaled(got, want) < 1e-5
    np.testing.assert_array_equal(got, got.T)


def test_gram_tile_on_cpu_runs_the_plain_version():
    x, z, mask = _pair(True)
    spec = tmk.match(small(T))
    before = tmk.launches
    got = tmk.gram_tile(spec, torch.from_numpy(x), torch.from_numpy(z),
                        torch.from_numpy(mask).to(torch.uint8))
    want = tmk.gram_tile_reference(spec, torch.from_numpy(x),
                                   torch.from_numpy(z),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert tmk.launches == before      # no kernel launched


def test_cuda_path_refuses_other_tensors_and_never_runs_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the CUDA path called the plain version")

    monkeypatch.setattr(tmk, "gram_tile_reference", plain)
    spec = tmk.match(small(T))
    x = torch.zeros(2, 3, 8, 8)
    before = tmk.launches
    with pytest.raises(ValueError, match="cuda"):
        tmk._launch(spec, x, x, None)
    with pytest.raises(ValueError, match="cuda"):
        tmk.gram_tile(spec, x.to("meta"), x.to("meta"))
    assert tmk.launches == before


@pytest.mark.parametrize("bad", ["dtype", "layout", "spatial", "mask_shape",
                                 "mask_dtype", "devices"])
def test_wrapper_checks_inputs(bad):
    spec = tmk.match(small(T))
    x = torch.zeros(4, 3, 8, 8)
    z = torch.zeros(5, 3, 8, 8)
    mask = None
    if bad == "dtype":
        x = x.double()
    elif bad == "layout":
        x = torch.zeros(4, 8, 8, 3).permute(0, 3, 1, 2)
    elif bad == "spatial":
        x, z = torch.zeros(4, 3, 10, 10), torch.zeros(5, 3, 10, 10)
    elif bad == "mask_shape":
        mask = torch.zeros(5, 4, dtype=torch.bool)
    elif bad == "mask_dtype":
        mask = torch.zeros(4, 5)
    elif bad == "devices":
        z = z.to("meta")
    with pytest.raises(ValueError):
        tmk.gram_tile(spec, x, z, mask)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def _diag_case(name):
    """(port model, JAX model, x, z) for the pre-pass tests."""
    if name == "C=3 8x8":
        x, z, _ = _pair(False)
        return small(T), small(G), x, z[:16]
    import configs
    from cnn_gp_tpu_torch.configs import load
    x, _, _, _ = synthetic_arrays(n_train=5, n_test=0)
    z, _, _, _ = synthetic_arrays(n_train=3, n_test=0, seed=4)
    return (load("mnist_paper_convnet_gp").initial_model,
            configs.load("mnist_paper_convnet_gp").initial_model, x, z)


@pytest.mark.parametrize("name", ["C=3 8x8", "paper"])
def test_diag_maps_reference_equals_pair_recursion(name):
    """The pre-pass's plain version gives, bit for bit, the xx and yy of
    the per-pair recursion at every layer."""
    model, _, x, z = _diag_case(name)
    spec = tmk.match(model)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    record = []
    tmk._recursion(spec, tx, tz, None, record)
    dx, dz = tmk.diag_maps_reference(spec, tx), tmk.diag_maps_reference(
        spec, tz)
    assert dx.shape == (len(spec.layer_vw_vb),) + x.shape[:1] + x.shape[2:]
    assert len(record) == len(spec.layer_vw_vb)
    for layer, (xx, yy) in enumerate(record):
        np.testing.assert_array_equal(_bits(xx[:, 0]), _bits(dx[layer]))
        np.testing.assert_array_equal(_bits(yy[0]), _bits(dz[layer]))


@pytest.mark.parametrize("name", ["C=3 8x8", "paper"])
def test_diag_maps_readout_matches_jax_diag(name):
    """The readout of the last halved map is the JAX package's diagonal
    kernel (model(x, diag=True), on the CPU) within 1e-5 of value
    scale."""
    model, jmodel, x, _ = _diag_case(name)
    spec = tmk.match(model)
    half = tmk.diag_maps_reference(spec, torch.from_numpy(x))[-1] * 0.5
    got = (half.sum(dim=(-2, -1)) * (spec.readout_vw / spec.readout_k ** 2)
           + spec.readout_vb).numpy()
    want = np.asarray(jmodel(x, diag=True))
    assert got.shape == want.shape == (len(x),)
    assert _scaled(got, want) < 1e-5


class _FakeLib:
    """Stands in for the built kernel libraries: records each launch."""

    def __init__(self, pair_error=0):
        self.calls = []
        self.pair_error = pair_error

    def cnn_gp_diag_maps(self, *args):
        self.calls.append(("pre-pass", args))
        return 0

    def cnn_gp_pair_tile(self, *args):
        self.calls.append(("pair", args))
        return self.pair_error

    def error_string(self, code):
        return "stub error"


@pytest.fixture()
def fake_lib(monkeypatch):
    """A stubbed ``_lib``; both plain versions raise if called."""
    lib = _FakeLib()
    monkeypatch.setattr(tmk, "_lib", lib)

    def plain(*a, **k):
        raise AssertionError("the CUDA path called a plain version")

    monkeypatch.setattr(tmk, "gram_tile_reference", plain)
    monkeypatch.setattr(tmk, "diag_maps_reference", plain)
    return lib


def test_cuda_path_launches_prepass_then_pair(fake_lib, monkeypatch):
    """Pre-pass of x, pre-pass of z, then the pair kernel on their
    [L, b, H, W] scratch maps; one pair launch, two pre-passes."""
    spec = tmk.match(small(T))
    x, z = torch.zeros(4, 3, 8, 8), torch.ones(5, 3, 8, 8)
    mask = torch.zeros(4, 5, dtype=torch.bool)
    scratch = []
    launch_diag = tmk._launch_diag_maps

    def spy(*args):
        out = launch_diag(*args)
        scratch.append(out)
        return out

    monkeypatch.setattr(tmk, "_launch_diag_maps", spy)
    before = (tmk.launches, tmk.prepass_launches)
    out = tmk._launch_kernels(spec, x, z, mask, 0)
    assert [name for name, _ in fake_lib.calls] == ["pre-pass", "pre-pass",
                                                    "pair"]
    assert [tuple(s.shape) for s in scratch] == [(2, 4, 8, 8), (2, 5, 8, 8)]
    assert all(s.dtype == torch.float32 for s in scratch)
    (_, pre_x), (_, pre_z), (_, pair) = fake_lib.calls
    assert pre_x[0] == x.data_ptr() and pre_x[2] == scratch[0].data_ptr()
    assert pre_z[0] == z.data_ptr() and pre_z[2] == scratch[1].data_ptr()
    assert pre_x[3:8] == (4, 3, 8, 3, 2) and pre_z[3:8] == (5, 3, 8, 3, 2)
    assert pair[:5] == (x.data_ptr(), z.data_ptr(), scratch[0].data_ptr(),
                        scratch[1].data_ptr(), mask.data_ptr())
    assert pair[7:13] == (4, 5, 3, 8, 3, 2)
    assert pair[13:15] == (1.0 / 64, 0.0)
    assert out.shape == (4, 5) and out.dtype == torch.float32
    assert (tmk.launches, tmk.prepass_launches) == (before[0] + 1,
                                                    before[1] + 2)


@pytest.mark.parametrize("kind,n_prepass", [("z is x", 1), ("same view", 1),
                                            ("other rows", 2),
                                            ("prefix of x", 2)])
def test_cuda_path_prepass_once_when_z_is_x(fake_lib, kind, n_prepass):
    """z with x's storage and shape (compute_gram's diagonal tiles slice
    the same rows twice) reuses x's maps; any other z gets its own."""
    spec = tmk.match(small(T))
    pool = torch.zeros(8, 3, 8, 8)
    x = pool[:4]
    z = {"z is x": x, "same view": pool[:4], "other rows": pool[4:],
         "prefix of x": pool[:3]}[kind]
    before = tmk.prepass_launches
    tmk._launch_kernels(spec, x, z, None, 0)
    assert tmk.prepass_launches == before + n_prepass
    names = [name for name, _ in fake_lib.calls]
    assert names == ["pre-pass"] * n_prepass + ["pair"]
    pair = fake_lib.calls[-1][1]
    assert (pair[2] == pair[3]) == (n_prepass == 1)
    assert pair[4] is None                    # no mask


def test_cuda_path_counts_one_launch_per_tile(fake_lib):
    spec = tmk.match(small(T))
    x = torch.zeros(6, 3, 8, 8)
    before = (tmk.launches, tmk.prepass_launches)
    for j0 in (0, 2, 4):
        tmk._launch_kernels(spec, x[:2], x[j0:j0 + 2], None, 0)
    assert tmk.launches == before[0] + 3
    assert tmk.prepass_launches == before[1] + 5      # the first: z is x


def test_cuda_path_raises_on_a_failed_launch(monkeypatch):
    """A launch that returns a CUDA error raises and is not counted."""
    lib = _FakeLib(pair_error=2)
    monkeypatch.setattr(tmk, "_lib", lib)
    spec = tmk.match(small(T))
    x = torch.zeros(2, 3, 8, 8)
    before = tmk.launches
    with pytest.raises(RuntimeError, match=r"pair kernel .*cuda error 2 "
                                           r"\(stub error\)"):
        tmk._launch_kernels(spec, x, x, None, 0)
    assert tmk.launches == before


def test_diag_maps_on_cpu_runs_the_plain_version():
    spec = tmk.match(small(T))
    x = torch.from_numpy(_pair(False)[0])
    before = tmk.prepass_launches
    got = tmk.diag_maps(spec, x)
    np.testing.assert_array_equal(
        _bits(got), _bits(tmk.diag_maps_reference(spec, x)))
    assert tmk.prepass_launches == before


def test_diag_maps_refuses_other_tensors():
    spec = tmk.match(small(T))
    with pytest.raises(ValueError, match="cuda"):
        tmk.diag_maps(spec, torch.zeros(2, 3, 8, 8, device="meta"))
    with pytest.raises(ValueError, match="cover"):
        tmk.diag_maps(spec, torch.zeros(2, 3, 10, 10))
    with pytest.raises(ValueError, match="float32"):
        tmk.diag_maps(spec, torch.zeros(2, 3, 8, 8, dtype=torch.float64))


def test_build_hashes_every_source():
    """Every csrc/*.cu file is built (and keys the build hash)."""
    import glob
    import os
    csrc = os.path.join(os.path.dirname(tmk.SOURCES[0]), "*.cu")
    assert sorted(glob.glob(csrc)) == sorted(tmk.SOURCES)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119pair_kernel_genericEPKfS1_S1_S1_PKhS1_Pfiiiiiiifff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119pair_kernel_genericEPKfS1_S1_S1_PKhS1_Pfiiiiiiifff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 420 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111pair_kernelILi28ELi7EEEvPKfS2_S2_S2_PKhS2_Pfiiiifffb' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111pair_kernelILi28ELi7EEEvPKfS2_S2_S2_PKhS2_Pfiiiifffb
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 413 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116diag_maps_kernelEPKfS1_Pfiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116diag_maps_kernelEPKfS1_Pfiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 1 barriers, 396 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    assert tmk.ptxas_report(PTXAS_LOG) == [
        {"kernel": "pair_kernel_generic", "registers": 40,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "pair_kernel<28,7>", "registers": 96, "spill_stores": 4,
         "spill_loads": 12},
        {"kernel": "diag_maps_kernel", "registers": 22, "spill_stores": 0,
         "spill_loads": 0},
    ]

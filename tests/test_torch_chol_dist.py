"""The port's blocked card factor and its solvers
(cnn_gp_tpu_torch.parallel.chol_dist, ops.solve "chol_ir"/"chol_dist")
against the JAX package's on the same numpy inputs, on the CPU.  The JAX
side runs on a one-device mesh (the port's geometry) and, where cheap, on
the 8-device CPU mesh of tests/conftest.py."""

import jax
import numpy as np
import pytest
import torch

from cnn_gp_tpu.data import GramStore as JStore
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import chol_dist as jcd
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import make_mesh
import cnn_gp_tpu as G
from cnn_gp_tpu_torch.data import GramStore
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import chol_dist as cd
from cnn_gp_tpu_torch.parallel.chol_dist import CardFactor

CPU = torch.device("cpu")


def mesh(n_devices):
    if n_devices > len(jax.devices()):
        pytest.skip("needs the multi-device CPU mesh of tests/conftest.py")
    return make_mesh(n_devices=n_devices)


def _spd(n, seed=0, scale=None):
    """The SPD test matrices of tests/test_chol_dist.py."""
    r = np.random.RandomState(seed)
    a = r.randn(n, n)
    k = a @ a.T / n + np.eye(n)
    if scale is not None:
        d = np.sqrt(10 ** r.uniform(scale - 2, scale, n))
        k = d[:, None] * k * d[None, :]
    return k


def port_factor(k, block, pad_to=1):
    f = CardFactor(len(k), block, pad_to=pad_to, device=CPU)
    f.factorize(np.asarray(k, np.float32))
    return f


@pytest.mark.parametrize("n,block", [(64, 16), (100, 16), (37, 8), (130, 32)])
def test_factor_matches_jax(n, block):
    """The blocked in-place factor equals JAX's blocked factor (one-device
    mesh) and LAPACK's within float32 rounding, with JAX's padded geometry
    and an exact identity pad block (n not a multiple of block)."""
    k = _spd(n, seed=n)
    f = port_factor(k, block)
    assert f.n_pad == jcd._ShardedFactor(mesh(1), n, block).n_pad
    got = f.l.numpy()
    want = jcd.cholesky_sharded(k, mesh(1), block=block)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:n, :n], want, rtol=1e-4,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got[:n, :n], np.linalg.cholesky(k),
                               rtol=1e-4, atol=1e-5 * scale)
    assert (np.triu(got, 1) == 0).all()
    np.testing.assert_array_equal(got[n:, n:], np.eye(f.n_pad - n))
    assert (got[n:, :n] == 0).all()


def test_factor_reads_only_lower_triangle():
    """Zeros or NaNs strictly above the diagonal change neither the factor
    nor the solve (the large-N assembly writes only the lower triangle)."""
    k = _spd(64, seed=7)
    want = np.linalg.cholesky(k)
    y = np.random.RandomState(8).randn(64, 3)
    want_a = np.linalg.solve(k, y)
    jwant_a = jcd.cholesky_solve_sharded(k, y, mesh(1), block=16)
    for garbage in (np.zeros_like(k), np.full_like(k, np.nan)):
        klow = np.tril(k) + np.triu(garbage, 1)
        f = port_factor(klow, 16)
        np.testing.assert_allclose(f.l.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
        a = f.solve(y)
        np.testing.assert_allclose(a, want_a, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(a, jwant_a, rtol=1e-3, atol=1e-4)


def test_factor_refuses_indefinite():
    with pytest.raises(np.linalg.LinAlgError, match="positive-definite"):
        port_factor(-_spd(40, seed=1), 16)


def test_factor_of_in_place_and_float64():
    """``CardFactor.of`` factors a card tensor in place (a ragged last
    block, no padding), in its dtype; the solve, forward_sumsq and
    log_diag_sum agree with LAPACK in float64."""
    k = _spd(50, seed=3)
    t = torch.as_tensor(k.copy())
    f = CardFactor.of(t, block=16)
    assert f.l is t and f.n == f.n_pad == 50 and t.dtype == torch.float64
    want = np.linalg.cholesky(k)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-12, atol=1e-12)
    w = np.random.RandomState(0).randn(50, 4)
    v = np.linalg.solve(want, w)
    np.testing.assert_allclose(f.forward_sumsq(torch.as_tensor(w)).numpy(),
                               (v * v).sum(0), rtol=1e-12)
    np.testing.assert_allclose(f.solve(w), np.linalg.solve(k, w),
                               rtol=1e-10, atol=1e-12)
    assert abs(f.log_diag_sum() - np.log(np.diagonal(want)).sum()) < 1e-10


@pytest.mark.parametrize("n_dev", [1, 8])
@pytest.mark.parametrize("case", ["plain", "nngp_scale", "paper_like_n"])
def test_chol_solve_dist_matches_jax(case, n_dev):
    """(A, rel, iters) of the port equal JAX's: A within float64-refined
    tolerance of JAX's and LAPACK's, both residuals below 1e-10, the same
    refinement count.  ``nngp_scale`` has a ~1e12 diagonal and jitter;
    ``paper_like_n`` has n = 70, not a multiple of the block."""
    n, scale, jitter, block = {"plain": (120, None, 0.0, 16),
                               "nngp_scale": (96, 12, 1e4, 16),
                               "paper_like_n": (70, 12, 1e3, 32)}[case]
    k = _spd(n, seed=5 + n, scale=scale)
    y = jsolve.one_hot_targets(np.arange(n) % 10)
    want_np = np.linalg.solve(k + jitter * np.eye(n), y)
    ja, jrel, jit = jcd.chol_solve_dist(k.copy(), y, jitter=jitter,
                                        mesh=mesh(n_dev), block=block)
    a, rel, it = cd.chol_solve_dist(k.copy(), y, jitter=jitter, block=block,
                                    device=CPU)
    assert rel < 1e-10 and jrel < 1e-10, (rel, jrel)
    assert it == jit
    amax = np.abs(want_np).max()
    np.testing.assert_allclose(a, want_np, rtol=1e-7, atol=1e-9 * amax)
    np.testing.assert_allclose(a, ja, rtol=1e-7, atol=1e-9 * amax)


def test_chol_solve_dist_from_card_gram():
    """``k_dev``: the raw Gram already on the device is scaled there."""
    k = _spd(90, seed=2, scale=12)
    y = jsolve.one_hot_targets(np.arange(90) % 10)
    a, rel, _ = cd.chol_solve_dist(
        k.copy(), y, jitter=1e3, block=32, device=CPU,
        k_dev=torch.as_tensor(k.astype(np.float32)))
    want = np.linalg.solve(k + 1e3 * np.eye(90), y)
    assert rel < 1e-10
    np.testing.assert_allclose(a, want, rtol=1e-7,
                               atol=1e-9 * np.abs(want).max())


def test_chol_solve_ir32_matches_jax():
    """float32 data solved to the float64 embedding's tolerance: the same
    (A, rel, iters) as JAX's, never a float64 matrix."""
    k32 = _spd(100, seed=21, scale=12).astype(np.float32)
    y = jsolve.one_hot_targets(np.arange(100) % 10)
    ja, jrel, jit = jcd.chol_solve_ir32(k32, y, jitter=1e3, mesh=mesh(1),
                                        block=16, io_rows=32)
    a, rel, it = cd.chol_solve_ir32(k32, y, jitter=1e3, block=16,
                                    io_rows=32, device=CPU)
    want = np.linalg.solve(k32.astype(np.float64) + 1e3 * np.eye(100), y)
    assert rel < 1e-10 and jrel < 1e-10 and it == jit
    amax = np.abs(want).max()
    np.testing.assert_allclose(a, want, rtol=1e-7, atol=1e-9 * amax)
    np.testing.assert_allclose(a, ja, rtol=1e-7, atol=1e-9 * amax)


@pytest.fixture(scope="module")
def gram_problem():
    """A small-model Gram (n = 70, not a multiple of the tile) with cross
    Grams and k_zz, from the JAX package."""
    jm = G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(7, padding=0))
    x, yl, zx, _ = synthetic_arrays(n_train=70, n_test=12, shape=(1, 7, 7))
    k = np.asarray(jgram(jm, x, batch_size=16, progress=False))
    kzx = np.asarray(jgram(jm, zx, x, batch_size=16, progress=False))
    kzz = np.asarray(jm(zx, diag=True), np.float64)
    return k, kzx, kzz, jsolve.one_hot_targets(yl)


def test_posterior_statistics_match_jax_and_oracle(gram_problem):
    """variances_from_cross_host and evidence_from_factor through the
    port's live factor: against JAX's (one-device mesh) and the float64
    oracle (variances within 1e-5 * mean(k_zz), evidence rtol 5e-4)."""
    k, kzx, kzz, y = gram_problem
    jitter = 1e-4 * float(np.mean(np.diagonal(k)))
    a, rel, _, f, s = cd.chol_solve_ir32(k, y, jitter=jitter, block=16,
                                         return_factor=True, device=CPU)
    ja, _, _, jf, js = jcd.chol_solve_ir32(k, y, jitter=jitter,
                                           mesh=mesh(1), block=16,
                                           return_factor=True)
    np.testing.assert_array_equal(s, js)
    var = cd.variances_from_cross_host(f, s, kzx, kzz, chunk=5)
    jvar = jcd.variances_from_cross_host(jf, js, kzx, kzz)
    k64 = k.astype(np.float64)
    want = jsolve.predictive_variance(k64, kzx, kzz, jitter=jitter)
    scale = float(kzz.mean())
    assert var.shape == (12,) and (var >= 0).all()
    assert np.abs(var - want).max() < 1e-5 * scale
    assert np.abs(var - jvar).max() < 1e-5 * scale
    ev = cd.evidence_from_factor(f, s, y, a)
    jev = jcd.evidence_from_factor(jf, js, y, ja)
    want_ev = jsolve.log_marginal_likelihood(
        k64 + jitter * np.eye(len(k)), y)
    np.testing.assert_allclose(ev, want_ev, rtol=5e-4)
    np.testing.assert_allclose(ev, jev, rtol=5e-4)


def _write_upper(path, k, hole=None):
    """The upper tile triangle of ``k`` written by the JAX package's store
    (tile 16), optionally leaving one tile out."""
    n = len(k)
    with JStore(path, "w") as store:
        store.create("Kxx", n, n, 16)
        for i in range(0, n, 16):
            for j in range(i, n, 16):
                if (i, j) != hole:
                    store.write_tile("Kxx", i, j, k[i:i + 16, j:j + 16])


@pytest.mark.parametrize("path", ["stream", "serial"])
def test_store_solvers_on_jax_store(path, gram_problem, tmp_path):
    """Both store paths, on an HDF5 store the JAX package wrote: the same
    solution as JAX's store solver and the scipy oracle, and a live factor
    that serves the same variances.  n = 70 with io_rows = 32 exercises
    the partial tail chunk on both threads of the streamed path."""
    k, kzx, kzz, y = gram_problem
    p = str(tmp_path / "k.h5")
    _write_upper(p, k)
    kw = dict(jitter=1e-6, block=16, return_factor=True)
    with GramStore(p, "r") as store:
        if path == "stream":
            a, rel, _, f, s = cd.chol_solve_stream_from_store(
                store, "Kxx", y, io_rows=32, device=CPU, **kw)
        else:
            a, rel, _, f, s = cd.chol_solve_dist_from_store(
                store, "Kxx", y, check_finite=True, device=CPU, **kw)
    with JStore(p, "r") as store:
        ja, _, _, jf, js = jcd.chol_solve_dist_from_store(
            store, "Kxx", y, mesh=mesh(1), **kw)
        kxx64 = jsolve.symmetrize_from_upper(store.read("Kxx",
                                                        dtype=np.float64))
    want = jsolve.solve_gp(kxx64, y, jitter=1e-6, method="scipy")
    assert rel < 1e-10, rel
    amax = np.abs(want).max()
    np.testing.assert_allclose(a, want, rtol=1e-6, atol=1e-8 * amax)
    np.testing.assert_allclose(a, ja, rtol=1e-7, atol=1e-9 * amax)
    np.testing.assert_array_equal(s, js)
    v = cd.variances_from_cross_host(f, s, kzx, kzz)
    jv = jcd.variances_from_cross_host(jf, js, kzx, kzz)
    np.testing.assert_allclose(v, jv, rtol=2e-4,
                               atol=1e-5 * float(kzz.mean()))


@pytest.mark.parametrize("path", ["stream", "serial"])
def test_store_solvers_refuse_holes(path, tmp_path):
    """A NaN-holed Gram from the JAX package's store is refused: by one
    reduce over the uploaded buffer (streamed) or the host copy
    (serial)."""
    n = 48
    rng = np.random.default_rng(0)
    k = rng.standard_normal((n, n)).astype(np.float32)
    k = k @ k.T + n * np.eye(n, dtype=np.float32)
    p = str(tmp_path / "holed.h5")
    _write_upper(p, k, hole=(16, 32))
    y = solve.one_hot_targets(np.arange(n) % 4)
    with GramStore(p, "r") as store:
        with pytest.raises(RuntimeError, match="NaN holes"):
            if path == "stream":
                cd.chol_solve_stream_from_store(store, "Kxx", y, jitter=1e-3,
                                                block=16, io_rows=32,
                                                device=CPU)
            else:
                cd.chol_solve_dist_from_store(store, "Kxx", y, jitter=1e-3,
                                              block=16, check_finite=True,
                                              device=CPU)


@pytest.mark.parametrize("method", ["chol_ir", "chol_dist"])
def test_solve_gp_methods_match_jax(method, gram_problem):
    """solve_gp with the float32 factor and float64 refinement: JAX's
    solution, and scipy's predictions."""
    k, kzx, _, y = gram_problem
    k64 = k.astype(np.float64)
    jitter = 1e-6 * float(np.mean(np.diagonal(k64)))
    want = jsolve.solve_gp(k64.copy(), y, jitter=jitter, method="scipy")
    jgot = jsolve.solve_gp(k64.copy(), y, jitter=jitter, method=method)
    got = solve.solve_gp(k64.copy(), y, jitter=jitter, method=method,
                         device=CPU)
    amax = np.abs(want).max()
    tol = 1e-6 if method == "chol_dist" else 1e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * amax)
    np.testing.assert_allclose(got, jgot, rtol=tol, atol=tol * amax)
    np.testing.assert_array_equal(solve.predict(kzx, got),
                                  jsolve.predict(kzx, want))


def test_solve_gp_chol_ir_refine_iters(gram_problem):
    """More refinement rounds move chol_ir toward the float64 solution, as
    in JAX; a non-positive-definite matrix is refused."""
    k, _, _, y = gram_problem
    k64 = k.astype(np.float64)
    want = np.linalg.solve(k64 + 1e-6 * np.eye(70) * k64[0, 0], y)
    errs = [np.abs(solve.solve_gp(k64.copy(), y, jitter=1e-6 * k64[0, 0],
                                  method="chol_ir", refine_iters=r,
                                  device=CPU) - want).max()
            for r in (0, 3)]
    assert errs[1] < errs[0]
    with pytest.raises(np.linalg.LinAlgError, match="non-finite"):
        solve.solve_gp(-np.eye(4), y[:4], method="chol_ir", device=CPU)


def test_refine_with_factor_matches_jax():
    k = _spd(60, seed=9, scale=3)
    y = np.random.RandomState(1).randn(60, 4)
    chol = torch.linalg.cholesky(torch.as_tensor(k.astype(np.float32)))
    got = solve.refine_with_factor(chol, k, y, iters=3)
    jchol = jsolve._chol32(jax.numpy.asarray(k, np.float32))
    want = jsolve.refine_with_factor(jchol, k, y, iters=3)
    np.testing.assert_allclose(got, want, rtol=1e-7,
                               atol=1e-9 * np.abs(want).max())


def test_helpers_match_jax():
    """_chunk_starts, _pad_size, _mirror_rows_tiled and
    _blocked_residual_fn are the JAX package's."""
    for total, size in ((10, 3), (12, 4), (5, 5)):
        assert cd._chunk_starts(total, size) == jcd._chunk_starts(total,
                                                                  size)
    for args in ((70, 16, 1, 1), (37, 8, 1, 16), (50000, 2048, 1, 128)):
        assert cd._pad_size(*args) == jcd._pad_size(*args)
    k = np.triu(np.random.RandomState(0).randn(37, 37).astype(np.float32))
    a, b = k.copy(), k.copy()
    for r0 in range(0, 37, 10):
        cd._mirror_rows_tiled(a, r0, min(r0 + 10, 37), ts=4)
        jcd._mirror_rows_tiled(b, r0, min(r0 + 10, 37), ts=4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, a.T)
    y = np.random.RandomState(1).randn(37, 2)
    x = np.random.RandomState(2).randn(37, 2)
    got = cd._blocked_residual_fn(a, y, 0.5, io_rows=8)(x)
    want = jcd._blocked_residual_fn(a, y, 0.5, io_rows=8)(x)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_new_methods_need_a_device():
    y = solve.one_hot_targets(np.array([0, 1, 0]))
    for method in ("chol_ir", "chol_dist"):
        with pytest.raises(ValueError, match="explicit device"):
            solve.solve_gp(np.eye(3), y, method=method)

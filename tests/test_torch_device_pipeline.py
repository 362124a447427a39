"""The port's card-resident pipeline (cnn_gp_tpu_torch.parallel:
device_pipeline, device_large's serving subset, chol_dist.CardFactor)
against the JAX package on the same arrays, on the CPU, where the
megakernel's plain torch version stands in for the CUDA kernel."""

import numpy as np
import pytest
import scipy.linalg
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops.solve import predictive_variance
from cnn_gp_tpu.parallel import classify_device as jclassify
from cnn_gp_tpu.parallel import gram_device as jgram_device
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import gram_matvec_regen as jmatvec
from cnn_gp_tpu.parallel import scores_regen as jscores
from cnn_gp_tpu_torch import settings
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import (classify_device, gram_device,
                                       gram_matvec_regen, make_scores_fn,
                                       rebuild_factor, scores_regen,
                                       variances_from_factor)
from cnn_gp_tpu_torch.parallel.chol_dist import CardFactor

CPU = torch.device("cpu")
GRAM_TOL = 1e-5   # max|delta| / max|K|, the repo's kernel parity rule


def strided():
    """Not megakernel-shaped: tiles go through apply_kernel."""
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(3, stride=2),
                        G.ReLU(), G.Conv2d(7, padding=0))


def convnet():
    """Megakernel-shaped: tiles go through megakernel.gram_tile."""
    return G.Sequential(G.Conv2d(3, var_weight=2.0, var_bias=0.5), G.ReLU(),
                        G.Conv2d(3, var_weight=1.5, var_bias=0.1), G.ReLU(),
                        G.Conv2d(14, padding=0))


MODELS = {"strided": strided, "convnet": convnet}


def scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture()
def tile_calls(monkeypatch):
    """Counts megakernel.gram_tile calls (on the card each is a launch)."""
    calls = []
    real = megakernel.gram_tile
    monkeypatch.setattr(megakernel, "gram_tile",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(MODELS))
def test_gram_device_matches_jax(name, tile_calls):
    x, _, _, _ = synthetic_arrays(n_train=37, n_test=0, shape=(1, 14, 14))
    jm = MODELS[name]()
    got = gram_device(from_jax_model(jm), x, batch_size=10, device=CPU)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    assert scaled_err(got, np.asarray(jgram_device(jm, x, batch_size=10))
                      ) < GRAM_TOL
    np.testing.assert_array_equal(got, got.T)
    assert len(tile_calls) == (10 if name == "convnet" else 0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_gram_device_cross_matches_jax(name, tile_calls):
    x, _, _, _ = synthetic_arrays(n_train=23, n_test=0, shape=(1, 14, 14))
    z, _, _, _ = synthetic_arrays(n_train=31, n_test=0, shape=(1, 14, 14),
                                  seed=5)
    jm = MODELS[name]()
    got = gram_device(from_jax_model(jm), x, z, batch_size=10,
                      device=CPU).numpy()
    assert scaled_err(got, np.asarray(jgram_device(jm, x, z, batch_size=10))
                      ) < GRAM_TOL
    assert len(tile_calls) == (3 * 4 if name == "convnet" else 0)


def test_gram_device_diag_consistency():
    """The diagonal of the assembled Gram equals the diagonal-only kernel
    (the same-example mask runs inside the tile loop)."""
    x, _, _, _ = synthetic_arrays(n_train=16, n_test=0, shape=(1, 14, 14))
    m = from_jax_model(convnet())
    k = gram_device(m, x, batch_size=8, device=CPU).numpy()
    kd = np.asarray(convnet()(x, diag=True))
    np.testing.assert_allclose(np.diagonal(k), kd, rtol=2e-5, atol=1e-7)


def paper_like():
    return G.Sequential(
        G.Conv2d(7, var_weight=2.79 * 49, var_bias=7.86), G.ReLU(),
        G.Conv2d(14, padding=0, var_weight=2.79, var_bias=7.86))


@pytest.mark.parametrize("refine", [False, True])
def test_classify_device_matches_jax(refine):
    """The same accuracies as JAX's classify_device (float32 normalised
    factor at refine=False; float64 quality at refine=True, where JAX
    refines a float32 factor on the host and the port factors in
    float64)."""
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=96, n_test=32, shape=(1, 14, 14), seed=4)
    splits = [(te_x, te_y), (tr_x[:20], tr_y[:20])]
    want = jclassify(paper_like(), tr_x, tr_y, *splits, batch_size=32,
                     jitter=1e-6, refine=refine)
    got = classify_device(from_jax_model(paper_like()), tr_x, tr_y, *splits,
                          batch_size=32, jitter=1e-6, refine=refine,
                          device=CPU)
    assert got == want
    assert got[0] > 0.9 and got[1] == 1.0


@pytest.mark.parametrize("refine", [False, True])
def test_classify_device_variances(refine):
    """Variances equal the float64 oracle (predictive_variance) with the
    relative-jitter convention jitter_raw = jitter * mean(diag), within
    test_device_pipeline.py's bound: atol 5e-6 * mean(kzz), rtol 2e-4."""
    jm = G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(7, padding=0))
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=60, n_test=20, shape=(1, 7, 7), seed=8)
    jitter = 1e-4
    accs, var = classify_device(from_jax_model(jm), tr_x, tr_y,
                                (te_x, te_y), batch_size=16, jitter=jitter,
                                refine=refine, variances=True, device=CPU)
    kxx = np.asarray(jgram(jm, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzx = np.asarray(jgram(jm, te_x, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzz = np.asarray(jm(te_x, diag=True), np.float64)
    jr = jitter * float(np.mean(np.diagonal(kxx)))
    want = predictive_variance(kxx, kzx, kzz, jitter=jr)
    assert var[0].shape == (20,) and (var[0] >= 0).all()
    np.testing.assert_allclose(var[0], want, atol=5e-6 * float(kzz.mean()),
                               rtol=2e-4)
    jaccs, _ = jclassify(jm, tr_x, tr_y, (te_x, te_y), batch_size=16,
                         jitter=jitter, refine=refine, variances=True)
    assert accs == jaccs


def test_classify_device_refuses_tf32_on_the_card(monkeypatch):
    """Entry points check the TF32 guard for CUDA devices themselves."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        settings.check_precision_on("cuda")
    settings.check_precision_on("cpu")


@pytest.fixture(scope="module")
def serving_data():
    x, y, zx, _ = synthetic_arrays(n_train=40, n_test=21, shape=(1, 8, 8),
                                   n_classes=4)
    jm = G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(3), G.ReLU(),
                      G.Conv2d(8, padding=0))
    a = np.random.RandomState(2).randn(len(x), 4).astype(np.float32)
    return jm, from_jax_model(jm), x, y, zx, a


def test_scores_regen_matches_jax(serving_data, tile_calls):
    """K(Z, X) @ a by tile regeneration, ragged tiles sliced (JAX pads)."""
    jm, tm, x, _, zx, a = serving_data
    want = np.asarray(jscores(jm, zx, x, a, batch_size=16))
    got = scores_regen(tm, zx, x, a, batch_size=16, device=CPU)
    assert scaled_err(got, want) < GRAM_TOL
    assert len(tile_calls) == 2 * 3
    fn = make_scores_fn(tm, x, a, batch_size=16, device=CPU)
    np.testing.assert_array_equal(fn(zx), got)
    assert fn(zx[:0]).shape == (0, 4)


def test_gram_matvec_regen_matches_jax(serving_data):
    """The raw K @ a and the scaled, diagonal-pinned M @ a."""
    jm, tm, x, _, _, a = serving_data
    want = np.asarray(jmatvec(jm, x, a, batch_size=16))
    got = gram_matvec_regen(tm, x, a, batch_size=16, device=CPU)
    assert scaled_err(got, want) < GRAM_TOL
    s = np.random.RandomState(4).uniform(0.5, 1.5, len(x)).astype(
        np.float32)
    want = np.asarray(jmatvec(jm, x, a, batch_size=16, s=s))
    got = gram_matvec_regen(tm, x, a, batch_size=16, s=s, device=CPU)
    assert scaled_err(got, want) < GRAM_TOL


def test_rebuild_factor_variances_match_oracle(serving_data, tile_calls):
    """rebuild_factor + variances_from_factor against the float64 oracle on
    the same jittered system, within 1e-5 * mean(diag Kxx) (the bound of
    tests/test_serving.py)."""
    jm, tm, x, _, zx, _ = serving_data
    kxx = np.asarray(jgram(jm, x, batch_size=16, progress=False), np.float64)
    kzx = np.asarray(jgram(jm, zx, x, batch_size=16, progress=False),
                     np.float64)
    kzz = np.asarray(jm(zx, diag=True), np.float64)
    jr = 1e-4 * float(np.mean(np.diagonal(kxx)))
    s = 1.0 / np.sqrt(np.diagonal(kxx) + jr)
    factor, x_all, s_dev = rebuild_factor(tm, x, s, batch_size=16,
                                          device=CPU)
    assert len(tile_calls) == 3 * 4 // 2
    snap = settings.snapshot()
    var = variances_from_factor(factor, tm, x_all, s_dev, zx, 16, len(x),
                                snap)
    assert len(tile_calls) == 6 + 2 * 3
    want = predictive_variance(kxx, kzx, kzz, jitter=jr)
    assert np.abs(var - want).max() < 1e-5 * np.mean(np.diagonal(kxx))
    assert (var >= 0).all()
    assert variances_from_factor(factor, tm, x_all, s_dev, zx[:0], 16,
                                 len(x), snap).shape == (0,)
    with settings.override(acos_impl="exact"):
        with pytest.raises(ValueError, match="rebuilt under settings"):
            variances_from_factor(factor, tm, x_all, s_dev, zx, 16, len(x),
                                  snap)


def test_card_factor_operations():
    """forward_sumsq, solve and log_diag_sum against scipy in float64."""
    rng = np.random.RandomState(0)
    f = rng.randn(30, 60)
    m = f @ f.T / 60 + np.eye(30)
    w = rng.randn(30, 5)
    fac = CardFactor.of(torch.tensor(m))   # factored in place: a copy
    l = scipy.linalg.cholesky(m, lower=True)
    v = scipy.linalg.solve_triangular(l, w, lower=True)
    np.testing.assert_allclose(
        fac.forward_sumsq(torch.as_tensor(w)).numpy(), (v * v).sum(0),
        rtol=1e-12)
    np.testing.assert_allclose(fac.solve(w), np.linalg.solve(m, w),
                               rtol=1e-10, atol=1e-12)
    assert abs(fac.log_diag_sum() - np.log(np.diagonal(l)).sum()) < 1e-12
    with pytest.raises(np.linalg.LinAlgError, match="positive-definite"):
        CardFactor.of(torch.tensor(-m))

"""The port's large-N card-resident classification
(cnn_gp_tpu_torch.parallel.device_large) against the JAX package's on the
same numpy inputs, on the CPU, where the megakernel's plain torch version
stands in for the CUDA kernel.  The JAX side runs on a one-device mesh
(the port's geometry); the float64 oracles are the JAX package's
ops.solve functions on explicit Grams.  Counterparts of
tests/test_device_large.py close the file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import classify_device_large as jcdl
from cnn_gp_tpu.parallel import device_large as jdl
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import gram_matvec_regen as jmatvec
from cnn_gp_tpu.parallel import make_mesh
from cnn_gp_tpu.parallel.gram import _pad_to_multiple
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import classify_device_large, device_large
from cnn_gp_tpu_torch.parallel import gram_matvec_regen

CPU = torch.device("cpu")
INFO_KEYS = {"rel_residual", "rel_residual_unrefined",
             "rel_residual_estimated", "rel_residual_sampled",
             "rel_residual_sampled_ucb", "rel_residual_maxrow_ratio",
             "residual_sample_seed", "residual_sampled_blocks",
             "refinements", "n", "n_pad", "block", "predictions", "scores",
             "variances", "log_evidence", "logdet", "alpha", "scalings",
             "jitter_raw", "timings_s"}


def small_jax():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(7, padding=0))


def convnet_jax():
    """Megakernel-shaped: tiles go through megakernel.pair_tile."""
    return G.Sequential(G.Conv2d(3, var_weight=2.0, var_bias=0.5), G.ReLU(),
                        G.Conv2d(7, padding=0))


@pytest.fixture(scope="module")
def small():
    return small_jax(), from_jax_model(small_jax())


def explicit_m(jm, x, b, shift=0.0):
    """The explicit scaled system M (unit diagonal) and its f32 scalings."""
    k = np.asarray(jgram(jm, x, batch_size=b, progress=False), np.float64)
    s = (1.0 / np.sqrt(np.diagonal(k) + shift)).astype(np.float32)
    m = s[:, None] * k * s[None, :]
    np.fill_diagonal(m, 1.0)
    return k, s, m


def test_scaled_matvec_matches_jax(small):
    """gram_matvec_regen(s=...): the scaled, diagonal-pinned M @ a by tile
    regeneration, against JAX's and the explicit M (n = 70, ragged)."""
    jm, tm = small
    x, _, _, _ = synthetic_arrays(n_train=70, n_test=0, shape=(1, 7, 7))
    _, s, m = explicit_m(jm, x, 16, shift=0.1)
    a = np.random.RandomState(0).randn(70, 5).astype(np.float32)
    got = gram_matvec_regen(tm, x, a, batch_size=16, s=s, device=CPU)
    want = np.asarray(jmatvec(jm, x, a, batch_size=16, s=s))
    np.testing.assert_allclose(got, m @ a, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_rows_matvec_matches_jax(small):
    """Selected block-rows of M @ a, compacted in sample order; rows past
    n in the short last block stay zero, as JAX's pad rows."""
    jm, tm = small
    n, b = 70, 16
    x, _, _, _ = synthetic_arrays(n_train=n, n_test=0, shape=(1, 7, 7))
    _, s, m = explicit_m(jm, x, b)
    a = np.random.RandomState(5).randn(n, 3).astype(np.float32)
    rows_idx = np.asarray([0, 2, 4])
    got = device_large._rows_matvec(
        tm, torch.as_tensor(x), torch.as_tensor(s), torch.as_tensor(a),
        rows_idx, b, n).numpy()
    x_all = jnp.asarray(_pad_to_multiple(x, b))
    s_pad = np.ones(x_all.shape[0], np.float32)
    s_pad[:n] = s
    a_pad = np.zeros((x_all.shape[0], 3), np.float32)
    a_pad[:n] = a
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jdl._rows_matvec(
            jm, x_all, jnp.asarray(s_pad), jnp.asarray(a_pad), rows_idx, b,
            n, jsettings.snapshot()))
    assert got.shape == want.shape == (3 * b, 3)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ma = m @ a
    for pos, i in enumerate(rows_idx):
        hi = min(i * b + b, n)
        np.testing.assert_allclose(got[pos * b:pos * b + hi - i * b],
                                   ma[i * b:hi], rtol=2e-5, atol=2e-5)
    assert (got[2 * b + n - 4 * b:] == 0).all()


@pytest.mark.parametrize("nt,k", [(16, 2), (391, 8), (5, 5), (3, 7)])
def test_sample_row_blocks_match_jax(nt, k):
    for seed in range(6):
        np.testing.assert_array_equal(
            device_large._sample_row_blocks(nt, k, seed),
            jdl._sample_row_blocks(nt, k, seed))
    for n, b, rows in ((70, 16, 48), (50000, 128, 1024), (10, 16, 5)):
        assert (device_large._sample_block_count(n, b, rows)
                == jdl._sample_block_count(n, b, rows))


@pytest.mark.parametrize("n", [160, 150])
def test_sampled_residual_matches_jax(small, n):
    """_sampled_residual's four outputs against JAX's on the same inputs:
    the same sampled blocks, and (for a weight far from the solution, so
    the residual is arithmetic rather than float32 noise) the estimate,
    its bound and the max-row ratio within 1e-4.  n = 150 puts a short
    block in the draw (it stays out of the spread)."""
    jm, tm = small
    b = 16
    x, yl, _, _ = synthetic_arrays(n_train=n, n_test=0, shape=(1, 7, 7))
    k, s, _ = explicit_m(jm, x, b)
    s64 = 1.0 / np.sqrt(np.diagonal(k))
    ys = s64[:, None] * jsolve.one_hot_targets(yl)
    y_norm = np.linalg.norm(ys, axis=0)
    a64 = np.random.RandomState(3).randn(n, ys.shape[1]) * 0.01
    got = device_large._sampled_residual(
        tm, torch.as_tensor(x), torch.as_tensor(s), a64, ys, y_norm, b, n,
        64, 4)
    x_all = jnp.asarray(_pad_to_multiple(x, b))
    s_pad = np.ones(x_all.shape[0], np.float32)
    s_pad[:n] = s
    with jax.default_matmul_precision("highest"):
        want = jdl._sampled_residual(jm, x_all, jnp.asarray(s_pad), a64, ys,
                                     y_norm, b, n, jsettings.snapshot(), 64,
                                     4)
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        assert np.isfinite(g) and abs(g - w) <= 1e-4 * abs(w), (got, want)


@pytest.fixture(scope="module")
def classified(small):
    """One port and one JAX run of each residual check on the same data,
    with variances (n = 53: not a multiple of the tile or the block)."""
    jm, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=53, n_test=18,
                                              shape=(1, 7, 7), seed=9)
    out = {}
    for rc in ("full", "sampled"):
        kw = dict(batch_size=8, block=16, jitter=1e-4, variances=True,
                  residual_check=rc, residual_sample_rows=24,
                  residual_sample_seed=3, verbose=False)
        out[rc] = (classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                         device=CPU, **kw),
                   jcdl(jm, tr_x, tr_y, (te_x, te_y), mesh=make_mesh(
                       n_devices=1), **kw))
    kxx = np.asarray(jgram(jm, tr_x, batch_size=8, progress=False),
                     np.float64)
    kzx = np.asarray(jgram(jm, te_x, tr_x, batch_size=8, progress=False),
                     np.float64)
    kzz = np.asarray(jm(te_x, diag=True), np.float64)
    return out, (tr_y, te_y, kxx, kzx, kzz)


@pytest.mark.parametrize("rc", ["full", "sampled"])
def test_classify_large_matches_jax(classified, rc):
    """Identical predictions and accuracies, the same info keys and sampled
    blocks, log evidence within rtol 5e-4 and logdet within 1e-4 of JAX's
    and the float64 oracle's, variances within 1e-5 * mean(diag Kxx) of
    JAX's."""
    out, (tr_y, te_y, kxx, kzx, kzz) = classified
    (accs, info), (jaccs, jinfo) = out[rc]
    assert set(jinfo) == INFO_KEYS
    assert set(info) == INFO_KEYS | {"peak_bytes"}   # the port's own key
    assert info["peak_bytes"] == {}                  # none off the card
    assert accs == jaccs
    np.testing.assert_array_equal(info["predictions"][0],
                                  jinfo["predictions"][0])
    for key in ("n", "n_pad", "block", "refinements",
                "rel_residual_estimated", "residual_sample_seed"):
        assert info[key] == jinfo[key], key
    if rc == "sampled":
        np.testing.assert_array_equal(info["residual_sampled_blocks"],
                                      jinfo["residual_sampled_blocks"])
        assert info["rel_residual_estimated"] is True
    want_ev = jsolve.log_marginal_likelihood(
        kxx, jsolve.one_hot_targets(tr_y), jitter_rel=1e-4)
    for ev in (want_ev, jinfo["log_evidence"]):
        np.testing.assert_allclose(info["log_evidence"], ev, rtol=5e-4)
    np.testing.assert_allclose(info["logdet"], jinfo["logdet"], rtol=1e-4)
    dscale = float(np.mean(np.diagonal(kxx)))
    assert np.abs(info["variances"][0] - jinfo["variances"][0]).max() \
        < 1e-5 * dscale
    jr = 1e-4 * dscale
    want_var = jsolve.predictive_variance(kxx, kzx, kzz, jitter=jr)
    np.testing.assert_allclose(info["variances"][0], want_var,
                               atol=5e-6 * float(kzz.mean()), rtol=2e-4)
    np.testing.assert_allclose(info["scalings"], jinfo["scalings"],
                               rtol=1e-6)
    assert info["jitter_raw"] == pytest.approx(jr, rel=1e-6)
    assert set(info["timings_s"]) == set(jinfo["timings_s"])
    assert info["rel_residual"] < 1e-4


def test_classify_large_lpd_and_fused_scores(classified):
    """Scores riding the variance pass equal K_zx @ alpha (float64) to
    3e-5 of their max, and the held-out LPD from info matches the one-
    Cholesky float64 oracle (tests/test_device_large.py's bounds)."""
    out, (tr_y, te_y, kxx, kzx, kzz) = classified
    _, info = out["full"][0]
    want = kzx @ info["alpha"]
    np.testing.assert_allclose(info["scores"][0], want,
                               atol=3e-5 * np.abs(want).max())
    got_m, got_se, got_pp = jsolve.gaussian_lpd(
        info["scores"][0], info["variances"][0], te_y, info["jitter_raw"])
    want_m, want_se, want_pp = jsolve.log_predictive_density(
        kxx, kzx, kzz, tr_y, te_y, jitter_rel=1e-4)
    np.testing.assert_allclose(got_pp, want_pp, rtol=2e-3,
                               atol=2e-3 * np.abs(want_pp).mean())
    np.testing.assert_allclose(got_se, want_se, rtol=5e-3)


def test_classify_large_launch_counts(monkeypatch):
    """Every tile of a megakernel-shaped model goes through
    megakernel.pair_tile, once per tile: lower-manifest tiles, one full
    sweep for the exact check, the sampled block-rows times the column
    blocks, and the cross tiles of the split."""
    calls = []
    real = megakernel.pair_tile
    monkeypatch.setattr(megakernel, "pair_tile",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tm = from_jax_model(convnet_jax())
    n, b, nz = 40, 8, 12
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=n, n_test=nz,
                                              shape=(1, 7, 7), seed=2)
    nt, ntz = 5, 2
    for rc, kw in (("full", {}), ("sampled", {"tol": 1.0}),
                   ("variances", {"variances": True})):
        calls.clear()
        _, info = classify_device_large(
            tm, tr_x, tr_y, (te_x, te_y), batch_size=b, block=16,
            residual_check="full" if rc == "full" else "sampled",
            residual_sample_rows=16, residual_sample_seed=1, refine_iters=0,
            verbose=False, device=CPU, **kw)
        lower = nt * (nt + 1) // 2
        sweeps = 0 if info["rel_residual_estimated"] else lower
        sampled = 0 if info["rel_residual_sampled"] is None else 2 * nt
        assert len(calls) == lower + sweeps + sampled + nt * ntz, rc
    assert info["rel_residual_sampled"] is not None


def test_classify_large_paper_scale():
    """The paper ConvNet (~1e12 Gram values, its tiles on the megakernel's
    plain version) at n = 48: predictions equal to the float64 scipy
    solve's and the log evidence within rtol 5e-4 of the float64
    oracle."""
    import configs
    from cnn_gp_tpu_torch.configs import load
    jm = configs.load("mnist_paper_convnet_gp").initial_model
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=48, n_test=8,
                                              shape=(1, 28, 28), seed=13)
    accs, info = classify_device_large(
        load("mnist_paper_convnet_gp").initial_model, tr_x, tr_y,
        (te_x, te_y), batch_size=16, block=16, verbose=False, device=CPU)
    kxx = np.asarray(jgram(jm, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzx = np.asarray(jgram(jm, te_x, tr_x, batch_size=16, progress=False),
                     np.float64)
    assert kxx.flat[0] > 1e11
    y = jsolve.one_hot_targets(tr_y)
    a_ref = jsolve.solve_gp(kxx.copy(), y, method="scipy")
    np.testing.assert_array_equal(info["predictions"][0],
                                  jsolve.predict(kzx, a_ref))
    np.testing.assert_allclose(info["log_evidence"],
                               jsolve.log_marginal_likelihood(kxx, y),
                               rtol=5e-4)


# -- counterparts of tests/test_device_large.py ----------------------------

def test_classify_large_padding_edges(small):
    """N not divisible by the tile or the block, tile cover beyond the
    factor grid: predictions equal to scipy's at the relative jitter."""
    jm, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=37, n_test=9,
                                              shape=(1, 7, 7), seed=3)
    _, info = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                    batch_size=16, block=8, jitter=1e-6,
                                    verbose=False, device=CPU)
    assert info["rel_residual"] < 1e-4
    assert info["n_pad"] % 16 == 0 and info["n_pad"] % 8 == 0
    kxx = np.asarray(jgram(jm, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzx = np.asarray(jgram(jm, te_x, tr_x, batch_size=16, progress=False),
                     np.float64)
    a_ref = jsolve.solve_gp(kxx, jsolve.one_hot_targets(tr_y),
                            jitter=1e-6 * float(np.mean(np.diagonal(kxx))),
                            method="scipy")
    np.testing.assert_array_equal(info["predictions"][0],
                                  jsolve.predict(kzx, a_ref))


def test_classify_large_floor_tol(small):
    """A tol above the achieved residual runs no refinement sweep (the
    unrefined residual is still measured); an unreachable tol is bounded
    by the cap."""
    _, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=48, n_test=8,
                                              shape=(1, 7, 7), seed=7)
    kw = dict(batch_size=16, block=16, verbose=False, device=CPU)
    _, info = classify_device_large(tm, tr_x, tr_y, (te_x, te_y), tol=1.0,
                                    refine_iters=3, **kw)
    assert info["refinements"] == 0
    assert info["rel_residual"] == info["rel_residual_unrefined"] > 0.0
    _, info2 = classify_device_large(tm, tr_x, tr_y, (te_x, te_y), tol=0.0,
                                     refine_iters=2, **kw)
    assert info2["refinements"] <= 2
    assert info2["rel_residual"] <= info2["rel_residual_unrefined"]


def test_sampled_residual_escalates(small):
    """Below tol the sampled check escalates: corrections come from exact
    residuals, and predictions equal the always-exact run's."""
    _, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=48, n_test=8,
                                              shape=(1, 7, 7), seed=7)
    kw = dict(batch_size=16, block=16, tol=0.0, refine_iters=2,
              verbose=False, device=CPU)
    _, info = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                    residual_check="sampled", **kw)
    assert info["refinements"] >= 1
    assert info["rel_residual_sampled"] is not None
    assert info["rel_residual"] <= info["rel_residual_unrefined"]
    if info["rel_residual_estimated"]:
        assert info["rel_residual"] == info["rel_residual_sampled"]
    _, info_f = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="full", **kw)
    assert info_f["rel_residual_estimated"] is False
    np.testing.assert_array_equal(info["predictions"][0],
                                  info_f["predictions"][0])


def test_sampled_accept_and_skip(small):
    """A clearing tol accepts on the sample (an estimate, no refinement,
    the predictions of the exact run, the estimate within 10x of the exact
    residual); with fewer than 2 full sampled blocks the sampled pass is
    skipped and the exact check runs."""
    _, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=160, n_test=16,
                                              shape=(1, 7, 7), seed=21)
    kw = dict(batch_size=16, block=16, tol=1.0, refine_iters=3,
              verbose=False, device=CPU)
    _, info_s = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="sampled",
                                      residual_sample_rows=48,
                                      residual_sample_seed=0, **kw)
    _, info_f = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="full", **kw)
    assert info_s["rel_residual_estimated"] is True
    assert info_s["refinements"] == 0
    assert info_s["rel_residual"] == info_s["rel_residual_sampled"] > 0.0
    np.testing.assert_array_equal(info_s["predictions"][0],
                                  info_f["predictions"][0])
    assert 0.1 < info_s["rel_residual"] / info_f["rel_residual"] < 10.0
    _, info_k = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="sampled",
                                      residual_sample_rows=16, **kw)
    assert info_k["rel_residual_sampled"] is None
    assert info_k["rel_residual_estimated"] is False


def test_residual_accept_frac_gates_the_sweep(small):
    """The bound at 0.8 * tol: frac 0.9 accepts, frac 0.5 escalates, both
    with the same predictions."""
    _, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=160, n_test=16,
                                              shape=(1, 7, 7), seed=21)
    kw = dict(batch_size=16, block=16, refine_iters=0,
              residual_check="sampled", residual_sample_rows=48,
              residual_sample_seed=0, verbose=False, device=CPU)
    _, probe = classify_device_large(tm, tr_x, tr_y, (te_x, te_y), tol=1.0,
                                     **kw)
    est, ucb = (probe["rel_residual_sampled"],
                probe["rel_residual_sampled_ucb"])
    assert np.isfinite(ucb) and ucb >= est > 0.0
    tol = ucb / 0.8
    _, hi = classify_device_large(tm, tr_x, tr_y, (te_x, te_y), tol=tol,
                                  residual_accept_frac=0.9, **kw)
    _, lo = classify_device_large(tm, tr_x, tr_y, (te_x, te_y), tol=tol,
                                  residual_accept_frac=0.5, **kw)
    assert hi["rel_residual_estimated"] is True and hi["refinements"] == 0
    assert lo["rel_residual_estimated"] is False
    np.testing.assert_array_equal(hi["predictions"][0],
                                  lo["predictions"][0])


@pytest.mark.parametrize("kwargs,match", [
    ({"residual_check": "bogus"}, "residual_check"),
    ({"residual_accept_frac": 0.0}, "residual_accept_frac"),
    ({"residual_accept_frac": -0.1}, "residual_accept_frac"),
    ({"residual_accept_frac": 1.5}, "residual_accept_frac"),
    ({"residual_max_row_gate": 1.0}, "residual_max_row_gate"),
])
def test_validation_errors(kwargs, match):
    """The JAX function's validation errors, raised before any work."""
    x = np.zeros((4, 1, 7, 7))
    with pytest.raises(ValueError, match=match):
        classify_device_large(None, x, np.zeros(4), device=CPU, **kwargs)
    with pytest.raises(ValueError, match=match):
        jcdl(None, x, np.zeros(4), **kwargs)


def test_empty_split_variances(small):
    _, tm = small
    tr_x, tr_y, te_x, te_y = synthetic_arrays(n_train=24, n_test=8,
                                              shape=(1, 7, 7), seed=4)
    _, info = classify_device_large(tm, tr_x, tr_y, (te_x[:0], te_y[:0]),
                                    (te_x, te_y), batch_size=8, block=8,
                                    jitter=1e-6, variances=True,
                                    verbose=False, device=CPU)
    assert info["variances"][0].shape == (0,)
    assert info["variances"][1].shape == (8,)
    assert np.isfinite(info["variances"][1]).all()
    assert len(info["predictions"][0]) == 0


def _corrupt_one_assembly_tile(monkeypatch, i_bad, j_bad, b, eps):
    """Add ``eps`` to ONE lower tile after the real assembly: the factor
    decomposes M + E while the regeneration matvec measures the true M, so
    the residual ``E a`` is confined to block-rows i_bad and j_bad."""
    real = device_large._assemble_scaled

    def corrupt(*args, **kw):
        k = real(*args, **kw)
        k[i_bad * b:(i_bad + 1) * b, j_bad * b:(j_bad + 1) * b] += eps
        return k

    monkeypatch.setattr(device_large, "_assemble_scaled", corrupt)


@pytest.fixture(scope="module")
def injected_data():
    return synthetic_arrays(n_train=256, n_test=8, shape=(1, 7, 7), seed=13)


def test_injected_tile_error_detection_randomized(small, monkeypatch,
                                                  injected_data):
    """One corrupted assembly tile: seed by seed, the sampled gate
    escalates exactly when its sample meets the corrupted block-rows (JAX's
    draw for the same seed), and accepts otherwise."""
    _, tm = small
    n, b = 256, 16
    i_bad, j_bad = 6, 3
    tr_x, tr_y, te_x, te_y = injected_data
    kw = dict(batch_size=b, block=16, jitter=1e-2, refine_iters=0,
              verbose=False, device=CPU)
    _, info_h = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="full", **kw)
    _corrupt_one_assembly_tile(monkeypatch, i_bad, j_bad, b, eps=1e-4)
    _, info_c = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                      residual_check="full", **kw)
    assert info_c["rel_residual"] > 30 * info_h["rel_residual"]
    tol = float(np.sqrt(info_h["rel_residual"] * info_c["rel_residual"]))
    hits = misses = 0
    for seed in range(12):
        sample = set(jdl._sample_row_blocks(16, 2, seed).tolist())
        _, info = classify_device_large(
            tm, tr_x, tr_y, (te_x, te_y), tol=tol, residual_check="sampled",
            residual_sample_rows=32, residual_sample_seed=seed, **kw)
        assert set(info["residual_sampled_blocks"].tolist()) == sample
        detected = not info["rel_residual_estimated"]
        assert detected == bool(sample & {i_bad, j_bad}), seed
        if detected:
            hits += 1
            assert info["rel_residual"] > tol
        else:
            misses += 1
            assert info["rel_residual_sampled"] < tol
    assert hits >= 1 and misses >= 1


def test_injected_small_error_caught_by_max_row_gate(small, monkeypatch,
                                                     injected_data):
    """A localized corruption small enough for the mean-square bound to
    accept is caught by the max-row statistic; with the gate off it is
    accepted, and a sample that misses it accepts."""
    _, tm = small
    _corrupt_one_assembly_tile(monkeypatch, 9, 3, 16, eps=1e-4)
    tr_x, tr_y, te_x, te_y = injected_data
    kw = dict(batch_size=16, block=16, jitter=1e-2, refine_iters=0,
              residual_check="sampled", residual_sample_rows=64, tol=1.0,
              verbose=False, device=CPU)
    _, hit = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                   residual_sample_seed=2, **kw)
    assert hit["rel_residual_estimated"] is False
    assert hit["rel_residual_maxrow_ratio"] > 1e4
    assert hit["rel_residual_sampled_ucb"] <= 1.0
    _, off = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                   residual_sample_seed=2,
                                   residual_max_row_gate=1e12, **kw)
    assert off["rel_residual_estimated"] is True
    _, miss = classify_device_large(tm, tr_x, tr_y, (te_x, te_y),
                                    residual_sample_seed=0, **kw)
    assert miss["rel_residual_estimated"] is True
    assert miss["rel_residual_maxrow_ratio"] < 50.0


def test_assemble_lower_and_identity_pad(small):
    """The assembled buffer: the explicit M's lower triangle, an exact
    identity pad block, nothing written a full tile above the diagonal."""
    jm, tm = small
    n, b = 43, 8
    x, _, _, _ = synthetic_arrays(n_train=n, n_test=0, shape=(1, 7, 7))
    _, s, m = explicit_m(jm, x, b)
    got = device_large._assemble_scaled(tm, torch.as_tensor(x),
                                        torch.as_tensor(s), b, n, 48).numpy()
    np.testing.assert_allclose(np.tril(got[:n, :n]), np.tril(m), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got[n:], np.eye(48, dtype=np.float32)[n:])
    assert (np.triu(got, 1)[:, n:] == 0).all()
    assert (np.triu(got, 8) == 0).all()

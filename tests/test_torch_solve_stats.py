"""The port's posterior statistics (cnn_gp_tpu_torch.ops.solve) against
the JAX package's float64 host oracles, the classify_gp --variances /
--evidence / --lpd driver on a store written by the port's save_kernel,
and settings.snapshot() against the JAX package's."""

import re
import types

import numpy as np
import pytest

import cnn_gp_tpu_torch as T
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu_torch import settings as tsettings
from cnn_gp_tpu_torch.data import DatasetFromConfig, GramStore
from cnn_gp_tpu_torch.exp_mnist_resnet import classify_gp, save_kernel
from cnn_gp_tpu_torch.ops import solve as tsolve

RTOL = 1e-10      # both packages run the same float64 numpy/scipy code


def spd_problem(seed=0, n=40, nz=12, c=4):
    """A Gram-like SPD system with a ~1e12 diagonal, as paper Grams have."""
    rng = np.random.RandomState(seed)
    f = rng.randn(n + nz, 3 * n)
    k = (f @ f.T) * 1e10
    kxx, kzx, kzz = k[:n, :n], k[n:, :n], np.diagonal(k[n:, n:]).copy()
    labels = rng.randint(0, c, n)
    test_labels = rng.randint(0, c, nz)
    return kxx, kzx, kzz, labels, test_labels


def close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-300)


def _predictive_variance(M, p):
    kxx, kzx, kzz, _, _ = p
    return M.predictive_variance(kxx, kzx, kzz,
                                 jitter=1e-3 * np.mean(np.diagonal(kxx)))


def _gaussian_lpd(M, p):
    _, kzx, kzz, _, test_labels = p
    rng = np.random.RandomState(1)
    scores = rng.randn(len(kzx), 4)
    var = np.abs(rng.randn(len(kzx)))
    mean, se, per_point = M.gaussian_lpd(scores, var, test_labels, 0.1)
    return np.concatenate([[mean, se], per_point])


def _log_predictive_density(M, p):
    kxx, kzx, kzz, labels, test_labels = p
    mean, se, per_point = M.log_predictive_density(
        kxx, kzx, kzz, labels, test_labels, jitter_rel=1e-3)
    return np.concatenate([[mean, se], per_point])


def _log_marginal_likelihood(M, p):
    kxx, _, _, labels, _ = p
    return M.log_marginal_likelihood(kxx, M.one_hot_targets(labels),
                                     jitter_rel=1e-3)


def _solve_gp_stats(M, p):
    kxx, kzx, kzz, labels, _ = p
    st = M.solve_gp_stats(kxx.copy(), M.one_hot_targets(labels),
                          jitter=1e-3 * np.mean(np.diagonal(kxx)),
                          splits=[(kzx, kzz), (kzx[:5], kzz[:5])])
    return np.concatenate([st["alpha"].ravel(), *st["variances"],
                           [st["log_evidence"]]])


STATS = {f.__name__[1:]: f for f in (
    _predictive_variance, _gaussian_lpd, _log_predictive_density,
    _log_marginal_likelihood, _solve_gp_stats)}


@pytest.mark.parametrize("name", sorted(STATS))
def test_stats_match_jax(name):
    p = spd_problem()
    got = STATS[name](tsolve, p)
    want = STATS[name](jsolve, p)
    close(got, want)


def test_gaussian_lpd_refusals():
    for M in (tsolve, jsolve):
        with pytest.raises(ValueError, match="non-positive"):
            M.gaussian_lpd(np.zeros((2, 3)), np.zeros(2), [0, 1], 0.0)
        with pytest.raises(ValueError, match="labels imply"):
            M.gaussian_lpd(np.zeros((2, 3)), np.ones(2), [0, 1], 0.0,
                           n_classes=4)


def test_snapshot_matches_jax():
    """The snapshot a posterior records compares equal across packages,
    under the defaults and under a changed setting."""
    assert repr(tsettings.snapshot()) == repr(jsettings.snapshot())
    with tsettings.override(acos_impl="exact"), \
            jsettings.override(acos_impl="exact"):
        assert repr(tsettings.snapshot()) == repr(jsettings.snapshot())
    assert tsettings.snapshot() != tuple(
        "exact" if v == "poly" else v for v in tsettings.snapshot())


def tiny_config():
    """2 x [3x3 conv, ReLU] + readout on 14x14 synthetic data, 64/24/24."""
    return types.SimpleNamespace(
        dataset_name="synthetic", in_channels=1, transforms=[],
        train_range=range(0, 64), validation_range=range(64, 88),
        test_range=range(88, 112),
        initial_model=T.Sequential(
            T.Conv2d(3, var_weight=2.79 * 9, var_bias=7.86), T.ReLU(),
            T.Conv2d(3, var_weight=2.79 * 9, var_bias=7.86), T.ReLU(),
            T.Conv2d(28, padding=0, var_weight=2.79, var_bias=7.86)))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stats")
    cfg = tiny_config()
    path = str(tmp / "k.h5")
    save_kernel.run(cfg, path, datasets_path=str(tmp), device="cpu",
                    batch_size=32)
    return cfg, path, str(tmp)


JITTER = 1e9      # absolute: ~1e-3 of the ~1e12 diagonal


def test_classify_gp_stats_match_jax(store, capsys):
    """--variances --evidence --lpd through run(): std, evidence and LPD
    equal the JAX oracles on the same stored arrays (1e-10 relative; the
    printed values to their printed digits)."""
    cfg, path, root = store
    res = classify_gp.run(cfg, path, datasets_path=root, jitter=JITTER,
                          variances=True, evidence=True, lpd=True)
    out = capsys.readouterr().out
    ds = DatasetFromConfig(root, cfg)
    with GramStore(path, "r") as f:
        kxx = jsolve.symmetrize_from_upper(f.read("Kxx", dtype=np.float64))
        kzx = {"validation": f.read("Kxvx"), "test": f.read("Kxtx")}
        kzz = {"validation": f.read("Kv_diag"), "test": f.read("Kt_diag")}
    y = jsolve.one_hot_targets(ds.train.labels)
    jx = kxx.copy()
    jsolve.diag_add(jx, JITTER)
    ev = jsolve.log_marginal_likelihood(jx, y)
    close(res["log_evidence"], ev)
    assert f"train log evidence: {ev:.6g}" in out
    a = jsolve.solve_gp(kxx.copy(), y, jitter=JITTER, method="scipy")
    for split in ("validation", "test"):
        labels = getattr(ds, split).labels
        var = jsolve.predictive_variance(kxx, kzx[split], kzz[split],
                                         jitter=JITTER)
        close(res["variances"][split], var)
        scores = np.asarray(kzx[split], np.float64) @ a
        mean, se, _ = jsolve.gaussian_lpd(scores, var, labels, JITTER)
        assert abs(res["lpd"][split][0] - mean) <= 1e-8 * abs(mean)
        assert abs(res["lpd"][split][1] - se) <= 1e-8 * abs(se)
        assert f"{split} lpd: {mean:.4f} +- {se:.4f} nats/point" in out
        std = np.sqrt(var)
        assert (f"{split} predictive std: mean {std.mean():.4e}  "
                f"min {std.min():.4e}  max {std.max():.4e}") in out
        acc, pred = res[split]
        np.testing.assert_array_equal(pred, np.argmax(scores, axis=1))
        assert f"{split} accuracy: {acc * 100}%" in out


@pytest.mark.parametrize("flag", ["variances", "evidence", "lpd"])
def test_stats_flags_refuse_chol_before_reading(flag, monkeypatch):
    """--solver=chol with a stats flag is refused before the store is
    opened (JAX refuses every solver but scipy and chol_dist)."""
    monkeypatch.setattr(classify_gp, "open_store", None)
    with pytest.raises(ValueError, match="--solver=scipy"):
        classify_gp.run(tiny_config(), "absent.h5", datasets_path="",
                        solver="chol", jitter=1.0, **{flag: True})
    with pytest.raises(SystemExit):
        classify_gp.main(["--in_path=absent.h5", "--solver=chol",
                          f"--{flag}", "--jitter=1", "--device=cpu"])


def test_lpd_with_zero_jitter_refused_before_solve(store, monkeypatch):
    """--lpd without noise is refused up front, not after the solve."""
    cfg, path, root = store

    def no_solve(*a, **k):
        raise AssertionError("solved before refusing")

    monkeypatch.setattr(tsolve, "solve_gp_stats", no_solve)
    monkeypatch.setattr(classify_gp, "open_store", None)
    with pytest.raises(ValueError, match="--jitter > 0"):
        classify_gp.run(cfg, path, datasets_path=root, lpd=True)
    with pytest.raises(SystemExit):
        classify_gp.main([f"--in_path={path}", "--lpd", "--device=cpu"])


def test_lpd_alone_prints_no_evidence_and_scores_once(store, capsys,
                                                      monkeypatch):
    """--lpd alone reports the LPD but not the evidence, and each split is
    scored once (one accuracy and one LPD per split)."""
    cfg, path, root = store
    calls = {"accuracy": 0, "gaussian_lpd": 0}
    for name in calls:
        real = getattr(tsolve, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(tsolve, name, counted)
    res = classify_gp.run(cfg, path, datasets_path=root, jitter=JITTER,
                          lpd=True)
    out = capsys.readouterr().out
    assert "log evidence" not in out and "log_evidence" not in res
    assert "predictive std" not in out
    assert len(re.findall(r"(validation|test) lpd: ", out)) == 2
    assert calls == {"accuracy": 2, "gaussian_lpd": 2}

"""The port's posterior serving (cnn_gp_tpu_torch.serving) against the JAX
package's: a posterior solved by JAX's classify_device_large on the
8-device CPU mesh and saved by JAX's save_posterior is served by the
port's GPPredictor with the same predictions, and a posterior the port
saves loads in JAX's load_posterior; the on-disk factor cache loads both
ways."""

import jax
import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu import serving as jserving
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import classify_device_large, gram_in_memory
from cnn_gp_tpu_torch import serving as tserving
from cnn_gp_tpu_torch import settings
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.serving import (FORMAT_VERSION, GPPredictor,
                                      load_posterior, save_posterior)

CPU = torch.device("cpu")


def jmodel():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(3), G.ReLU(),
                        G.Conv2d(8, padding=0))


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """One JAX classify_device_large run, its posterior saved by JAX, and
    the float64 Grams of the same data."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh of tests/conftest.py")
    from cnn_gp_tpu.parallel import make_mesh
    x, y, zx, zy = synthetic_arrays(n_train=96, n_test=32, shape=(1, 8, 8),
                                    n_classes=4)
    jm = jmodel()
    accs, info = classify_device_large(jm, x, y, (zx, zy), batch_size=16,
                                       block=32, jitter=1e-6,
                                       mesh=make_mesh(), verbose=False)
    path = jserving.save_posterior(
        tmp_path_factory.mktemp("posterior") / "p", train_x=x,
        alpha=info["alpha"], scalings=info["scalings"],
        jitter_raw=info["jitter_raw"], config_name="unit-test")
    kxx = np.asarray(gram_in_memory(jm, x, batch_size=16, progress=False),
                     np.float64)
    kzx = np.asarray(gram_in_memory(jm, zx, x, batch_size=16,
                                    progress=False), np.float64)
    kzz = np.asarray(jm(zx, diag=True), np.float64)
    return dict(x=x, zx=zx, info=info, path=path, kxx=kxx, kzx=kzx, kzz=kzz,
                model=from_jax_model(jm))


def test_jax_posterior_loads_with_equal_fields(solved):
    p = load_posterior(solved["path"])
    j = jserving.load_posterior(solved["path"])
    np.testing.assert_array_equal(p.train_x, solved["x"])
    np.testing.assert_array_equal(p.alpha, solved["info"]["alpha"])
    np.testing.assert_array_equal(p.scalings, solved["info"]["scalings"])
    assert (p.jitter_raw, p.config_name, p.settings_snapshot, p.n) == (
        j.jitter_raw, j.config_name, j.settings_snapshot, j.n)


def test_jax_posterior_served_identically(solved):
    """The port classifies exactly as the JAX run predicted, and its scores
    are within 2e-5 of max|Kzx alpha| (float64) (tests/test_serving.py's
    bound)."""
    p = load_posterior(solved["path"])
    pred = GPPredictor(solved["model"], p, batch_size=16, device=CPU)
    np.testing.assert_array_equal(pred.classify(solved["zx"]),
                                  solved["info"]["predictions"][0])
    want = solved["kzx"] @ p.alpha
    got = pred.scores(solved["zx"])
    assert np.max(np.abs(got - want)) < 2e-5 * np.abs(want).max()


def test_served_variances_match_oracle(solved):
    """prepare_variances rebuilds the factor without a solve; the variances
    match the float64 oracle on the same jittered system within
    1e-5 * mean(diag Kxx) (tests/test_serving.py's bound)."""
    p = load_posterior(solved["path"])
    pred = GPPredictor(solved["model"], p, batch_size=16, device=CPU)
    pred.prepare_variances()
    got = pred.variances(solved["zx"])
    want = jsolve.predictive_variance(solved["kxx"], solved["kzx"],
                                      solved["kzz"], jitter=p.jitter_raw)
    assert np.max(np.abs(got - want)) < 1e-5 * np.mean(
        np.diagonal(solved["kxx"]))
    assert (got >= 0).all()


def test_port_posterior_loads_in_jax(solved, tmp_path):
    info = solved["info"]
    path = save_posterior(tmp_path / "port", train_x=solved["x"],
                          alpha=info["alpha"], scalings=info["scalings"],
                          jitter_raw=info["jitter_raw"],
                          config_name="unit-test")
    assert path.endswith(".npz")
    j = jserving.load_posterior(path)
    np.testing.assert_array_equal(j.train_x, solved["x"])
    np.testing.assert_array_equal(j.alpha, info["alpha"])
    np.testing.assert_array_equal(j.scalings, info["scalings"])
    assert j.jitter_raw == info["jitter_raw"]
    assert j.config_name == "unit-test"
    assert j.settings_snapshot == repr(jsettings.snapshot())
    jserving.GPPredictor(jmodel(), j)     # JAX accepts the port's snapshot
    with np.load(path) as a, np.load(solved["path"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k


def test_newer_format_refused(solved, tmp_path):
    data = dict(np.load(solved["path"], allow_pickle=False))
    data["format_version"] = np.int64(FORMAT_VERSION + 1)
    np.savez(tmp_path / "future.npz", **data)
    with pytest.raises(ValueError, match="newer"):
        load_posterior(tmp_path / "future.npz")


def test_save_refusals(tmp_path):
    """Bad alpha rank, length mismatch and a wrong scalings shape are
    refused at save time, with the JAX package's messages."""
    x = np.zeros((4, 1, 5, 5), np.float32)
    a = np.zeros((4, 3))
    for mod in (jserving, tserving):
        with pytest.raises(ValueError, match="n_classes"):
            mod.save_posterior(tmp_path / "r1", train_x=x, alpha=np.zeros(4))
        with pytest.raises(ValueError, match="length mismatch"):
            mod.save_posterior(tmp_path / "r2", train_x=x, alpha=a[:2])
        with pytest.raises(ValueError, match="scalings shape"):
            mod.save_posterior(tmp_path / "r3", train_x=x, alpha=a,
                               scalings=np.ones(3))


def test_scalings_missing_refused(tmp_path):
    """A means-only posterior serves scores; prepare_variances refuses it,
    and variances() before prepare_variances() is refused."""
    x = np.zeros((4, 1, 5, 5), np.float32)
    p = load_posterior(save_posterior(tmp_path / "m", train_x=x,
                                      alpha=np.zeros((4, 3))))
    assert p.scalings is None
    pred = GPPredictor(from_jax_model(G.Sequential(G.Conv2d(5, padding=0))),
                       p, device=CPU)
    assert pred.scores(x).shape == (4, 3)
    with pytest.raises(ValueError, match="scalings"):
        pred.prepare_variances()
    with pytest.raises(RuntimeError, match="prepare_variances"):
        pred.variances(x)


def test_settings_mismatch_refused(solved, tmp_path):
    """A posterior saved by JAX under acos_impl='exact' is a different
    kernel: refused under the port's defaults unless overridden, and
    served when the port matches the setting."""
    info = solved["info"]
    with jsettings.override(acos_impl="exact"):
        path = jserving.save_posterior(
            tmp_path / "exact", train_x=solved["x"], alpha=info["alpha"],
            scalings=info["scalings"], jitter_raw=info["jitter_raw"])
    p = load_posterior(path)
    with pytest.raises(ValueError, match="lowering settings"):
        GPPredictor(solved["model"], p, device=CPU)
    GPPredictor(solved["model"], p, allow_settings_mismatch=True,
                device=CPU)
    with settings.override(acos_impl="exact"):
        GPPredictor(solved["model"], p, device=CPU)


def _port_predictor(solved, p=None):
    p = p or load_posterior(solved["path"])
    return GPPredictor(solved["model"], p, batch_size=16, device=CPU)


def _no_rebuild(monkeypatch, module):
    """Make a rebuild of the factor fail, to show a cache was loaded."""
    def refuse(*a, **k):
        raise AssertionError("the factor was rebuilt, not loaded")
    monkeypatch.setattr(module, "rebuild_factor", refuse)


def test_factor_cache_round_trip(solved, tmp_path):
    """prepare_variances writes the JAX package's three files; a fresh
    predictor loads them without a rebuild and serves bit-identical
    variances."""
    from cnn_gp_tpu_torch.parallel import device_large
    cache = str(tmp_path / "fc")
    first = _port_predictor(solved)
    first.prepare_variances(block=32, factor_cache=cache)
    want = first.variances(solved["zx"])
    assert sorted(p.name for p in (tmp_path / "fc").iterdir()) == [
        "diags.npy", "l.npy", "meta.json"]
    l = np.load(tmp_path / "fc" / "l.npy")
    assert l.shape == (96, 96) and (np.triu(l, 1) == 0).all()
    assert np.load(tmp_path / "fc" / "diags.npy").shape == (3, 32, 32)
    second = _port_predictor(solved)
    mp = pytest.MonkeyPatch()
    with mp.context() as m:
        _no_rebuild(m, device_large)
        second.prepare_variances(block=32, factor_cache=cache)
    np.testing.assert_array_equal(second.variances(solved["zx"]), want)


@pytest.mark.parametrize("change", ["block", "meta", "batch_size"])
def test_factor_cache_mismatch_refused(solved, tmp_path, change):
    """A present cache that does not match is refused, never rebuilt."""
    import json
    cache = tmp_path / "fc"
    _port_predictor(solved).prepare_variances(block=32,
                                              factor_cache=str(cache))
    pred = _port_predictor(solved)
    block = 32
    if change == "block":
        block = 16
    elif change == "batch_size":
        pred.batch_size = 32
    else:
        meta = json.loads((cache / "meta.json").read_text())
        meta["posterior_sha256"] = "0" * 64
        (cache / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="does not match"):
        pred.prepare_variances(block=block, factor_cache=str(cache))
    assert pred._factor is None


def test_jax_written_cache_loads_in_port(solved, tmp_path, monkeypatch):
    """A cache that JAX writes on a one-device mesh loads in the port
    (no rebuild) and serves JAX's variances within 1e-5 * mean(diag
    Kxx)."""
    from cnn_gp_tpu.parallel import make_mesh
    from cnn_gp_tpu_torch.parallel import device_large
    cache = str(tmp_path / "fc")
    jp = jserving.load_posterior(solved["path"])
    jpred = jserving.GPPredictor(jmodel(), jp, batch_size=16)
    jpred.prepare_variances(mesh=make_mesh(n_devices=1), block=32,
                            factor_cache=cache)
    want = jpred.variances(solved["zx"])
    pred = _port_predictor(solved)
    _no_rebuild(monkeypatch, device_large)
    pred.prepare_variances(block=32, factor_cache=cache)
    got = pred.variances(solved["zx"])
    assert np.abs(got - want).max() < 1e-5 * np.mean(
        np.diagonal(solved["kxx"]))


def test_port_written_cache_loads_in_jax(solved, tmp_path, monkeypatch):
    """A cache the port writes loads in JAX on a one-device mesh (no
    rebuild) and serves the port's variances within 1e-5 * mean(diag
    Kxx)."""
    from cnn_gp_tpu.parallel import device_large as jdl
    from cnn_gp_tpu.parallel import make_mesh
    cache = str(tmp_path / "fc")
    pred = _port_predictor(solved)
    pred.prepare_variances(block=32, factor_cache=cache)
    want = pred.variances(solved["zx"])
    jpred = jserving.GPPredictor(jmodel(),
                                 jserving.load_posterior(solved["path"]),
                                 batch_size=16)
    _no_rebuild(monkeypatch, jdl)
    jpred.prepare_variances(mesh=make_mesh(n_devices=1), block=32,
                            factor_cache=cache)
    got = jpred.variances(solved["zx"])
    assert np.abs(got - want).max() < 1e-5 * np.mean(
        np.diagonal(solved["kxx"]))


def _learnable(M):
    return M.Sequential(M.Conv2d(3, var_weight=1.3, learnable=True), M.ReLU(),
                        M.Conv2d(8, padding=0, var_bias=0.2, learnable=True))


def _mixture(M):
    return M.Mixture([M.Sequential(M.Conv2d(8, padding=0, learnable=True)),
                      M.Sequential(M.Conv2d(3), M.ReLU(),
                                   M.Conv2d(8, padding=0))],
                     np.asarray([0.3, -0.2], np.float32))


@pytest.mark.parametrize("which", ["learnable", "mixture", "paper"])
def test_cache_meta_matches_jax(which, tmp_path):
    """The cache identity, model_sha256 included, is JAX's for the same
    posterior and model: the port hashes the keys and bytes that
    jax.tree_util.tree_flatten_with_path gives for the JAX model."""
    import configs as jconfigs
    from cnn_gp_tpu_torch import configs
    if which == "paper":
        jm = jconfigs.load("mnist_paper_convnet_gp").initial_model
        tm = configs.load("mnist_paper_convnet_gp").initial_model
    else:
        build = {"learnable": _learnable, "mixture": _mixture}[which]
        jm, tm = build(G), build(T)
    rng = np.random.RandomState(0)
    x = rng.randn(5, 1, 8, 8).astype(np.float32)
    path = save_posterior(tmp_path / "p", train_x=x, alpha=rng.randn(5, 2),
                          scalings=rng.rand(5))
    want = jserving.GPPredictor(jm, jserving.load_posterior(path),
                                batch_size=16)._cache_meta(32, 1)
    got = GPPredictor(tm, load_posterior(path), batch_size=16,
                      device=CPU)._cache_meta(32)
    assert got == want
    if which != "paper":
        assert jax.tree_util.tree_leaves(jm)      # the hash covers leaves


def test_empty_query_batches(solved):
    p = load_posterior(solved["path"])
    pred = GPPredictor(solved["model"], p, batch_size=16, device=CPU)
    empty = np.zeros((0,) + p.train_x.shape[1:], np.float32)
    assert pred.scores(empty).shape == (0, p.alpha.shape[1])
    assert pred.classify(empty).shape == (0,)
    pred.prepare_variances()
    assert pred.variances(empty).shape == (0,)

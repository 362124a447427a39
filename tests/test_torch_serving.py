"""The port's posterior serving (cnn_gp_tpu_torch.serving) against the JAX
package's: a posterior solved by JAX's classify_device_large on the
8-device CPU mesh and saved by JAX's save_posterior is served by the
port's GPPredictor with the same predictions, and a posterior the port
saves loads in JAX's load_posterior."""

import jax
import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
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


def test_factor_cache_refused(solved, tmp_path):
    p = load_posterior(solved["path"])
    pred = GPPredictor(solved["model"], p, batch_size=16, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pred.prepare_variances(factor_cache=str(tmp_path / "fc"))
    assert pred._factor is None
    assert not (tmp_path / "fc").exists()


def test_empty_query_batches(solved):
    p = load_posterior(solved["path"])
    pred = GPPredictor(solved["model"], p, batch_size=16, device=CPU)
    empty = np.zeros((0,) + p.train_x.shape[1:], np.float32)
    assert pred.scores(empty).shape == (0, p.alpha.shape[1])
    assert pred.classify(empty).shape == (0,)
    pred.prepare_variances()
    assert pred.variances(empty).shape == (0,)

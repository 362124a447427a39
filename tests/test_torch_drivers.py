"""The port's classify_e2e and serve_gp drivers, run in process on the
synthetic config (its ranges cut to 96/32/32 so that the CPU run stays
short), against the JAX package's functions on the same arrays; and the
port's mnist config against the JAX package's."""

import re

import numpy as np
import pytest
import torch

from cnn_gp_tpu import serving as jserving
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import classify_device as jclassify
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.exp_mnist_resnet import classify_e2e, serve_gp
from cnn_gp_tpu_torch.ops import solve as tsolve
from cnn_gp_tpu_torch.parallel import gram_device
from cnn_gp_tpu_torch.serving import save_posterior

CPU = torch.device("cpu")
B = 32
STD_RTOL = 1e-3   # printed std (4 significant digits) against the oracle


@pytest.fixture()
def synthetic(monkeypatch):
    """The synthetic config with 96 train, 32 validation, 32 test points,
    its dataset, and the JAX counterpart of its model."""
    import configs as jconfigs
    cfg = configs.load("synthetic")
    for name, r in (("train_range", range(0, 96)),
                    ("validation_range", range(96, 128)),
                    ("test_range", range(128, 160))):
        monkeypatch.setattr(cfg, name, r)
    return cfg, DatasetFromConfig("", cfg), jconfigs.load(
        "synthetic").initial_model


def parse(out):
    accs = {m.group(1): float(m.group(2)) / 100 for m in re.finditer(
        r"^(validation|test) accuracy: ([\d.]+)%", out, re.M)}
    stds = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(validation|test) predictive std: mean ([\d.e+-]+)", out, re.M)}
    return accs, stds


def oracle(ds, jm, jitter_raw, alpha=None):
    """float64 accuracies (from ``alpha``, or the scipy solve) and mean
    predictive std per split."""
    kxx = np.asarray(jgram(jm, ds.train.images, batch_size=B,
                           progress=False), np.float64)
    if alpha is None:
        alpha = jsolve.solve_gp(kxx.copy(), jsolve.one_hot_targets(
            ds.train.labels), jitter=jitter_raw, method="scipy")
    accs, stds = {}, {}
    for split in ("validation", "test"):
        sp = getattr(ds, split)
        kzx = np.asarray(jgram(jm, sp.images, ds.train.images, batch_size=B,
                               progress=False), np.float64)
        accs[split] = jsolve.accuracy(jsolve.predict(kzx, alpha), sp.labels)
        var = jsolve.predictive_variance(
            kxx, kzx, np.asarray(jm(sp.images, diag=True), np.float64),
            jitter=jitter_raw)
        stds[split] = float(np.sqrt(var).mean())
    return accs, stds, kxx


@pytest.mark.parametrize("refine", ["--refine", "--norefine"])
def test_classify_e2e_matches_jax(refine, synthetic, capsys):
    """Accuracies equal JAX's classify_device at the same refine setting;
    the printed mean std equals the float64 oracle (relative jitter)."""
    cfg, ds, jm = synthetic
    classify_e2e.main(["--config=synthetic", f"--batch_size={B}",
                       "--variances", refine, "--device=cpu"])
    accs, stds = parse(capsys.readouterr().out)
    want = jclassify(jm, ds.train.images, ds.train.labels,
                     (ds.validation.images, ds.validation.labels),
                     (ds.test.images, ds.test.labels), batch_size=B,
                     jitter=1e-6, refine=refine == "--refine")
    assert [accs["validation"], accs["test"]] == want
    kxx = np.asarray(jgram(jm, ds.train.images, batch_size=B,
                           progress=False), np.float64)
    _, want_std, _ = oracle(ds, jm, 1e-6 * np.mean(np.diagonal(kxx)))
    for split, s in want_std.items():
        assert abs(stds[split] - s) <= STD_RTOL * s, (split, stds, want_std)


@pytest.mark.parametrize("flag", ["--save_posterior=p.npz"])
def test_classify_e2e_refuses_large(flag, capsys):
    """--save_posterior without --large is refused, not dropped."""
    with pytest.raises(SystemExit):
        classify_e2e.main(["--config=synthetic", flag, "--device=cpu"])
    assert "--save_posterior needs --large" in capsys.readouterr().err


def test_classify_e2e_large_then_serve_gp_factor_cache(synthetic, tmp_path,
                                                       capsys, monkeypatch):
    """classify_e2e --large --save_posterior: JAX's classify_device_large
    accuracies (one-device mesh, same seed); then serve_gp --variances
    --factor_cache twice: the first run rebuilds the factor and writes the
    cache, the second loads it without a rebuild; both serve the large
    run's accuracies and mean stds."""
    from cnn_gp_tpu.parallel import classify_device_large as jcdl
    from cnn_gp_tpu.parallel import make_mesh
    from cnn_gp_tpu_torch.parallel import device_large
    _, ds, jm = synthetic
    post = str(tmp_path / "p.npz")
    classify_e2e.main(["--config=synthetic", f"--batch_size={B}", "--large",
                       "--block=32", "--variances", "--residual_sample_seed=0",
                       f"--save_posterior={post}", "--device=cpu"])
    out = capsys.readouterr().out
    assert "rel residual" in out and f"posterior saved to {post}" in out
    accs, stds = parse(out)
    want, _ = jcdl(jm, ds.train.images, ds.train.labels,
                   (ds.validation.images, ds.validation.labels),
                   (ds.test.images, ds.test.labels), batch_size=B, block=32,
                   jitter=1e-6, residual_sample_seed=0, verbose=False,
                   mesh=make_mesh(n_devices=1))
    assert [accs["validation"], accs["test"]] == want
    cache = tmp_path / "fc"
    argv = ["--config=synthetic", f"--posterior={post}", f"--batch_size={B}",
            "--variances", "--block=32", f"--factor_cache={cache}",
            "--device=cpu"]
    for run in ("write", "load"):
        if run == "load":
            def refuse(*a, **k):
                raise AssertionError("the factor was rebuilt, not loaded")
            monkeypatch.setattr(device_large, "rebuild_factor", refuse)
        serve_gp.main(argv)
        out = capsys.readouterr().out
        assert f"cache at {cache}" in out
        assert (cache / "l.npy").exists()
        served_accs, served_stds = parse(out)
        assert served_accs == accs, run
        for split, s in stds.items():
            assert abs(served_stds[split] - s) <= STD_RTOL * s, (run, split)


def test_device_large_scale_script(tmp_path, capsys):
    """The scale script's classify run (per-phase seconds and peak lines,
    --check_scipy agreement 1.0, variances against the float64 oracle) and
    its --serve_posterior protocol in the same process: the served
    accuracies are the classify run's."""
    from cnn_gp_tpu_torch.scripts import device_large_scale as dls
    post = str(tmp_path / "p.npz")
    data = ["--config=synthetic", "--n_train=80", "--n_test=40",
            "--n_validation=16", f"--batch_size={B}", "--block=32",
            "--device=cpu"]
    res = dls.main(data + ["--check_scipy", "--variances",
                           "--residual_sample_seed=1",
                           f"--save_posterior={post}"])
    out = capsys.readouterr().out
    for phase in ("diag+scale", "assemble", "factor", "solve+refine",
                  "variances+scores", "predict"):
        assert f"phase {phase}: " in out, phase
    assert "prediction agreement: 1.0" in out
    dev = float(re.search(r"max \|dev-f64\|/scale = ([\d.e+-]+)", out)[1])
    assert dev < 1e-5
    served = dls.main(data + [f"--serve_posterior={post}"])["served"]
    assert [acc for acc, _, _ in served] == res["accs"]
    for (_, pred, _), want in zip(served, res["info"]["predictions"]):
        np.testing.assert_array_equal(pred, want)


@pytest.fixture()
def posterior(synthetic, tmp_path, request):
    """A posterior of the cut synthetic config at relative jitter 1e-4,
    solved and saved by the port's library (or by the JAX package's)."""
    cfg, ds, jm = synthetic
    y = tsolve.one_hot_targets(ds.train.labels)
    if request.param == "port":
        kxx = gram_device(cfg.initial_model, ds.train.images, batch_size=B,
                          device=CPU).numpy().astype(np.float64)
        save, solve_ = save_posterior, tsolve.solve_gp
    else:
        kxx = np.asarray(jgram(jm, ds.train.images, batch_size=B,
                               progress=False), np.float64)
        save, solve_ = jserving.save_posterior, jsolve.solve_gp
    jr = 1e-4 * float(np.mean(np.diagonal(kxx)))
    alpha = solve_(kxx.copy(), y, jitter=jr, method="scipy")
    path = save(tmp_path / "posterior", train_x=ds.train.images,
                alpha=alpha, scalings=1.0 / np.sqrt(np.diagonal(kxx) + jr),
                jitter_raw=jr, config_name="synthetic")
    return path, alpha, jr


@pytest.mark.parametrize("posterior", ["port", "jax"], indirect=True)
def test_serve_gp_serves_library_posterior(posterior, synthetic, capsys):
    """serve_gp's accuracies equal argmax(Kzx alpha) in float64 and its
    mean std the float64 oracle's, for a posterior from either package."""
    path, alpha, jr = posterior
    _, ds, jm = synthetic
    serve_gp.main(["--config=synthetic", f"--posterior={path}",
                   f"--batch_size={B}", "--variances", "--device=cpu"])
    out = capsys.readouterr().out
    assert "variance factor ready (no solve)" in out
    accs, stds = parse(out)
    want_accs, want_std, _ = oracle(ds, jm, jr, alpha=alpha)
    assert accs == want_accs
    for split, s in want_std.items():
        assert abs(stds[split] - s) <= STD_RTOL * s, (split, stds, want_std)


@pytest.mark.parametrize("posterior", ["port"], indirect=True)
def test_serve_gp_refuses_config_mismatch(posterior, capsys):
    """A posterior solved under another config serves a different kernel:
    refused before any dataset is read (no MNIST files exist here)."""
    path, _, _ = posterior
    with pytest.raises(SystemExit, match="solved under config"):
        serve_gp.main(["--config=mnist", f"--posterior={path}",
                       "--device=cpu"])


@pytest.mark.parametrize("script", ["classify_e2e", "serve_gp"])
def test_cli_refuses_missing_cuda(script, tmp_path, monkeypatch):
    """--device=cuda (the default) never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config=synthetic"]
    if script == "serve_gp":
        argv.append(f"--posterior={tmp_path / 'p.npz'}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        {"classify_e2e": classify_e2e,
         "serve_gp": serve_gp}[script].main(argv)


def test_mnist_config_matches_jax():
    """The port's mnist config (ResNet-32, 50k/10k/10k) computes JAX's
    kernel, and so does its from_jax_model counterpart, on 3 x 4 pairs of
    28x28 inputs (1e-5 of max|K|)."""
    import configs as jconfigs
    t, j = configs.load("mnist"), jconfigs.load("mnist")
    assert (list(t.train_range), list(t.test_range)) == (
        list(j.train_range), list(j.test_range))
    rng = np.random.RandomState(0)
    x = rng.rand(3, 1, 28, 28).astype(np.float32)
    z = rng.rand(4, 1, 28, 28).astype(np.float32)
    want = np.asarray(j.initial_model(x, z), np.float64)
    for model in (t.initial_model, from_jax_model(j.initial_model)):
        got = model(x, z).numpy().astype(np.float64)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

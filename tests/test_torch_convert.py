"""Config and parameter bridge between the packages
(cnn_gp_tpu_torch.convert, cnn_gp_tpu_torch.configs), the port's solve,
dataset and utility copies against the JAX package's, and the rule that
the port never imports jax."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FITTED = os.path.join(REPO, "docs", "fitted", "convnet_fit50k_r5.npz")

CONV_ATTRS = ("kernel_size", "stride", "dilation", "padding", "even_trick",
              "in_channel_multiplier", "out_channel_multiplier",
              "learnable", "pad_lo_hi")


def describe(m):
    """Architecture and hyperparameters of a model of either package."""
    kind = type(m).__name__
    if kind in ("Sequential", "Sum"):
        return (kind, tuple(describe(c) for c in m.mods))
    if kind == "Mixture":
        return (kind, tuple(describe(c) for c in m.mods),
                tuple(np.asarray(m.logit.detach() if hasattr(m.logit, "detach")
                                 else m.logit, np.float32).tolist()))
    if kind == "Conv2d":
        return (kind, tuple(getattr(m, a) for a in CONV_ATTRS),
                float(np.float32(m.var_weight.detach() if hasattr(
                    m.var_weight, "detach") else m.var_weight)),
                float(np.float32(m.var_bias.detach() if hasattr(
                    m.var_bias, "detach") else m.var_bias)))
    return (kind,)


CONFIGS = ["synthetic", "mnist_paper_convnet_gp", "mnist_as_tf", "mnist",
           "cifar10", "mnist_paper_residual_cnn_gp", "mnist_as_tf_16k",
           "mnist_as_tf_mini"]


@pytest.mark.parametrize("name", CONFIGS)
def test_port_configs_equal_jax_configs(name):
    import configs as jconfigs
    from cnn_gp_tpu_torch import configs as tconfigs
    j, t = jconfigs.load(name), tconfigs.load(name)
    assert describe(t.initial_model) == describe(j.initial_model)
    assert describe(convert.from_jax_model(j.initial_model)) == describe(
        j.initial_model)
    for attr in ("dataset_name", "in_channels", "out_channels",
                 "transforms", "model_name"):
        assert getattr(t, attr) == getattr(j, attr)
    for attr in ("train_range", "validation_range", "test_range"):
        assert list(getattr(t, attr)) == list(getattr(j, attr))
    assert tconfigs.image_shape(t) == jconfigs.image_shape(j)


def test_from_jax_model_mixture_kernel(rng):
    jm = G.Sequential(
        G.Mixture([G.Conv2d(4), G.Sequential(G.Conv2d(3, dilation=2),
                                             G.ReLU())],
                  np.array([0.3, -0.7], np.float32)),
        G.resnet_block(stride=2, projection_shortcut=True, multiplier=2),
        G.Conv2d(5, padding=0, learnable=True, var_weight=1.5))
    tm = convert.from_jax_model(jm)
    assert describe(tm) == describe(jm)
    x = rng.randn(3, 2, 10, 10).astype(np.float32)
    want = np.asarray(jm(x))
    got = tm(x).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def learnable_convnet(M):
    layers = []
    for _ in range(7):
        layers += [M.Conv2d(7, var_weight=2.79 * 49, var_bias=7.86,
                            learnable=True), M.ReLU()]
    return M.Sequential(*layers, M.Conv2d(28, padding=0, var_weight=2.79,
                                          var_bias=7.86, learnable=True))


def test_load_leaves_fitted_convnet_matches_jax(rng):
    from cnn_gp_tpu import fit_lib as fit
    jm = fit.load_leaves(learnable_convnet(G), FITTED)
    tm = convert.load_leaves(learnable_convnet(T), FITTED)
    assert describe(tm) == describe(jm)
    x = rng.rand(3, 1, 28, 28).astype(np.float32)
    y = rng.rand(4, 1, 28, 28).astype(np.float32)
    want = np.asarray(jm(x, y, same=False))
    got = tm(x, y, same=False).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_leaf_keys_follow_jax_paths():
    import jax
    jm = G.Sequential(
        G.Mixture([G.Conv2d(3, learnable=True),
                   G.Sum([G.Sequential(), G.Conv2d(1, learnable=True)])]),
        G.ReLU(), G.Conv2d(5, padding=0, learnable=True))
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jm)[0]]
    got = [k for k, _ in convert.leaf_items(convert.from_jax_model(jm))]
    assert got == want


def test_save_leaves_round_trips_through_jax(tmp_path):
    from cnn_gp_tpu import fit_lib as fit
    tm = convert.load_leaves(learnable_convnet(T), FITTED)
    path = str(tmp_path / "leaves.npz")
    convert.save_leaves(tm, path)
    jm = fit.load_leaves(learnable_convnet(G), path)
    assert describe(jm) == describe(tm)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "arch"])
def test_load_leaves_refuses_mismatch(fault):
    with np.load(FITTED) as d:
        saved = {k: d[k] for k in d.files}
    model = learnable_convnet(T)
    if fault == "missing":
        saved.pop("[<flat index 0>][14].var_bias")
    elif fault == "extra":
        saved["[<flat index 0>][16].var_weight"] = np.float32(1.0)
    elif fault == "shape":
        saved["[<flat index 0>][0].var_weight"] = np.ones(2, np.float32)
    elif fault == "arch":
        model = T.Sequential(T.Conv2d(7, learnable=True), T.ReLU(),
                             T.Conv2d(28, padding=0, learnable=True))
    with pytest.raises(ValueError):
        convert.load_leaves(model, saved)


def test_solve_matches_jax(rng):
    from cnn_gp_tpu.ops import solve as jsolve
    from cnn_gp_tpu_torch.ops import solve as tsolve
    a = rng.randn(40, 40)
    k = a @ a.T + 40 * np.eye(40)
    k_upper = np.triu(k) + np.tril(np.full_like(k, np.nan), -1)
    labels = rng.randint(0, 5, 40)
    np.testing.assert_array_equal(tsolve.one_hot_targets(labels),
                                  jsolve.one_hot_targets(labels))
    sym = tsolve.symmetrize_from_upper(k_upper.copy(), block=16)
    np.testing.assert_array_equal(
        sym, jsolve.symmetrize_from_upper(k_upper.copy(), block=16))
    np.testing.assert_array_equal(sym, k)
    y = tsolve.one_hot_targets(labels)
    want = jsolve.solve_gp(k.copy(), y, jitter=0.5, method="scipy")
    np.testing.assert_allclose(
        tsolve.solve_gp(k.copy(), y, jitter=0.5, method="scipy"), want,
        rtol=1e-12)
    np.testing.assert_allclose(
        tsolve.solve_gp(k.copy(), y, jitter=0.5, method="chol",
                        device="cpu"), want, rtol=1e-9, atol=1e-12)
    kzx = rng.randn(7, 40)
    pred = tsolve.predict(kzx, want)
    np.testing.assert_array_equal(pred, jsolve.predict(kzx, want))
    assert tsolve.accuracy(pred, labels[:7]) == jsolve.accuracy(
        pred, labels[:7])


def test_chol_refuses_non_pd():
    from cnn_gp_tpu_torch.ops import solve as tsolve
    k = -np.eye(4)
    with pytest.raises(np.linalg.LinAlgError):
        tsolve.solve_gp(k, np.ones((4, 2)), method="chol", device="cpu")


def test_datasets_match_jax(tmp_path):
    import types

    from cnn_gp_tpu import data as jdata
    from cnn_gp_tpu_torch import data as tdata
    from scripts.make_fake_dataset import make_cifar10, make_mnist
    make_mnist(str(tmp_path), n_train=30, n_test=10)
    make_cifar10(str(tmp_path / "CIFAR10"), n_train=10, n_test=5)
    for dataset_name in ("MNIST", "CIFAR10", "synthetic"):
        cfg = types.SimpleNamespace(
            dataset_name=dataset_name, in_channels=1, transforms=[],
            train_range=range(0, 8), validation_range=[9, 3, 4],
            test_range=range(10, 14))
        j = jdata.DatasetFromConfig(str(tmp_path), cfg)
        t = tdata.DatasetFromConfig(str(tmp_path), cfg)
        for split in ("train", "validation", "test"):
            np.testing.assert_array_equal(getattr(t, split).images,
                                          getattr(j, split).images)
            np.testing.assert_array_equal(getattr(t, split).labels,
                                          getattr(j, split).labels)
    for args in ((64, 16, 10, (1, 28, 28), 0), (8, 4, 3, (3, 8, 8), 5)):
        for a, b in zip(tdata.synthetic_arrays(*args),
                        jdata.synthetic_arrays(*args)):
            np.testing.assert_array_equal(a, b)


def test_utils_match_jax(capsys):
    from cnn_gp_tpu import utils as jutils
    from cnn_gp_tpu_torch import utils as tutils
    for a, b in ((0, 3), (7, 3), (9, 3), (128, 128), (129, 128)):
        assert tutils.round_up_div(a, b) == jutils.round_up_div(a, b)
    for s in (0, 59, 61, 3600, 3725):
        assert tutils.hhmmss(s) == jutils.hhmmss(s)
    assert list(tutils.print_timings(iter(range(3)), desc="t",
                                     total=3)) == [0, 1, 2]
    assert "t: 1/3 it" in capsys.readouterr().out
    assert tutils.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_without_jax():
    """Every port module and chip_smoke import with jax made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import cnn_gp_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'cnn_gp_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'cnn_gp_tpu', 'configs') and sys.modules[m])\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) >= 20

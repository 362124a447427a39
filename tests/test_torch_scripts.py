"""The port's remaining card scripts at toy sizes on the CPU, each held
against the JAX package's computation on the same inputs: serving_bench
(the served posterior predicts as JAX's), model_selection (evidence within
1e-4 and equal accuracies), solver_validation (the Gram and every row's
predictions against JAX's scipy solve; CG refused), cifar_sweep (its tile
against JAX's tile, its operation count), and the run.bash counterpart of
exp_mnist_resnet on fake MNIST with mnist_as_tf_mini cut to toy ranges."""

import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import configs as jconfigs
from cnn_gp_tpu import serving as jserving
from cnn_gp_tpu.data import synthetic_arrays as jsynthetic
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import classify_device_large as jlarge
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential, configs
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.parallel.gram import _tile_body
from cnn_gp_tpu_torch.scripts import (cifar_sweep, make_fake_dataset,
                                      model_selection, serving_bench,
                                      solver_validation)
from cnn_gp_tpu_torch.serving import GPPredictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SERVE = ["--config=synthetic", "--n_train=48", "--query_batch=8",
         "--rounds=2", "--batch_size=16", "--block=16"]
SERVE_KEYS = ["config", "mean_batch_latency", "mean_queries_per_s",
              "n_train", "prepare_variances_s", "query_batch", "rounds",
              "variance_batch_latency", "variance_queries_per_s"]


def test_serving_bench_matches_jax_posterior(capsys):
    """The script's JSON line has the JAX script's keys; the posterior it
    solves predicts every query batch as a posterior solved by JAX's
    classify_device_large on the same data, and its variances agree within
    1e-5 of mean(diag K)."""
    out = serving_bench.main(SERVE + ["--device=cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == SERVE_KEYS and line == out
    assert out["n_train"] == 48 and out["mean_queries_per_s"] > 0
    assert out["variance_queries_per_s"] > 0

    a = types.SimpleNamespace(n_train=48, query_batch=8, batch_size=16,
                              block=16, seed=0, config="synthetic")
    cfg = configs.load("synthetic")
    post = serving_bench.solve_posterior(a, cfg.initial_model, (1, 28, 28),
                                         CPU)
    tr_x, tr_y, te_x, te_y = jsynthetic(n_train=48, n_test=8,
                                        shape=(1, 28, 28), seed=0)
    jm = jconfigs.load("synthetic").initial_model
    _, info = jlarge(jm, tr_x, tr_y, (te_x, te_y), batch_size=16, block=16,
                     verbose=False)
    jpost = jserving.Posterior(train_x=tr_x, alpha=info["alpha"],
                               scalings=info["scalings"],
                               jitter_raw=info["jitter_raw"],
                               config_name="synthetic",
                               settings_snapshot=None)
    mine = GPPredictor(cfg.initial_model, post, batch_size=16, device=CPU)
    theirs = jserving.GPPredictor(jm, jpost, batch_size=16)
    mine.prepare_variances(block=16)
    theirs.prepare_variances(block=16)
    kdiag = float(np.mean(1.0 / post.scalings ** 2))
    make_z = serving_bench.query_maker(a, (1, 28, 28))
    for r in range(3):
        z = make_z(r)
        np.testing.assert_array_equal(mine.classify(z), theirs.classify(z))
        dv = np.abs(mine.variances(z) - np.asarray(theirs.variances(z)))
        assert dv.max() <= TOL * kdiag


def test_serving_bench_serves_a_jax_posterior(tmp_path, capsys):
    """--posterior serves a posterior that JAX saved."""
    tr_x, tr_y, te_x, te_y = jsynthetic(n_train=32, n_test=8,
                                        shape=(1, 28, 28), seed=3)
    jm = jconfigs.load("synthetic").initial_model
    _, info = jlarge(jm, tr_x, tr_y, (te_x, te_y), batch_size=16, block=16,
                     verbose=False)
    path = jserving.save_posterior(
        str(tmp_path / "p"), train_x=tr_x, alpha=info["alpha"],
        scalings=info["scalings"], jitter_raw=info["jitter_raw"],
        config_name="synthetic")
    out = serving_bench.main(SERVE + [f"--posterior={path}", "--novariances",
                                      "--device=cpu"])
    assert out["n_train"] == 32 and out["variance_queries_per_s"] is None
    assert "loaded posterior: n=32" in capsys.readouterr().out


def test_model_selection_matches_jax_evidence(capsys):
    """Each model's evidence within 1e-4 relative of JAX's
    classify_device_large on the same hard digits task, the same test
    accuracy, and one JSON line with the ranking."""
    from scripts.make_fake_dataset import _digits
    names = ["mnist_paper_convnet_gp", "mnist_paper_residual_cnn_gp"]
    out = model_selection.main([
        "--n_train=32", "--n_test=16", "--batch_size=16", "--block=16",
        "--jitter=1e-4", f"--models={','.join(names)}", "--device=cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ranking"] == out["ranking"] and len(out["rows"]) == 2
    tr_x, tr_y, te_x, te_y = model_selection.task(32, 16)
    jx, jy = _digits(32, 28, seed=1, hard=True)
    np.testing.assert_array_equal(tr_x, jx[:, None].astype(np.float32)
                                  / 255.0)
    np.testing.assert_array_equal(tr_y, jy)
    for name, row in zip(names, out["rows"]):
        accs, info = jlarge(jconfigs.load(name).initial_model, tr_x, tr_y,
                            (te_x, te_y), batch_size=16, block=16,
                            jitter=1e-4, verbose=False)
        assert row["config"] == name
        rel = abs(row["log_evidence"] - info["log_evidence"]) / abs(
            info["log_evidence"])
        assert rel < 1e-4, (name, rel)
        assert row["test_acc"] == accs[0]


def test_solver_validation_matches_jax():
    """The card Gram equals JAX's within 1e-5; every row (scipy, chol_ir,
    chol_dist, device_large) predicts as JAX's float64 scipy solve, with
    its solution within 1e-4 of it."""
    from scripts.solver_validation import _assemble as jassemble
    out = solver_validation.main([
        "--config=synthetic", "--n=64", "--n_test=16", "--batch=16",
        "--block=16", "--device=cpu"])
    assert sorted(out["rows"]) == ["chol_dist", "chol_ir", "device_large",
                                   "scipy"]
    jm = jconfigs.load("synthetic").initial_model
    kxx, kzx, tr_y, te_y, _ = jassemble(jm, 64, 16, 16, 1)
    kxx_t, kzx_t, _, _ = solver_validation.assemble(
        configs.load("synthetic").initial_model, 64, 16, 16, 1, CPU)
    assert np.abs(kxx_t - kxx).max() <= TOL * np.abs(kxx).max()
    assert np.abs(kzx_t - kzx).max() <= TOL * np.abs(kzx).max()
    y = jsolve.one_hot_targets(tr_y)
    a_ref = jsolve.solve_gp(kxx.copy(), y, method="scipy")
    pred_ref = jsolve.predict(kzx, a_ref)
    for name, sol in out["solutions"].items():
        row = out["rows"][name]
        assert row["rel_residual"] < 1e-6, (name, row)
        np.testing.assert_array_equal(jsolve.predict(kzx, sol), pred_ref)
        err = np.abs(sol - a_ref).max() / np.abs(a_ref).max()
        assert err < 1e-4, (name, err)


def test_solver_validation_cg_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        solver_validation.main(["--solvers=scipy,cg", "--device=cpu"])


def test_cifar_sweep_rows_and_tile(capsys):
    """The sweep's rows at toy tile sizes, its best line, and the tile it
    times (``_tile_body`` on its inputs) against JAX's tile."""
    from cnn_gp_tpu import settings as jsettings
    from cnn_gp_tpu.parallel.gram import _tile_jit
    rows = cifar_sweep.main(["--config=cifar10", "--tiles=2,3", "--reps=2",
                             "--samples=1", "--device=cpu"])
    assert [r["tile"] for r in rows] == [2, 3]
    for r in rows:
        assert r["entries_per_s"] > 0 and r["ops_per_tile"] > 0
        assert 0 < r["fp32_peak_share"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["best"] in rows

    b = 8
    x = np.random.RandomState(0).rand(4 * b, 1, 28, 28).astype(np.float32)
    model = configs.load("synthetic").initial_model
    from cnn_gp_tpu_torch.ops import megakernel
    with torch.no_grad():
        got = _tile_body(model, megakernel.match(model), torch.as_tensor(x),
                         torch.as_tensor(x), 0, b, b, True).numpy()
    want = np.asarray(_tile_jit(jconfigs.load("synthetic").initial_model,
                                x, x, 0, b, b, True, jsettings.snapshot()))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_tile_ops_hand_count():
    """tile_ops on a two-layer model, counted by hand: moments 2C per pair
    map pixel and variance pixel, the 3x3 "same" conv's two shift-sum
    passes over the padded length, scale and bias, the ReLU's update, and
    the 4x4 valid readout."""
    m = Sequential(Conv2d(3), ReLU(), Conv2d(4, padding=0))
    b, fields = 2, 2 * 2 + 2 * 2
    moments = 2 * 1 * fields * 16
    conv1 = fields * (2 * (4 * 6 + 16) + 2 * 16)
    relu = 38 * 4 * 16 + 2 * 2 * 16
    conv2 = fields * (3 * (1 * 4 + 1) + 2)
    assert cifar_sweep.tile_ops(m, b, (1, 4, 4)) == moments + conv1 + relu \
        + conv2


@pytest.fixture(scope="module")
def fake_mnist(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fake_mnist"))
    make_fake_dataset.make_mnist(d, 60000, 1024)
    return d


def test_run_bash_on_fake_mnist(fake_mnist, tmp_path):
    """exp_mnist_resnet/run.bash's counterpart, two workers on the CPU:
    save_kernel -> merge_h5_files -> classify_gp on mnist_as_tf_mini with
    its ranges cut to 32/16/16; the accuracies equal a JAX Gram's float64
    scipy solve on the same images."""
    cut = (32, 16, 16)
    env = dict(os.environ, CONFIG="mnist_as_tf_mini", DATASETS=fake_mnist,
               OUT_DIR=str(tmp_path / "grams"), BATCH="16", N_WORKERS="2",
               DEVICE="cpu", OMP_NUM_THREADS="2",
               PYTHON=f"{sys.executable} "
                      f"{os.path.join(REPO, 'tests', '_torch_cut_config.py')}",
               CUT_CONFIG="mnist_as_tf_mini",
               CUT_RANGES=",".join(map(str, cut)))
    r = subprocess.run(
        ["bash", os.path.join(REPO, "cnn_gp_tpu_torch", "exp_mnist_resnet",
                              "run.bash")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    accs = {m.group(1): float(m.group(2)) / 100 for m in re.finditer(
        r"^(validation|test) accuracy: ([\d.]+)%", r.stdout, re.M)}
    assert sorted(accs) == ["test", "validation"]
    assert "merged 1 shard(s)" in r.stdout

    cfg = configs.load("mnist_as_tf_mini")
    ds = DatasetFromConfig(fake_mnist, cfg)
    tr, va, te = (getattr(ds, s).subset(range(n)) for s, n in
                  zip(("train", "validation", "test"), cut))
    jm = jconfigs.load("mnist_as_tf_mini").initial_model
    kxx = np.asarray(jgram(jm, tr.images, batch_size=16, progress=False),
                     np.float64)
    a = jsolve.solve_gp(kxx, jsolve.one_hot_targets(tr.labels),
                        method="scipy")
    for split, part in (("validation", va), ("test", te)):
        kzx = np.asarray(jgram(jm, part.images, tr.images, batch_size=16,
                               progress=False), np.float64)
        want = jsolve.accuracy(jsolve.predict(kzx, a), part.labels)
        assert accs[split] == pytest.approx(want, abs=1e-9), split

"""The port's save -> merge -> classify pipeline on the CPU against the JAX
package's compute_gram + solve_gp("scipy") on the same synthetic data:
the predictions must be identical."""

import types

import numpy as np
import pytest

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu.data import DatasetFromConfig as JData
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu_torch.exp_mnist_resnet import (classify_gp, merge_h5_files,
                                               save_kernel)


def tiny_config(M):
    """2 x [3x3 conv, ReLU] + readout on 28x28 synthetic data, 96/32/32."""
    return types.SimpleNamespace(
        dataset_name="synthetic", in_channels=1, transforms=[],
        train_range=range(0, 96), validation_range=range(96, 128),
        test_range=range(128, 160),
        initial_model=M.Sequential(
            M.Conv2d(3, var_weight=2.79 * 9, var_bias=7.86), M.ReLU(),
            M.Conv2d(3, var_weight=2.79 * 9, var_bias=7.86), M.ReLU(),
            M.Conv2d(28, padding=0, var_weight=2.79, var_bias=7.86)))


@pytest.fixture(scope="module")
def jax_predictions():
    cfg = tiny_config(G)
    ds = JData("", cfg)
    kxx = jgram(cfg.initial_model, ds.train.images, batch_size=32,
                progress=False).astype(np.float64)
    a = jsolve.solve_gp(kxx, jsolve.one_hot_targets(ds.train.labels),
                        method="scipy")
    return {split: jsolve.predict(
        jgram(cfg.initial_model, getattr(ds, split).images, ds.train.images,
              batch_size=32, progress=False), a)
        for split in ("validation", "test")}


@pytest.fixture(scope="module")
def merged_store(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    cfg = tiny_config(T)
    paths = [str(tmp / f"{r:02d}_nw02.h5") for r in range(2)]
    for rank, path in enumerate(paths):
        save_kernel.run(cfg, path, datasets_path=str(tmp), device="cpu",
                        batch_size=32, n_workers=2, worker_rank=rank)
    merge_h5_files.main(["merge_h5_files", *paths])
    return cfg, paths[0], str(tmp)


@pytest.mark.parametrize("solver", ["scipy", "chol", "chol_ir", "chol_dist"])
def test_pipeline_predictions_match_jax(solver, merged_store,
                                        jax_predictions):
    cfg, path, root = merged_store
    res = classify_gp.run(cfg, path, datasets_path=root, device="cpu",
                          solver=solver)
    for split, want in jax_predictions.items():
        acc, pred = res[split]
        np.testing.assert_array_equal(pred, want)
        assert acc > 0.9          # the synthetic task is nearly separable


def test_merged_store_is_complete(merged_store):
    from cnn_gp_tpu_torch.data import GramStore
    _, path, _ = merged_store
    with GramStore(path, "r") as s:
        s.assert_complete("Kxx", upper_triangle_only=True)
        for name, shape in (("Kxvx", (32, 96)), ("Kxtx", (32, 96)),
                            ("Kv_diag", (32,)), ("Kt_diag", (32,))):
            assert s.shape(name) == shape
            s.assert_complete(name)


def test_classify_refuses_incomplete_store(merged_store, tmp_path):
    from cnn_gp_tpu_torch.data import GramStore
    cfg, _, root = merged_store
    path = str(tmp_path / "shard.h5")
    save_kernel.run(cfg, path, datasets_path=root, device="cpu",
                    batch_size=32, n_workers=2, worker_rank=1)
    with GramStore(path, "r") as s:
        assert np.isnan(s.read("Kxx")).any()
    with pytest.raises(RuntimeError, match="non-finite"):
        classify_gp.run(cfg, path, datasets_path=root, device="cpu")


@pytest.mark.parametrize("script", ["save_kernel", "classify_gp"])
def test_cli_refuses_missing_cuda(script, tmp_path, monkeypatch):
    """--device=cuda (the default) never falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = save_kernel if script == "save_kernel" else classify_gp
    flag = "--out_path" if script == "save_kernel" else "--in_path"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--config=synthetic", f"{flag}={tmp_path / 'k.h5'}"])


def test_classify_refuses_unported_solvers():
    """Every card solver needs an explicit device (none falls back to the
    CPU); an unknown method is refused."""
    from cnn_gp_tpu_torch.ops import solve
    k = np.eye(3)
    y = solve.one_hot_targets(np.array([0, 1, 0]))
    for method in ("chol", "chol_ir", "chol_dist"):
        with pytest.raises(ValueError, match="explicit device"):
            solve.solve_gp(k.copy(), y, method=method)
    with pytest.raises(ValueError, match="unknown solve method"):
        solve.solve_gp(k.copy(), y, method="cg", device="cpu")


@pytest.mark.parametrize("stream", ["--stream", "--nostream"])
def test_classify_gp_chol_dist_statistics_match_jax(stream, merged_store,
                                                    capsys, monkeypatch):
    """classify_gp --solver=chol_dist --variances --evidence (the float32
    card factor, streamed or read whole) against the JAX package's
    chol_dist store solver and statistics on a one-device mesh: the same
    predictions, variances within 1e-5 * mean(k_zz), evidence within rtol
    5e-4; and against the float64 oracle of --solver=scipy."""
    from cnn_gp_tpu.data import GramStore as JStore
    from cnn_gp_tpu.parallel import chol_dist as jcd
    from cnn_gp_tpu.parallel import make_mesh
    cfg, path, root = merged_store
    monkeypatch.setattr(classify_gp.configs, "load", lambda name: cfg)
    jitter = 1e3
    classify_gp.main(["--config=synthetic", f"--in_path={path}",
                      f"--datasets_path={root}", "--solver=chol_dist",
                      stream, "--variances", "--evidence",
                      f"--jitter={jitter}", "--device=cpu"])
    out = capsys.readouterr().out
    assert "train log evidence:" in out and "predictive std" in out
    assert ("[stream]" in out) == (stream == "--stream")
    res = classify_gp.run(cfg, path, datasets_path=root, device="cpu",
                          solver="chol_dist", variances=True, evidence=True,
                          jitter=jitter, stream=stream == "--stream")
    oracle = classify_gp.run(cfg, path, datasets_path=root, device="cpu",
                             solver="scipy", variances=True, evidence=True,
                             jitter=jitter)
    y = jsolve.one_hot_targets(JData("", tiny_config(G)).train.labels)
    with JStore(path, "r") as f:
        ja, _, _, jf, js = jcd.chol_solve_dist_from_store(
            f, "Kxx", y, jitter=jitter, mesh=make_mesh(n_devices=1),
            check_finite=True, return_factor=True)
        jev = jcd.evidence_from_factor(jf, js, y, ja)
        for split, kzx, kzz in (("validation", "Kxvx", "Kv_diag"),
                                ("test", "Kxtx", "Kt_diag")):
            kz, dz = f.read(kzx), f.read(kzz)
            jvar = jcd.variances_from_cross_host(jf, js, kz, dz)
            scale = float(np.mean(dz))
            for want in (jvar, oracle["variances"][split]):
                assert np.abs(res["variances"][split] - want).max() \
                    < 1e-5 * scale
            np.testing.assert_array_equal(res[split][1],
                                          jsolve.predict(kz, ja))
            np.testing.assert_array_equal(res[split][1], oracle[split][1])
    for want in (jev, oracle["log_evidence"]):
        np.testing.assert_allclose(res["log_evidence"], want, rtol=5e-4)


def test_classify_gp_flag_rules():
    """JAX's flag rules: the statistics need --solver=scipy or chol_dist;
    --lpd needs --jitter > 0."""
    assert classify_gp.flag_error("chol_dist", 0.0, True, True, False) is None
    for solver in ("chol", "chol_ir"):
        assert "chol_dist" in classify_gp.flag_error(solver, 1.0, False,
                                                     True, False)
    assert "--jitter > 0" in classify_gp.flag_error("chol_dist", 0.0, False,
                                                    False, True)

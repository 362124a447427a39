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


@pytest.mark.parametrize("solver", ["scipy", "chol"])
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
    from cnn_gp_tpu_torch.ops import solve
    k = np.eye(3)
    y = solve.one_hot_targets(np.array([0, 1, 0]))
    for method in ("chol_ir", "chol_dist"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            solve.solve_gp(k.copy(), y, method=method)
    with pytest.raises(ValueError, match="explicit device"):
        solve.solve_gp(k.copy(), y, method="chol")

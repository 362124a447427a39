"""The rank-group flags of the six drivers that call a sharded library
function: ``device_large_scale`` (classify, then serve its posterior),
``serving_bench``, ``model_selection``, ``fit_deploy_large``,
``fit_paper_scale --grad=probed`` and ``incremental_bench``.

Each runs at toy size as two processes of one gloo group
(``--device=cpu --coordinator_address=127.0.0.1:<port> --num_processes=2
--process_id=i``), which row-shards its factors (``ShardedFactor``), and
in this process on one device (``CardFactor``).  ``tests/_torch_group_
driver.py`` records what each library call returned on both sides: both
ranks must give the one-device run's accuracies and predictions, and its
evidence, mean predictive std, LPD and fit losses within 1e-5 relative
(the float32 factor's rounding, the bound of
``tests/test_torch_sharded_drivers.py``).  Rank 0 alone prints the JSON
line or summary and writes files; ``fit_paper_scale --grad=exact``
refuses a group before any work."""

import os
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from cnn_gp_tpu_torch.entry import reserved_port
import _torch_group_driver as D
from cnn_gp_tpu_torch.fit import MESH_NEEDS_PROBED
from cnn_gp_tpu_torch.scripts import (device_large_scale, fit_deploy_large,
                                      fit_paper_scale, incremental_bench,
                                      model_selection, serving_bench)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(REPO, "tests", "_torch_group_driver.py")
RTOL = 1e-5
EXACT = ("accs", "predictions", "out")     # accuracies and predictions

SMALL = ["--batch_size=16", "--block=16"]
CASES = {
    "serving_bench": (serving_bench, [
        "--config=synthetic", "--n_train=48", "--query_batch=8",
        "--rounds=2"] + SMALL, "json"),
    "model_selection": (model_selection, [
        "--n_train=32", "--n_test=16", "--jitter=1e-4",
        "--models=mnist_paper_convnet_gp,synthetic"] + SMALL, "json"),
    "fit_deploy_large": (fit_deploy_large, [
        "--n_fit=16", "--n_large=40", "--n_test=16", "--fit_block=16",
        "--steps=2", "--probes=4", "--tile_fraction=1.0",
        "--eval_models=init,fitted"] + SMALL, None),
    "fit_paper_scale": (fit_paper_scale, [
        "--grad=probed", "--n_train=40", "--n_test=16", "--steps=2",
        "--probes=4", "--tile_fraction=0.5"] + SMALL, "summary:"),
    "incremental_bench": (incremental_bench, [
        "--config=synthetic", "--n=32", "--m=16", "--batches=2",
        "--n_test=16", "--jitter=1e-4"] + SMALL, "json"),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group(module, args, tmp_path):
    """Run ``module`` as the two ranks of one gloo group under the
    recording helper; return each rank's records and output."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    paths = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    with reserved_port() as port:
        outs = W.launch([("group", r, [
            sys.executable, HELPER, paths[r], module] + args + [
                "--device=cpu", f"--coordinator_address=127.0.0.1:{port}",
                "--num_processes=2", f"--process_id={r}"])
            for r in range(2)], str(tmp_path), env=env)
    records = []
    for path in paths:
        with np.load(path) as f:
            records.append(dict(f))
    return records, outs


def _one_device(module, args, capsys):
    """The same driver in this process on one device: its records and
    output."""
    capsys.readouterr()
    with D.recording(module) as want:
        res = module.main(args + ["--device=cpu"])
    assert not torch.distributed.is_initialized()
    return dict(want, **D.rows(res)), capsys.readouterr().out


def _same(got, want):
    """A rank's records against the one-device run's."""
    assert sorted(got) == sorted(want) and want
    for k, v in want.items():
        if k.split(".")[1] in EXACT:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=k)


def _summary_lines(out, marker):
    return [line for line in out.splitlines()
            if line.startswith("{" if marker == "json" else marker)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_on_two_ranks_matches_one_device(name, tmp_path, capsys):
    module, args, marker = CASES[name]
    want, text = _one_device(module, args, capsys)
    records, outs = _group(module.__name__, args, tmp_path)
    for got in records:
        _same(got, want)
    if marker is not None:
        assert len(_summary_lines(text, marker)) == 1
        assert [len(_summary_lines(out, marker)) for out in outs] == [1, 0]


def test_device_large_scale_classify_then_serve(tmp_path, capsys):
    """The classify run with variances on two ranks (rank 0 writes the
    posterior and the predictions), then the posterior served on two
    ranks with the variance factor row-sharded, each against the same
    command on one device."""
    data = ["--config=synthetic", "--n_train=64", "--n_test=32",
            "--n_validation=16", "--variances"] + SMALL
    classify = data + ["--residual_sample_seed=0"]
    want, _ = _one_device(device_large_scale, classify, capsys)
    post, preds = tmp_path / "p.npz", tmp_path / "pred.npy"
    records, outs = _group(
        device_large_scale.__name__,
        classify + [f"--save_posterior={post}", f"--out_predictions={preds}"],
        tmp_path)
    for got, out in zip(records, outs):
        _same(got, want)
        assert "phase factor: " in out
    np.testing.assert_array_equal(np.load(preds),
                                  want["large.predictions.0"])
    assert ["posterior saved" in out for out in outs] == [True, False]

    serve = data + [f"--serve_posterior={post}"]
    want, _ = _one_device(device_large_scale, serve, capsys)
    records, _ = _group(device_large_scale.__name__, serve, tmp_path)
    assert sorted(k.split(".")[0] for k in want) == [
        "classify", "classify", "variances", "variances"]
    for got in records:
        _same(got, want)


def test_fit_paper_scale_exact_refuses_a_group(capsys):
    """``--grad=exact`` factors on one device: with a group the script
    stops before any work, with the library's reason."""
    with pytest.raises(SystemExit):
        fit_paper_scale.main(["--grad=exact",
                              "--coordinator_address=localhost:1",
                              "--num_processes=2", "--process_id=0",
                              "--device=cpu"])
    assert MESH_NEEDS_PROBED in capsys.readouterr().err

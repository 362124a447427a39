"""The drivers on a rank group: ``classify_gp --solver=chol_dist``,
``classify_e2e --large`` and ``serve_gp --variances`` each run as two
processes of one gloo group (``--coordinator_address=127.0.0.1:<port>
--num_processes=2 --process_id=i --device=cpu``) on the synthetic config
with its ranges cut to 96 / 32 / 32 (``tests/_torch_cut_config.py``),
which row-shards their factor (``ShardedFactor``).  Both ranks must print
what the same driver prints in this process on one device (the
``CardFactor`` path): the same accuracies, and the log evidence and mean
predictive std within the float32 factor's rounding."""

import os
import re
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from cnn_gp_tpu_torch.entry import reserved_port
from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.exp_mnist_resnet import (classify_e2e, classify_gp,
                                               save_kernel, serve_gp)

pytest.importorskip("h5py")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = (96, 32, 32)
B = 32


@pytest.fixture(autouse=True)
def cut_synthetic(monkeypatch):
    """The synthetic config with its ranges cut, in this process."""
    cfg = configs.load("synthetic")
    for name, n in zip(("train_range", "validation_range", "test_range"),
                       RANGES):
        monkeypatch.setattr(cfg, name, list(getattr(cfg, name))[:n])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield cfg
    torch.set_num_threads(n)


def _group(module, args, log_dir):
    """Run ``module`` as the two processes of one gloo group; return each
    rank's output."""
    env = dict(os.environ, CUT_CONFIG="synthetic",
               CUT_RANGES=",".join(map(str, RANGES)), OMP_NUM_THREADS="1")
    with reserved_port() as port:
        return W.launch([("group", rank, [
            sys.executable, os.path.join(REPO, "tests",
                                         "_torch_cut_config.py"),
            "-m", module] + args + [
                "--device=cpu", f"--coordinator_address=127.0.0.1:{port}",
                "--num_processes=2", f"--process_id={rank}"])
            for rank in range(2)], str(log_dir), env=env)


def _numbers(out, pattern):
    return {m.group(1): float(m.group(2))
            for m in re.finditer(pattern, out, re.M)}


def _same_report(outs, want):
    """Every rank's accuracies equal ``want``'s; its evidence and mean
    stds within 1e-5 relative of ``want``'s printed values."""
    acc = r"^(validation|test) accuracy: ([\d.]+)%"
    std = r"^(validation|test) predictive std: mean ([\d.e+-]+)"
    ev = r"^(train) log evidence: ([\d.e+-]+)"
    assert _numbers(want, acc) and _numbers(want, std)
    for out in outs:
        assert _numbers(out, acc) == _numbers(want, acc), out[-2000:]
        for pattern in (std, ev):
            got, ref = _numbers(out, pattern), _numbers(want, pattern)
            assert got.keys() == ref.keys()
            for k, v in ref.items():
                assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)


def test_classify_gp_chol_dist_on_two_ranks(cut_synthetic, tmp_path, capsys):
    """``classify_gp --solver=chol_dist --variances`` (the streamed store
    read): rank 0 reads Kxx and sends each rank its rows."""
    store = str(tmp_path / "k.h5")
    save_kernel.run(cut_synthetic, store, datasets_path="", device="cpu",
                    batch_size=B, store_backend="h5")
    args = ["--config=synthetic", f"--in_path={store}",
            "--solver=chol_dist", "--variances", "--jitter=1e-6"]
    capsys.readouterr()
    classify_gp.main(args + ["--device=cpu"])
    want = capsys.readouterr().out
    outs = _group("cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp", args,
                  tmp_path)
    _same_report(outs, want)


def test_classify_e2e_large_then_serve_on_two_ranks(tmp_path, capsys):
    """``classify_e2e --large --variances`` on two ranks saves one
    posterior (rank 0); ``serve_gp --variances --factor_cache`` serves it
    on two ranks, twice (the cache written, then loaded), as one process
    serves it on one device."""
    post = str(tmp_path / "p.npz")
    args = ["--config=synthetic", f"--batch_size={B}", "--block=32",
            "--large", "--variances", "--jitter=1e-4",
            "--residual_sample_seed=0"]
    capsys.readouterr()
    classify_e2e.main(args + ["--device=cpu"])
    want = capsys.readouterr().out
    outs = _group("cnn_gp_tpu_torch.exp_mnist_resnet.classify_e2e",
                  args + [f"--save_posterior={post}"], tmp_path)
    _same_report(outs, want)
    assert os.path.exists(post)

    args = ["--config=synthetic", f"--posterior={post}",
            f"--batch_size={B}", "--block=32", "--variances"]
    serve_gp.main(args + ["--device=cpu"])
    want = capsys.readouterr().out
    cache = str(tmp_path / "fc")
    for _ in range(2):
        outs = _group("cnn_gp_tpu_torch.exp_mnist_resnet.serve_gp",
                      args + [f"--factor_cache={cache}"], tmp_path)
        _same_report(outs, want)
    with open(os.path.join(cache, "meta.json")) as fh:
        assert '"n_devices": 2' in fh.read()
    assert np.load(os.path.join(cache, "l.npy"), mmap_mode="r").shape == (
        96, 96)


def test_group_flags_refused_off_the_sharded_factor():
    """A group row-shards only the chol_dist / --large factor: the other
    solvers refuse the flags."""
    with pytest.raises(SystemExit):
        classify_gp.main(["--in_path=x.h5", "--solver=scipy",
                          "--coordinator_address=localhost:1"])
    with pytest.raises(SystemExit):
        classify_e2e.main(["--coordinator_address=localhost:1"])

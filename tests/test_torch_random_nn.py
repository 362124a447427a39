"""The port's Monte-Carlo experiment (cnn_gp_tpu_torch.exp_random_nn and
scripts/mc_width_check) against the JAX package's scripts, on the CPU at
toy sizes: the same CSV files and columns from the same fake MNIST, the
analytic covariance within 1e-5 of value scale, the port's plot of them,
the same JSON keys from mc_width_check, and the card default that raises
where there is no card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from cnn_gp_tpu_torch.exp_random_nn import random_comparison
from cnn_gp_tpu_torch.scripts import make_fake_dataset, mc_width_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CONFIG = "mnist_paper_convnet_gp"
ARGS = ["--channels=3", "--n_samples=48", "--seed=1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_jax(*args):
    """A JAX script in a subprocess on the CPU; its standard output."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def comparison(tmp_path_factory):
    """Fake MNIST (60,000 + 10,000) written by the port's writer, then
    JAX's random_comparison and the port's on it: (JAX dir, port dir,
    the port's result)."""
    root = tmp_path_factory.mktemp("random_nn")
    data = str(root / "data")
    make_fake_dataset.make_mnist(data, 60000, 10000)
    jdir, tdir = str(root / "jax"), str(root / "port")
    run_jax("exp_random_nn.random_comparison", f"--config={CONFIG}",
            f"--datasets_path={data}", f"--out_path={jdir}", *ARGS)
    out = random_comparison.main([f"--config={CONFIG}",
                                  f"--datasets_path={data}",
                                  f"--out_path={tdir}", *ARGS,
                                  "--device=cpu"])
    return jdir, tdir, out


def test_random_comparison_matches_jax_files(comparison):
    """The same file names; pandas reads the same columns, dtypes and
    (i, j) rows; `true` within 1e-5 of max|K| of JAX's; `est` and `r0`
    finite, and `est` equal to the port's own draws' covariance."""
    jdir, tdir, out = comparison
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        "0003_0001_cov.csv", "0003_0001_samples.csv"]
    js = pd.read_csv(os.path.join(jdir, "0003_0001_samples.csv"))
    ts = pd.read_csv(os.path.join(tdir, "0003_0001_samples.csv"))
    assert list(js.columns) == list(ts.columns) == ["r0"]
    assert js.dtypes.equals(ts.dtypes) and len(js) == len(ts) == 48
    assert np.isfinite(ts.r0).all()
    jc = pd.read_csv(os.path.join(jdir, "0003_0001_cov.csv"))
    tc = pd.read_csv(os.path.join(tdir, "0003_0001_cov.csv"))
    assert list(jc.columns) == list(tc.columns) == ["i", "j", "est", "true"]
    assert jc.dtypes.equals(tc.dtypes) and len(tc) == 100 * 100
    pd.testing.assert_frame_equal(jc[["i", "j"]], tc[["i", "j"]])
    scale = np.abs(jc["true"]).max()
    assert np.abs(tc["true"] - jc["true"]).max() <= TOL * scale
    assert np.isfinite(tc.est).all()
    # the text round-trips: the float32 arrays written come back exactly
    np.testing.assert_array_equal(tc.est.to_numpy().astype(np.float32),
                                  out["est"].ravel())
    np.testing.assert_array_equal(tc["true"].to_numpy().astype(np.float32),
                                  out["true"].ravel())


def test_write_csv_text_equals_pandas(tmp_path):
    """The CSV writer's text is pandas' to_csv(index=False) text."""
    rng = np.random.RandomState(0)
    cols = {"i": np.arange(4) * np.ones([4, 1]),
            "est": (rng.randn(16) * 1e11).astype(np.float32),
            "true": np.float32([1e-7, 0.1, 2.0, 1e16] * 4)}
    cols = {k: np.asarray(v).ravel() for k, v in cols.items()}
    path = str(tmp_path / "x.csv")
    random_comparison.write_csv(path, cols)
    with open(path) as f:
        assert f.read() == pd.DataFrame(cols).to_csv(index=False)
    assert not os.path.exists(path + ".tmp")


def test_random_plot_renders_port_csvs(comparison, tmp_path):
    """The port's random_plot draws the 3x4 figure from the port's CSVs
    (the width-3 files stand in for every width)."""
    pytest.importorskip("matplotlib")
    pytest.importorskip("scipy")
    _, tdir, _ = comparison
    for c in (3, 10, 30, 100):
        for kind in ("samples", "cov"):
            shutil.copy(os.path.join(tdir, f"0003_0001_{kind}.csv"),
                        str(tmp_path / f"{c:04d}_0001_{kind}.csv"))
    out = str(tmp_path / "fig.pdf")
    r = subprocess.run(
        [sys.executable, "-m", "cnn_gp_tpu_torch.exp_random_nn.random_plot",
         str(tmp_path), out], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.getsize(out) > 5000


def test_mc_width_check_keys_match_jax(capsys):
    """mc_width_check --device=cpu at toy size prints one JSON line with
    the JAX script's keys and values for the same flags."""
    flags = ["--config=synthetic", "--channels=4", "--n_samples=32",
             "--n_images=4", "--sample_batch=16", "--seed=0"]
    want = json.loads(run_jax("scripts.mc_width_check", *flags,
                              "--allow_cpu").strip().splitlines()[-1])
    got = mc_width_check.main(flags + ["--device=cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got
    assert sorted(got) == sorted(want)
    for k in ("n", "samples", "channels", "config"):
        assert got[k] == want[k]
    assert np.isfinite([got["max_abs_z"], got["mean_rel"]]).all()
    assert got["max_abs_z"] > 0 and got["mean_rel"] > 0


@pytest.mark.parametrize("script", ["random_comparison", "mc_width_check"])
def test_refuse_cuda_without_a_card(script, tmp_path):
    """Both run on the card by default and raise where there is none:
    nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run the script")
    main = {"random_comparison": random_comparison.main,
            "mc_width_check": mc_width_check.main}[script]
    argv = ([f"--out_path={tmp_path}"] if script == "random_comparison"
            else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)

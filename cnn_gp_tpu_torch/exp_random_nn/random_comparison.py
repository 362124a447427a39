"""Monte-Carlo validation: finite random NNs against the analytic kernel.

PyTorch counterpart of ``exp_random_nn/random_comparison.py``, with its
flags and defaults plus ``--device``: takes the first 100 training images,
computes their analytic covariance, draws ``--n_samples`` finite random
networks of width ``--channels`` through ``finite.sample_nn_outputs`` and
writes two CSVs into ``--out_path``:

* ``{channels:04d}_{seed:04d}_samples.csv``: column ``r0``, the output of
  example 0 divided by its analytic standard deviation;
* ``{channels:04d}_{seed:04d}_cov.csv``: columns ``i, j, est, true``, the
  empirical and the analytic covariance of every pair (i, j).

The CSVs hold the text that pandas' ``to_csv(index=False)`` writes for the
same arrays, so pandas reads them back as the JAX script's frames.  Each
is written to a temporary name and then renamed, so a killed run leaves no
truncated CSV for ``run.bash``'s resume-by-skip to take as done.

The covariance is one Gram tile through ``parallel/gram.py::gram_in_memory``
on the device: the paper ConvNet's goes through the CUDA pair kernel and
its pre-pass, the ResNets' through the plain path.

    python -m cnn_gp_tpu_torch.exp_random_nn.random_comparison \\
        --config=mnist_paper_convnet_gp --datasets_path=... \\
        --out_path=out/ --channels=30
"""

import argparse
import os

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, sample_nn_outputs, settings
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.parallel import gram_in_memory
from cnn_gp_tpu_torch.utils import resolve_device

N_IMAGES = 100


def write_csv(path: str, columns: dict) -> None:
    """Write ``columns`` (name -> 1-D array) as pandas' ``to_csv(
    index=False)`` would, then rename into place."""
    tmp = path + ".tmp"
    table = np.stack([np.asarray(v).astype(str) for v in columns.values()],
                     axis=1)
    np.savetxt(tmp, table, fmt="%s", delimiter=",",
               header=",".join(columns), comments="")
    os.replace(tmp, path)


def csv_paths(out_path: str, channels: int, seed: int):
    stem = os.path.join(out_path, f"{channels:04d}_{seed:04d}")
    return stem + "_samples.csv", stem + "_cov.csv"


def run(a, device, info=None) -> dict:
    """Draw, compare and write both CSVs.  Returns their paths, the images
    and the arrays written; ``info`` (a dict) receives
    ``sample_nn_outputs``'s chunking and seconds."""
    settings.disable_tf32()
    config = configs.load(a.config)
    dataset = DatasetFromConfig(a.datasets_path, config)
    inputs = dataset.train.images[:N_IMAGES]
    model = config.initial_model

    true_cov = gram_in_memory(model, inputs, device=device,
                              batch_size=len(inputs), progress=False)
    r = sample_nn_outputs(
        model, inputs, n_samples=a.n_samples, channels=a.channels,
        in_channels=config.in_channels, out_channels=1,
        sample_batch=a.sample_batch or None,
        generator=torch.Generator(device=device).manual_seed(a.seed),
        device=device, info=info).cpu().numpy()                    # [S, N]

    os.makedirs(a.out_path, exist_ok=True)
    samples_path, cov_path = csv_paths(a.out_path, a.channels, a.seed)
    r0 = r[:, 0] / np.sqrt(true_cov[0, 0])
    write_csv(samples_path, {"r0": r0})

    ni = inputs.shape[0]
    i = np.arange(ni) * np.ones([ni, 1])
    j = i.T
    est_cov = r.T @ r / a.n_samples
    write_csv(cov_path, {"i": i.ravel(), "j": j.ravel(),
                         "est": est_cov.ravel(), "true": true_cov.ravel()})
    return {"samples_path": samples_path, "cov_path": cov_path,
            "inputs": inputs, "r": r, "est": est_cov, "true": true_cov}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--out_path", default=None,
                   help="where to save the drawn outputs of the NN and kernel")
    p.add_argument("--config", default="cifar10",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--seed", type=int, default=1, help="the random seed")
    p.add_argument("--channels", type=int, default=30,
                   help="the number of channels of the random finite NNs")
    p.add_argument("--n_samples", type=int, default=10000,
                   help="Number of samples to draw from the NN")
    p.add_argument("--sample_batch", type=int, default=0,
                   help="networks per grouped forward (0 = sized to the "
                        "card's free memory)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    if a.out_path is None:
        p.error("--out_path is required")
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

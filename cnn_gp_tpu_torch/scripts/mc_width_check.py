"""Seeded width-100 Monte-Carlo covariance check (one config, one width).

PyTorch counterpart of ``scripts/mc_width_check.py``, with its flags and
defaults; ``--device`` (``cuda`` by default) replaces its TPU check.  It
draws ``--n_samples`` networks of width ``--channels`` from a config's
``nn()`` and compares their empirical output covariance with the analytic
kernel entrywise, in units of the Monte-Carlo error bars (the per-entry
std of a Gaussian covariance estimate, ``sqrt((K_ii K_jj + K_ij^2) / S)``).

For configs with a true GP correspondence (ConvNet, ResNet, cifar10) the
z-scores sit inside the error bars at width 100.  For
``mnist_paper_residual_cnn_gp`` they do not: the replicated paper bug sums
branches after the ReLU, so the branch cross-moments that the Sum kernel
drops are real.  ``tests/test_mc_convergence.py`` states both signatures.

The analytic covariance is one Gram tile through
``parallel/gram.py::gram_in_memory`` (the paper ConvNet's on the CUDA pair
kernel).  Prints one JSON line {"max_abs_z", "mean_rel", "n", "samples",
"channels", "config"}.  ``--device=cuda`` where there is no CUDA raises;
``--device=cpu`` runs on the CPU (hours at width 100).

    python -m cnn_gp_tpu_torch.scripts.mc_width_check \\
        --config=mnist_paper_convnet_gp
"""

import argparse
import json

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, sample_nn_outputs, settings
from cnn_gp_tpu_torch.parallel import gram_in_memory
from cnn_gp_tpu_torch.utils import resolve_device


def run(a, device, info=None) -> dict:
    """Sample, compare and print the JSON line; ``info`` (a dict) receives
    ``sample_nn_outputs``'s chunking and seconds."""
    settings.disable_tf32()
    config = configs.load(a.config)
    shape = configs.image_shape(config)
    rng = np.random.RandomState(a.seed)
    x = rng.rand(a.n_images, *shape).astype(np.float32)

    model = config.initial_model
    true_cov = gram_in_memory(model, x, device=device, batch_size=len(x),
                              progress=False).astype(np.float64)

    r = sample_nn_outputs(
        model, x, n_samples=a.n_samples, channels=a.channels,
        in_channels=config.in_channels, out_channels=1,
        sample_batch=a.sample_batch or None,
        generator=torch.Generator(device=device).manual_seed(a.seed),
        device=device, info=info).cpu().numpy().astype(np.float64)
    est = r.T @ r / a.n_samples

    d = np.diagonal(true_cov)
    std = np.sqrt((d[:, None] * d[None, :] + true_cov ** 2) / a.n_samples)
    z = np.abs(est - true_cov) / std
    out = {
        "max_abs_z": float(z.max()),
        "mean_rel": float(np.abs(est - true_cov).mean()
                          / np.abs(true_cov).mean()),
        "n": int(a.n_images), "samples": int(a.n_samples),
        "channels": int(a.channels), "config": a.config,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mnist_paper_residual_cnn_gp",
                   help="config name")
    p.add_argument("--channels", type=int, default=100,
                   help="finite-net width")
    p.add_argument("--n_samples", type=int, default=4000, help="MC draws")
    p.add_argument("--n_images", type=int, default=16,
                   help="images (covariance is n x n)")
    p.add_argument("--sample_batch", type=int, default=64,
                   help="networks per grouped forward (0 = sized to the "
                        "card's free memory)")
    p.add_argument("--seed", type=int, default=0, help="rng seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

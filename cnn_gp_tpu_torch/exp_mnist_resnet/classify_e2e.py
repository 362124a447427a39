"""One-shot GP classification: dataset -> card-resident Gram -> solve.

PyTorch counterpart of ``exp_mnist_resnet/classify_e2e.py`` without
``--large``, with the same flag names plus ``--device``: the Gram stays on
the card end to end (``parallel.device_pipeline.classify_device``), the
right shape for interactive runs and for datasets whose Gram fits in the
card's memory.  ``--variances`` adds predictive-std summaries per split.
``--large`` and ``--save_posterior`` (the matrix-free large-N path) are
not ported yet and are refused.

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_e2e \\
        --config=mnist_paper_convnet_gp --datasets_path=... --device=cuda
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.parallel import classify_device
from cnn_gp_tpu_torch.utils import add_bool_flag, resolve_device


def run(config, *, datasets_path: str, device, batch_size: int = 128,
        jitter: float = 1e-6, refine: bool = True,
        variances: bool = False) -> dict:
    """Classify the config's validation and test splits.  Returns
    ``{"accuracies": [val, test], "variances": [val, test] or None}``."""
    settings.disable_tf32()
    dataset = DatasetFromConfig(datasets_path, config)
    t0 = time.perf_counter()
    splits = [(dataset.validation.images, dataset.validation.labels),
              (dataset.test.images, dataset.test.labels)]
    out = classify_device(
        config.initial_model, dataset.train.images, dataset.train.labels,
        *splits, batch_size=batch_size, jitter=jitter, refine=refine,
        variances=variances, device=device)
    accs, var = out if variances else (out, None)
    if var is not None:
        for name, v in zip(("validation", "test"), var):
            std = np.sqrt(v)
            print(f"{name} predictive std: mean {std.mean():.4e}  "
                  f"min {std.min():.4e}  max {std.max():.4e}")
    elapsed = time.perf_counter() - t0
    print(f"validation accuracy: {accs[0] * 100}%")
    print(f"test accuracy: {accs[1] * 100}%")
    print(f"total wall time: {elapsed:.1f}s")
    return {"accuracies": accs, "variances": var}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--config", default="mnist",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--jitter", type=float, default=1e-6,
                   help="added to the scale-normalised diagonal")
    add_bool_flag(p, "variances", False,
                  "also compute GP posterior variances per split and print "
                  "predictive-std summaries")
    add_bool_flag(p, "refine", True,
                  "float64 factor and solve on the card (--norefine: the "
                  "float32 scale-normalised factor)")
    add_bool_flag(p, "large", False,
                  "the matrix-free large-N path: not ported yet "
                  "(ROADMAP.md), refused")
    p.add_argument("--save_posterior", default="",
                   help="with --large: not ported yet (ROADMAP.md), refused")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    if a.large or a.save_posterior:
        p.error("--large and --save_posterior (classify_device_large) are "
                "not ported yet (ROADMAP.md, Queue 1); save a posterior "
                "with cnn_gp_tpu_torch.serving.save_posterior")
    run(configs.load(a.config), datasets_path=a.datasets_path,
        device=resolve_device(a.device), batch_size=a.batch_size,
        jitter=a.jitter, refine=a.refine, variances=a.variances)


if __name__ == "__main__":
    main()

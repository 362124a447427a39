"""Serve a persisted GP posterior: predictions without re-solving.

PyTorch counterpart of ``exp_mnist_resnet/serve_gp.py``, with the same
flag names plus ``--device``: loads the O(N) posterior artifact written by
``serving.save_posterior`` of either package and scores the config's
validation/test splits at once; ``--variances`` adds predictive-std
summaries after a solve-free factor rebuild on the card, and
``--factor_cache=dir`` writes that factor on the first run and loads it on
later ones (the JAX package's cache files, either package's).

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.serve_gp --config=mnist \\
        --datasets_path=... --posterior=posterior.npz --device=cuda
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.ops.solve import accuracy
from cnn_gp_tpu_torch.parallel import multihost
from cnn_gp_tpu_torch.serving import GPPredictor, load_posterior
from cnn_gp_tpu_torch.utils import add_bool_flag


class ConfigMismatch(ValueError):
    """The posterior was solved under another config than the one asked
    for."""


def run(config_name: str, posterior_path: str, *, datasets_path: str,
        device, batch_size: int = 128, variances: bool = False,
        block: int = 2048, factor_cache: str = "",
        allow_settings_mismatch: bool = False, mesh=None) -> dict:
    """Serve the config's splits from the posterior.  Returns
    ``{split: (accuracy, predictions, variances or None)}``; a posterior
    solved under another config is refused.  ``mesh`` row-shards the
    variance factor over a rank group."""
    settings.disable_tf32()
    posterior = load_posterior(posterior_path)
    print(f"posterior: n={posterior.n} classes={posterior.alpha.shape[1]} "
          f"config={posterior.config_name!r} "
          f"variance-ready={posterior.scalings is not None}")
    if posterior.config_name and posterior.config_name != config_name:
        # a mismatched kernel serves silently wrong numbers
        raise ConfigMismatch(
            f"posterior was solved under config "
            f"{posterior.config_name!r} but --config={config_name!r}; "
            f"pass the matching config (the kernel must be the one the "
            f"posterior was solved with)")
    config = configs.load(config_name)
    dataset = DatasetFromConfig(datasets_path, config)
    predictor = GPPredictor(config.initial_model, posterior,
                            batch_size=batch_size,
                            allow_settings_mismatch=allow_settings_mismatch,
                            device=device)
    if variances:
        t0 = time.perf_counter()
        predictor.prepare_variances(block=block,
                                    factor_cache=factor_cache or None,
                                    mesh=mesh)
        cache = f", cache at {factor_cache}" if factor_cache else ""
        print(f"variance factor ready (no solve{cache}) in "
              f"{time.perf_counter() - t0:.1f}s")
    results = {}
    for name, split in (("validation", dataset.validation),
                        ("test", dataset.test)):
        if len(split.images) == 0:
            continue
        t0 = time.perf_counter()
        pred = predictor.classify(split.images)
        wall = time.perf_counter() - t0
        acc = accuracy(pred, np.asarray(split.labels))
        print(f"{name} accuracy: {acc * 100}%  "
              f"({len(pred)} points in {wall:.1f}s)")
        var = None
        if variances:
            t0 = time.perf_counter()
            var = predictor.variances(split.images)
            std = np.sqrt(var)
            print(f"{name} predictive std: mean {std.mean():.4e}  "
                  f"min {std.min():.4e}  max {std.max():.4e}  "
                  f"({time.perf_counter() - t0:.1f}s)")
        results[name] = (acc, pred, var)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--config", default="mnist",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--posterior", required=True,
                   help="posterior .npz written by serving.save_posterior "
                        "(of either package)")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size for regeneration")
    add_bool_flag(p, "variances", False,
                  "also serve GP posterior variances (rebuilds the factor "
                  "once on the card, solve-free)")
    p.add_argument("--block", type=int, default=2048,
                   help="Cholesky block size for the variance factor "
                        "rebuild")
    p.add_argument("--factor_cache", default="",
                   help="opt-in on-disk factor cache directory (an O(N^2) "
                        "file): written on the first --variances run, "
                        "loaded instead of rebuilt on later ones")
    add_bool_flag(p, "allow_settings_mismatch", False,
                  "serve a posterior recorded under other kernel settings "
                  "(cnn_gp_tpu_torch.settings)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    try:
        with multihost.grouped(a) as (device, mesh):
            run(a.config, a.posterior, datasets_path=a.datasets_path,
                device=device, batch_size=a.batch_size,
                variances=a.variances, block=a.block,
                factor_cache=a.factor_cache,
                allow_settings_mismatch=a.allow_settings_mismatch,
                mesh=mesh)
    except ConfigMismatch as e:
        raise SystemExit(f"serve_gp: {e}") from None


if __name__ == "__main__":
    main()

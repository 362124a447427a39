"""One-shot GP classification: dataset -> card-resident Gram -> solve.

PyTorch counterpart of ``exp_mnist_resnet/classify_e2e.py``, with the same
flag names plus ``--device``: the Gram stays on the card end to end.  By
default ``parallel.device_pipeline.classify_device`` holds the whole Gram
(float64 factor with ``--refine``); ``--large`` runs the matrix-free
large-N path, ``parallel.device_large.classify_device_large`` (one float32
equilibrated buffer factored in place, float64 refinement through
regenerated tiles), and ``--save_posterior`` then writes the solved
posterior for ``serve_gp``.  ``--variances`` adds predictive-std summaries
per split.  ``--save_posterior`` without ``--large`` is refused (the
whole-Gram path has no posterior to save).

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_e2e \\
        --config=mnist_paper_convnet_gp --datasets_path=... --device=cuda
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.parallel import (classify_device,
                                       classify_device_large, multihost)
from cnn_gp_tpu_torch.utils import add_bool_flag


def run(config, *, datasets_path: str, device, batch_size: int = 128,
        jitter: float = 1e-6, refine: bool = True, variances: bool = False,
        large: bool = False, block: int = 2048, refine_iters: int = 1,
        residual_check: str = "sampled", residual_sample_seed: int = -1,
        residual_accept_frac: float = 1.0, save_posterior: str = "",
        config_name: str = "", mesh=None) -> dict:
    """Classify the config's validation and test splits.  Returns
    ``{"accuracies": [val, test], "variances": [val, test] or None}``, plus
    ``"info"`` (``classify_device_large``'s) with ``large``.  ``mesh``
    (with ``large`` only) row-shards the factor over a rank group; rank 0
    saves the posterior."""
    if mesh is not None and not large:
        raise ValueError("a rank group row-shards --large's factor; "
                         "classify_device holds the Gram on one card")
    settings.disable_tf32()
    dataset = DatasetFromConfig(datasets_path, config)
    t0 = time.perf_counter()
    splits = [(dataset.validation.images, dataset.validation.labels),
              (dataset.test.images, dataset.test.labels)]
    info = None
    if large:
        accs, info = classify_device_large(
            config.initial_model, dataset.train.images, dataset.train.labels,
            *splits, batch_size=batch_size, block=block, jitter=jitter,
            refine_iters=refine_iters, residual_check=residual_check,
            residual_accept_frac=residual_accept_frac,
            residual_sample_seed=(residual_sample_seed
                                  if residual_sample_seed >= 0 else None),
            variances=variances, device=device, mesh=mesh)
        var = info["variances"]
        est = "~" if info["rel_residual_estimated"] else ""
        print(f"rel residual {est}{info['rel_residual']:.2e} after "
              f"{info['refinements']} refinements; "
              f"log evidence {info['log_evidence']:.6g}; "
              f"timings {info['timings_s']}")
        if save_posterior and multihost.is_root(mesh):
            from cnn_gp_tpu_torch.serving import save_posterior as save
            out = save(save_posterior, train_x=dataset.train.images,
                       alpha=info["alpha"], scalings=info["scalings"],
                       jitter_raw=info["jitter_raw"],
                       config_name=config_name)
            print(f"posterior saved to {out} (serve with "
                  f"cnn_gp_tpu_torch.exp_mnist_resnet.serve_gp — no "
                  f"re-solve)")
    else:
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
    res = {"accuracies": accs, "variances": var}
    if info is not None:
        res["info"] = info
    return res


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
                  "use the matrix-free large-N path (blocked in-place "
                  "float32 Cholesky of the equilibrated Gram; the Gram "
                  "never leaves the card)")
    p.add_argument("--block", type=int, default=2048,
                   help="Cholesky block size (--large); per-step transients "
                        "are ~2 * N_pad * block floats on top of the "
                        "N_pad^2 buffer")
    p.add_argument("--refine_iters", type=int, default=1,
                   help="refinement matvec passes cap (--large)")
    p.add_argument("--residual_check", default="sampled",
                   choices=["sampled", "full"],
                   help="with --large: 'sampled' measures the solve "
                        "residual on ~1024 randomly drawn rows and escalates "
                        "to the exact check only when the estimate does not "
                        "clear tol; 'full' always pays the exact sweep")
    p.add_argument("--residual_sample_seed", type=int, default=-1,
                   help="with --large: seed for the randomized residual row "
                        "sample; -1 draws a fresh seed per run")
    p.add_argument("--residual_accept_frac", type=float, default=1.0,
                   help="with --large: the sampled estimate's +3-SE upper "
                        "confidence bound must clear this fraction of tol "
                        "to skip the exact sweep")
    p.add_argument("--save_posterior", default="",
                   help="with --large: persist the solved posterior (O(N) "
                        "artifact) to this path for re-solve-free serving "
                        "via serve_gp")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    if a.save_posterior and not a.large:
        p.error("--save_posterior needs --large (classify_device keeps no "
                "equilibrated posterior); save one with "
                "cnn_gp_tpu_torch.serving.save_posterior")
    if a.coordinator_address and not a.large:
        p.error("--coordinator_address needs --large (the row-sharded "
                "factor)")
    with multihost.grouped(a) as (device, mesh):
        run(configs.load(a.config), datasets_path=a.datasets_path,
            device=device, batch_size=a.batch_size,
            jitter=a.jitter, refine=a.refine, variances=a.variances,
            large=a.large, block=a.block, refine_iters=a.refine_iters,
            residual_check=a.residual_check,
            residual_sample_seed=a.residual_sample_seed,
            residual_accept_frac=a.residual_accept_frac,
            save_posterior=a.save_posterior, config_name=a.config,
            mesh=mesh)


if __name__ == "__main__":
    main()

"""Fit small, deploy at paper scale: evidence-fitted hyperparameters held
against the init and the paper's values by the card-resident large-N
classifier, on held-out accuracy and held-out log predictive density.

PyTorch counterpart of ``scripts/fit_deploy_large.py``.  The paper
ConvNet's 16 per-layer variance leaves are fitted by type-II ML on
``--n_fit`` examples of the hard task (``fit_large(grad="probed")``),
optionally saved (``--save_fitted``) or loaded instead of fitted
(``--load_fitted``), then each of the init / paper / fitted models runs
``classify_device_large(variances=True)`` at ``--n_large`` train examples
and prints held-out accuracy, train log evidence and held-out LPD (mean
and standard error).

    python -m cnn_gp_tpu_torch.scripts.fit_deploy_large --n_fit=4096 \\
        --n_large=50000

With ``--coordinator_address`` (``--num_processes`` / ``--process_id``, or
``env`` under torchrun) the probed fit's factor and each deploy row's
factor are row-sharded over the group's ranks, as the JAX script spreads
them over every local device; every rank takes the same steps and prints
its rows, and rank 0 alone writes ``--save_fitted``.
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import settings
from cnn_gp_tpu_torch.data import hard_mnist
from cnn_gp_tpu_torch.fit import fit_large, load_leaves, save_leaves
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import classify_device_large, multihost
from cnn_gp_tpu_torch.scripts.fit_paper_scale import paper_convnet


def run(a, device, mesh=None) -> dict:
    settings.disable_tf32()
    # the fit split and the deploy split come from the same hard task
    # (train seed 1, held-out seed 2 inside hard_mnist)
    fit_x, fit_y, _, _ = hard_mnist(a.n_fit, 1, flip_frac=a.label_noise)
    tr_x, tr_y, te_x, te_y = hard_mnist(a.n_large, a.n_test,
                                        flip_frac=a.label_noise)
    y_fit = solve.one_hot_targets(fit_y, dtype=np.float32)
    init = paper_convnet(a.vw_init, a.vb_init, learnable=True)
    losses = None
    if a.load_fitted:
        fitted = load_leaves(init, a.load_fitted)
        print(f"loaded fitted leaves from {a.load_fitted}", flush=True)
    else:
        t0 = time.perf_counter()
        fitted, losses = fit_large(
            init, fit_x, y_fit, steps=a.steps,
            learning_rate=a.learning_rate, batch_size=a.batch_size,
            verbose=True, grad="probed", probes=a.probes,
            tile_fraction=a.tile_fraction, refine_iters=0,
            block=a.fit_block, device=device, mesh=mesh)
        print(f"fit at n={a.n_fit}: {a.steps} steps in "
              f"{time.perf_counter() - t0:.1f}s  nmll {losses[0]:.6g} -> "
              f"best {np.min(losses):.6g} (trajectory: "
              f"{np.round(losses, 1).tolist()})", flush=True)
        if a.save_fitted and multihost.is_root(mesh):
            save_leaves(fitted, a.save_fitted)
            print(f"fitted leaves saved to {a.save_fitted}", flush=True)

    wanted = [s.strip() for s in a.eval_models.split(",") if s.strip()]
    rows = {}
    for name, model in (("init", paper_convnet(a.vw_init, a.vb_init)),
                        ("paper", paper_convnet(2.79, 7.86)),
                        ("fitted", fitted)):
        if name not in wanted:
            continue
        t0 = time.perf_counter()
        accs, info = classify_device_large(
            model, tr_x, tr_y, (te_x, te_y), batch_size=a.batch_size,
            block=a.block, jitter=a.jitter, variances=True, verbose=False,
            device=device, mesh=mesh)
        lpd, lpd_se, _ = solve.gaussian_lpd(
            info["scores"][0], info["variances"][0], te_y,
            info["jitter_raw"])
        rows[name] = (accs[0], info["log_evidence"], lpd, lpd_se)
        print(f"{name:>7} @ n={a.n_large}: held-out acc {accs[0]:.4f}"
              f"  train log evidence {info['log_evidence']:.6g}"
              f"  held-out LPD {lpd:.4f} +- {lpd_se:.4f}"
              f"  rel_residual {info['rel_residual']:.2e}"
              f"  ({time.perf_counter() - t0:.1f}s; phases "
              f"{ {k: round(v, 3) for k, v in info['timings_s'].items()} })",
              flush=True)
    return {"losses": losses, "fitted": fitted, "rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_fit", type=int, default=4096,
                   help="fit-split size (type-II ML)")
    p.add_argument("--n_large", type=int, default=50000,
                   help="deploy-split train size")
    p.add_argument("--n_test", type=int, default=10000,
                   help="held-out examples at deploy scale")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--block", type=int, default=2048,
                   help="factor block size (classify)")
    p.add_argument("--fit_block", type=int, default=1024,
                   help="factor block size (probed fit)")
    p.add_argument("--steps", type=int, default=20, help="fit steps")
    p.add_argument("--probes", type=int, default=16,
                   help="Hutchinson probes")
    p.add_argument("--tile_fraction", type=float, default=0.25,
                   help="fit tile subsample fraction")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="adam learning rate (log space); the default is "
                        "0.05 for the probed gradient, with the overshoot "
                        "guard on")
    p.add_argument("--label_noise", type=float, default=0.05,
                   help="label-flip fraction of the hard task (0: the "
                        "zero-noise variant)")
    p.add_argument("--jitter", type=float, default=1e-6,
                   help="relative jitter of the large solve")
    p.add_argument("--vw_init", type=float, default=1.0,
                   help="initial var_weight (config units)")
    p.add_argument("--vb_init", type=float, default=1.0,
                   help="initial var_bias")
    p.add_argument("--save_fitted", default="",
                   help="write the fitted leaves to this .npz")
    p.add_argument("--load_fitted", default="",
                   help="skip the fit; load the leaves from this .npz")
    p.add_argument("--eval_models", default="init,paper,fitted",
                   help="deploy rows to run (comma list)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    with multihost.grouped(a) as (device, mesh):
        return run(a, device, mesh=mesh)


if __name__ == "__main__":
    main()

"""Type-II ML at paper scale: fit the ConvNet GP's variance hyperparameters
on a hard task and compare against the paper's random-searched values.

PyTorch counterpart of ``scripts/fit_paper_scale.py``.  Per-layer
learnable (var_weight, var_bias) leaves of the paper ConvNet are fitted by
``cnn_gp_tpu_torch.fit.fit_large`` (``--grad=exact``: tiled Gram, float64
value and inverse on the same device, tile-VJP gradients;
``--grad=probed``: the card-resident Hutchinson path) on the hard
MNIST-like task, then held-out accuracy, train log evidence and held-out
log predictive density are printed for

    init   -- the mis-initialised start,
    paper  -- the paper's 2.79 / 7.86,
    fitted -- after ``--steps`` of fit_large.

    python -m cnn_gp_tpu_torch.scripts.fit_paper_scale --n_train=2048 \\
        --steps=30

With ``--coordinator_address`` (``--num_processes`` / ``--process_id``, or
``env`` under torchrun) and ``--grad=probed`` the fit's factor is
row-sharded over the group's ranks, as the JAX script spreads it over
every local device; every rank takes the same steps and prints its rows,
and rank 0 alone writes ``--save_fitted`` and prints the summary.
``--grad=exact`` factors on one device and refuses a group.
"""

import argparse
import time

import numpy as np

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential, settings
from cnn_gp_tpu_torch.data import hard_mnist
from cnn_gp_tpu_torch.fit import MESH_NEEDS_PROBED, fit_large, save_leaves
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import (compute_gram_diag, gram_in_memory,
                                       multihost)
from cnn_gp_tpu_torch.utils import add_bool_flag

__all__ = ["paper_convnet", "hard_mnist", "evaluate", "main"]


def paper_convnet(vw, vb, learnable=False):
    """The paper ConvNet GP with parameterised variances: 7 x (Conv 7x7
    "same" + ReLU) and a 28x28 readout, the conv layers at var_weight *
    7^2 as the config has them."""
    layers = []
    for _ in range(7):
        layers += [Conv2d(kernel_size=7, padding="same",
                          var_weight=vw * 7 ** 2, var_bias=vb,
                          learnable=learnable),
                   ReLU()]
    return Sequential(*layers,
                      Conv2d(kernel_size=28, padding=0, var_weight=vw,
                             var_bias=vb, learnable=learnable))


def evaluate(model, tr_x, tr_y, te_x, te_y, batch_size, jitter_rel, *,
             device):
    """Held-out accuracy, train log evidence and held-out log predictive
    density: the Grams on ``device``, the algebra in float64 on the host.
    Returns ``(acc, lml, lpd_mean, lpd_se)``."""
    kxx = np.asarray(gram_in_memory(model, tr_x, device=device,
                                    batch_size=batch_size, progress=False),
                     np.float64)
    jr = jitter_rel * float(np.mean(np.diagonal(kxx)))
    y = solve.one_hot_targets(tr_y)
    lml = solve.log_marginal_likelihood(kxx, y, jitter_rel=jitter_rel)
    a = solve.solve_gp(kxx.copy(), y, jitter=jr, method="scipy")
    kzx = np.asarray(gram_in_memory(model, te_x, tr_x, device=device,
                                    batch_size=batch_size, progress=False),
                     np.float64)
    acc = solve.accuracy(solve.predict(kzx, a), te_y)
    kzz = compute_gram_diag(model, te_x, device=device,
                            batch_size=batch_size,
                            progress=False).astype(np.float64)
    lpd, lpd_se, _ = solve.log_predictive_density(
        kxx, kzx, kzz, tr_y, te_y, jitter_rel=jitter_rel)
    return acc, lml, lpd, lpd_se


def _config_units(fitted):
    """Per-layer (var_weight in config units, var_bias) of a fitted
    paper_convnet."""
    convs = [m for m in fitted.mods if isinstance(m, Conv2d)]
    vws = [float(m.var_weight.detach()) / (49 if m.kernel_size == 7 else 1)
           for m in convs]
    return vws, [float(m.var_bias.detach()) for m in convs]


def run(a, device, mesh=None) -> dict:
    settings.disable_tf32()
    root = multihost.is_root(mesh)
    tr_x, tr_y, te_x, te_y = hard_mnist(a.n_train, a.n_test,
                                        flip_frac=a.label_noise)
    y_fit = solve.one_hot_targets(tr_y, dtype=np.float32)
    b = a.batch_size
    rows = {}

    def report(name, model):
        if a.timing_only:
            return
        t0 = time.perf_counter()
        rows[name] = evaluate(model, tr_x, tr_y, te_x, te_y, b, a.jitter,
                              device=device)
        acc, lml, lpd, lpd_se = rows[name]
        print(f"{name:>7}: held-out acc {acc:.4f}  train log evidence "
              f"{lml:.6g}  held-out LPD {lpd:.4f} +- {lpd_se:.4f}"
              f"  ({time.perf_counter() - t0:.1f}s)", flush=True)

    report("init", paper_convnet(a.vw_init, a.vb_init))
    report("paper", paper_convnet(2.79, 7.86))

    t0 = time.perf_counter()
    fitted, losses = fit_large(
        paper_convnet(a.vw_init, a.vb_init, learnable=True), tr_x, y_fit,
        steps=a.steps, learning_rate=a.learning_rate, jitter=a.jitter,
        batch_size=b, verbose=True, grad=a.grad, probes=a.probes,
        block=a.block, tile_fraction=a.tile_fraction,
        refine_iters=a.refine_iters, device=device, mesh=mesh)
    print(f"fit_large: {a.steps} steps in {time.perf_counter() - t0:.1f}s"
          f"  nmll {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)
    vws, vbs = _config_units(fitted)
    print(f"fitted per-layer var_weight (config units): "
          f"{np.round(vws, 3).tolist()}", flush=True)
    print(f"fitted per-layer var_bias: {np.round(vbs, 3).tolist()}",
          flush=True)
    if a.save_fitted and root:
        save_leaves(fitted, a.save_fitted)
        print(f"fitted leaves saved to {a.save_fitted} (reload with "
              f"load_leaves onto the same architecture, in either package)",
              flush=True)
    report("fitted", fitted)

    if not a.timing_only and root:
        init, paper, fit_row = rows["init"], rows["paper"], rows["fitted"]
        d_lpd = fit_row[2] - init[2]
        se = max(float(np.hypot(fit_row[3], init[3])), 1e-12)
        print(f"\nsummary: fitted vs paper: acc {fit_row[0]:.4f} vs "
              f"{paper[0]:.4f}, evidence {fit_row[1]:.6g} vs {paper[1]:.6g}"
              f", LPD {fit_row[2]:.4f}+-{fit_row[3]:.4f} vs {paper[2]:.4f}"
              f"+-{paper[3]:.4f}; fitted vs init: acc "
              f"{fit_row[0] - init[0]:+.4f}, evidence "
              f"{fit_row[1] - init[1]:+.6g}, LPD {d_lpd:+.4f} "
              f"({d_lpd / se:+.1f} SE)", flush=True)
    return {"losses": losses, "fitted": fitted, "rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_train", type=int, default=2048,
                   help="training examples")
    p.add_argument("--n_test", type=int, default=2048,
                   help="held-out examples")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--steps", type=int, default=30,
                   help="fit_large optimisation steps")
    p.add_argument("--learning_rate", type=float, default=None,
                   help="adam learning rate (log space); the default is "
                        "0.1 for exact and 0.05 for probed gradients, with "
                        "the overshoot guard on")
    p.add_argument("--label_noise", type=float, default=0.05,
                   help="fraction of flipped labels in the hard task (0: "
                        "the zero-noise variant)")
    p.add_argument("--jitter", type=float, default=1e-6,
                   help="relative jitter (against the mean Gram diagonal)")
    p.add_argument("--vw_init", type=float, default=1.0,
                   help="initial var_weight (config units)")
    p.add_argument("--vb_init", type=float, default=1.0,
                   help="initial var_bias")
    p.add_argument("--grad", default="exact", choices=["exact", "probed"],
                   help="'exact' (float64 inverse on the device) or 'probed' "
                        "(card-resident Hutchinson cotangents)")
    p.add_argument("--probes", type=int, default=16,
                   help="Hutchinson probe count (grad=probed)")
    p.add_argument("--block", type=int, default=1024,
                   help="factor block size (grad=probed)")
    add_bool_flag(p, "timing_only", False,
                  "skip the float64 evaluation rows; run and time the fit "
                  "steps only")
    p.add_argument("--tile_fraction", type=float, default=1.0,
                   help="grad=probed: sample this fraction of the strictly "
                        "upper tiles per step (importance-weighted, "
                        "unbiased)")
    p.add_argument("--refine_iters", type=int, default=1,
                   help="grad=probed: residual sweeps of the solve (0: the "
                        "raw factor solve)")
    p.add_argument("--save_fitted", default="",
                   help="write the fitted leaves to this .npz")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    if a.coordinator_address and a.grad != "probed":
        p.error(f"--coordinator_address needs --grad=probed: "
                f"{MESH_NEEDS_PROBED}")
    with multihost.grouped(a) as (device, mesh):
        return run(a, device, mesh=mesh)


if __name__ == "__main__":
    main()

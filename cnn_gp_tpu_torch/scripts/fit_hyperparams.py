"""Type-II ML demo: recover Conv2d hyperparameters by marginal likelihood.

PyTorch counterpart of ``scripts/fit_hyperparams.py``.  Targets are drawn
from a ground-truth kernel with known (var_weight, var_bias); a
mis-initialised learnable model is fitted by ``cnn_gp_tpu_torch.fit.fit``
(whole-matrix NMLL) and the recovered values and the NMLL gap to the truth
are printed:

    python -m cnn_gp_tpu_torch.scripts.fit_hyperparams --steps=80
"""

import argparse

import numpy as np

from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential, kernel_fn, settings
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.fit import fit, neg_marginal_log_likelihood
from cnn_gp_tpu_torch.utils import resolve_device


def make_model(var_weight, var_bias, learnable=False):
    """The demo architecture (the JAX script's and its tests')."""
    return Sequential(
        Conv2d(5, var_weight=var_weight, var_bias=var_bias,
               learnable=learnable),
        ReLU(),
        Conv2d(14, padding=0))


def draw_gp_targets(truth, tr_x, n_functions, seed, *, device):
    """Function draws from the truth kernel's GP: a scale-normalised
    float64 Cholesky of its Gram (computed on ``device``) times seeded
    normal draws, the JAX script's draws for the same seed."""
    k_true = kernel_fn(truth, tr_x, device=device).cpu().numpy().astype(
        np.float64)
    s = np.diagonal(k_true).mean()
    chol = np.linalg.cholesky(k_true / s + 1e-6 * np.eye(len(k_true)))
    rng = np.random.RandomState(seed)
    return (chol @ rng.randn(len(k_true), n_functions)
            * np.sqrt(s)).astype(np.float32)


def run(a, device) -> dict:
    settings.disable_tf32()
    tr_x, _, _, _ = synthetic_arrays(n_train=a.n_train, n_test=0,
                                     shape=(1, 14, 14), seed=a.seed)
    y = draw_gp_targets(make_model(a.vw_true, a.vb_true), tr_x,
                        a.n_functions, a.seed, device=device)
    fitted, losses = fit(make_model(a.vw_init, a.vb_init, learnable=True),
                         tr_x, y, steps=a.steps,
                         learning_rate=a.learning_rate, device=device)
    vw = float(fitted.mods[0].var_weight.detach())
    vb = float(fitted.mods[0].var_bias.detach())
    nmll_truth = float(neg_marginal_log_likelihood(
        make_model(a.vw_true, a.vb_true, learnable=True), tr_x, y,
        device=device).detach())
    print(f"nmll: init {losses[0]:.2f} -> fitted {losses[-1]:.2f} "
          f"(truth {nmll_truth:.2f})")
    print(f"var_weight: init {a.vw_init} -> {vw:.3f} (truth {a.vw_true})")
    print(f"var_bias:   init {a.vb_init} -> {vb:.3f} (truth {a.vb_true})")
    return {"losses": losses, "var_weight": vw, "var_bias": vb,
            "nmll_truth": nmll_truth}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_train", type=int, default=64,
                   help="training examples")
    p.add_argument("--n_functions", type=int, default=8,
                   help="target function draws")
    p.add_argument("--steps", type=int, default=80,
                   help="optimisation steps")
    p.add_argument("--learning_rate", type=float, default=0.1,
                   help="adam learning rate")
    p.add_argument("--vw_true", type=float, default=3.0,
                   help="generating var_weight")
    p.add_argument("--vb_true", type=float, default=1.5,
                   help="generating var_bias")
    p.add_argument("--vw_init", type=float, default=1.0,
                   help="initial var_weight")
    p.add_argument("--vb_init", type=float, default=0.5,
                   help="initial var_bias")
    p.add_argument("--seed", type=int, default=3, help="rng seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

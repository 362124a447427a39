"""Scale runs of the large-N card-resident classification path.

PyTorch counterpart of ``scripts/device_large_scale.py``, with the same
flags plus ``--device``: drives ``classify_device_large`` on synthetic
arrays at a chosen N and prints the wall seconds and peak card memory of
each phase and the scaled-space residual; ``--check_scipy`` cross-checks
predictions (and, with ``--variances``, the variances) against explicit
Grams and the float64 scipy solve on the host, feasible up to ~16k.

    python -m cnn_gp_tpu_torch.scripts.device_large_scale \\
        --config=mnist_paper_convnet_gp --n_train=16384 --n_test=2048 \\
        --check_scipy
    python -m cnn_gp_tpu_torch.scripts.device_large_scale \\
        --config=mnist_paper_convnet_gp --n_train=50000 --n_test=20000 \\
        --n_validation=10000 --variances

Serving protocol: add ``--save_posterior=p.npz`` to a classify run, then
time the solve-free serving in a fresh process with
``--serve_posterior=p.npz`` and the same data flags.

With ``--coordinator_address`` (``--num_processes`` / ``--process_id``, or
``env`` under torchrun) the factor is row-sharded over the group's ranks
(``ShardedFactor``), as the JAX script spreads it over every local device;
every rank prints its report, and rank 0 alone writes the files and runs
``--check_scipy``:

    torchrun --nproc_per_node=4 \\
        -m cnn_gp_tpu_torch.scripts.device_large_scale \\
        --coordinator_address=env --config=mnist_paper_convnet_gp ...
"""

import argparse
import time

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import (classify_device_large,
                                       compute_gram_diag, gram_in_memory,
                                       multihost)
from cnn_gp_tpu_torch.utils import add_bool_flag


def _peak_gb(device) -> str:
    if device.type != "cuda":
        return "n/a"
    return f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB"


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def run(a, device, mesh=None) -> dict:
    """Classify (or, with ``--serve_posterior``, serve) the synthetic
    splits on ``device``; ``mesh`` row-shards the factor over a rank
    group, whose rank 0 alone writes files and runs the scipy check."""
    settings.disable_tf32()
    root = multihost.is_root(mesh)
    config = configs.load(a.config)
    model = config.initial_model
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=a.n_train, n_test=a.n_test,
        shape=configs.image_shape(config), seed=a.seed)
    splits = [(te_x, te_y)]
    if a.n_validation:
        va_x, va_y = te_x[:a.n_validation], te_y[:a.n_validation]
        te_x, te_y = te_x[a.n_validation:], te_y[a.n_validation:]
        splits = [(va_x, va_y), (te_x, te_y)]

    if a.serve_posterior:
        return _serve(a, model, splits, device, mesh)

    _reset_peak(device)
    t0 = time.perf_counter()
    accs, info = classify_device_large(
        model, tr_x, tr_y, *splits, batch_size=a.batch_size, block=a.block,
        refine_iters=a.refine_iters, residual_check=a.residual_check,
        residual_accept_frac=a.residual_accept_frac,
        residual_sample_seed=(a.residual_sample_seed
                              if a.residual_sample_seed >= 0 else None),
        variances=a.variances, device=device, mesh=mesh)
    wall = time.perf_counter() - t0
    est = "~" if info["rel_residual_estimated"] else ""
    sampled = (f"sampled {info['rel_residual_sampled']:.2e} "
               if info["rel_residual_sampled"] is not None else "")
    if info.get("rel_residual_sampled_ucb") is not None:
        sampled += (f"(ucb {info['rel_residual_sampled_ucb']:.2e}, "
                    f"maxrow {info['rel_residual_maxrow_ratio']:.1f}, "
                    f"seed {info['residual_sample_seed']}) ")
    print(f"accs {accs} wall {wall:.1f}s rel {est}{info['rel_residual']:.2e} "
          f"(unrefined {info['rel_residual_unrefined']:.2e}) {sampled}"
          f"refinements {info['refinements']} "
          f"log_evidence {info['log_evidence']:.6g} "
          f"timings {info['timings_s']}", flush=True)
    for phase, seconds in info["timings_s"].items():
        peak = info["peak_bytes"].get(phase)
        print(f"phase {phase}: {seconds:.3f} s, peak card memory "
              + ("n/a" if peak is None else f"{peak / 1e9:.3f} GB"),
              flush=True)
    if a.out_predictions and root:
        np.save(a.out_predictions, np.concatenate(info["predictions"]))
    if a.save_posterior and root:
        from cnn_gp_tpu_torch.serving import save_posterior
        out = save_posterior(a.save_posterior, train_x=tr_x,
                             alpha=info["alpha"], scalings=info["scalings"],
                             jitter_raw=info["jitter_raw"],
                             config_name=a.config)
        print(f"posterior saved to {out}; serve it with a fresh\n"
              f"  python -m cnn_gp_tpu_torch.scripts.device_large_scale "
              f"--serve_posterior={out} <same data flags>", flush=True)

    if a.check_scipy and root:
        t0 = time.perf_counter()
        kxx = np.asarray(gram_in_memory(model, tr_x, device=device,
                                        batch_size=a.batch_size,
                                        progress=False), np.float64)
        kzx = np.asarray(gram_in_memory(model, te_x, tr_x, device=device,
                                        batch_size=a.batch_size,
                                        progress=False), np.float64)
        t1 = time.perf_counter()
        a_ref = solve.solve_gp(kxx.copy(), solve.one_hot_targets(tr_y),
                               method="scipy")
        t2 = time.perf_counter()
        agree = float(np.mean(solve.predict(kzx, a_ref)
                              == info["predictions"][-1]))
        print(f"scipy pipeline: gram+fetch {t1 - t0:.1f}s "
              f"solve {t2 - t1:.1f}s; prediction agreement: {agree}",
              flush=True)
        if a.variances:
            kzz = compute_gram_diag(model, te_x, device=device,
                                    batch_size=a.batch_size,
                                    progress=False).astype(np.float64)
            t3 = time.perf_counter()
            want = solve.predictive_variance(kxx, kzx, kzz)
            got = np.asarray(info["variances"][-1], np.float64)
            scale = float(kzz.mean())
            print(f"variance oracle ({time.perf_counter() - t3:.1f}s): "
                  f"max |dev-f64|/scale = "
                  f"{np.abs(got - want).max() / scale:.2e}", flush=True)
    return {"accs": accs, "info": info}


def _serve(a, model, splits, device, mesh=None) -> dict:
    """Serving-mode timing: load the O(N) posterior and score the same
    synthetic splits in this process with no solve (plus variances after
    the solve-free factor rebuild with --variances, row-sharded over
    ``mesh`` when given)."""
    from cnn_gp_tpu_torch.serving import GPPredictor, load_posterior

    t0 = time.perf_counter()
    posterior = load_posterior(a.serve_posterior)
    predictor = GPPredictor(model, posterior, batch_size=a.batch_size,
                            device=device)
    print(f"posterior loaded in {time.perf_counter() - t0:.1f}s "
          f"(n={posterior.n}, config={posterior.config_name!r})", flush=True)
    if a.variances:
        _reset_peak(device)
        t0 = time.perf_counter()
        predictor.prepare_variances(block=a.block, mesh=mesh)
        print(f"factor rebuilt (no solve) in "
              f"{time.perf_counter() - t0:.1f}s, peak card memory "
              f"{_peak_gb(device)}", flush=True)
    out = []
    for i, (zx, zy) in enumerate(splits):
        t0 = time.perf_counter()
        pred = predictor.classify(zx)
        acc = float(np.mean(pred == np.asarray(zy)))
        print(f"split {i}: acc {acc} ({len(zx)} points in "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
        var = None
        if a.variances:
            t0 = time.perf_counter()
            var = predictor.variances(zx)
            print(f"split {i}: var mean {var.mean():.4e} min "
                  f"{var.min():.4e} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)
        out.append((acc, pred, var))
    return {"served": out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mnist_as_tf",
                   help="config name from cnn_gp_tpu_torch.configs")
    p.add_argument("--n_train", type=int, default=16384,
                   help="training examples")
    p.add_argument("--n_test", type=int, default=2048,
                   help="test (+validation) examples")
    p.add_argument("--n_validation", type=int, default=0,
                   help="carve this many of n_test into a validation split")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--block", type=int, default=2048,
                   help="Cholesky block size")
    p.add_argument("--seed", type=int, default=0, help="synthetic data seed")
    p.add_argument("--refine_iters", type=int, default=1,
                   help="refinement sweeps cap; 0 = solve once and report "
                        "the residual of the unrefined iterate")
    p.add_argument("--residual_check", default="sampled",
                   choices=["sampled", "full"],
                   help="'sampled' estimates the residual on ~1024 rows and "
                        "escalates to the exact sweep only near tol; 'full' "
                        "always pays the exact sweep")
    p.add_argument("--residual_accept_frac", type=float, default=1.0,
                   help="the sampled estimate's +3-SE upper confidence "
                        "bound must clear this fraction of tol to skip the "
                        "exact sweep")
    p.add_argument("--residual_sample_seed", type=int, default=-1,
                   help="seed for the randomized residual row sample; -1 "
                        "draws a fresh seed (recorded in the run output)")
    add_bool_flag(p, "variances", False,
                  "also compute matrix-free GP posterior variances "
                  "(compared against the float64 oracle under "
                  "--check_scipy)")
    add_bool_flag(p, "check_scipy", False,
                  "cross-check predictions against the float64 scipy "
                  "pipeline (explicit Grams; feasible to ~16k)")
    p.add_argument("--out_predictions", default="",
                   help="optional .npy output path")
    p.add_argument("--save_posterior", default="",
                   help="persist the solved posterior (serving) to this "
                        "path after the classify run")
    p.add_argument("--serve_posterior", default="",
                   help="skip the solve: load this posterior and serve the "
                        "synthetic splits (the same data flags and seed "
                        "regenerate them)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    with multihost.grouped(a) as (device, mesh):
        return run(a, device, mesh=mesh)


if __name__ == "__main__":
    main()

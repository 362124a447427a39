"""Online data addition end to end: IncrementalGP.add(m) against a refit.

PyTorch counterpart of ``scripts/incremental_bench.py``.  The extension
alone (``extend_bench``) works on a matrix that costs nothing to make; in
the real workload a refit's largest cost is assembling the Gram again.
This times what a user waits for: ``IncrementalGP.add`` of m new points
in ``--batches`` calls (cross Gram blocks, the factor's extension, the
refined solve) against an ``IncrementalGP`` fitted from scratch on all
n + m points, with the same config on the same card, and requires the two
posteriors to agree (the same test predictions, log evidence within 1e-4
relative) so the speedup is for the same answer.  It prints the seconds
and peak card memory of each step, then one JSON line.

    python -m cnn_gp_tpu_torch.scripts.incremental_bench \\
        --config=mnist_paper_convnet_gp --n=16384 --m=2048 --batches=2

The default ``--config=mnist_as_tf`` is the ResNet-32 on the layer
kernels: at 16k a long run on the card.  Every clock read follows a device
synchronisation.

With ``--coordinator_address`` (``--num_processes`` / ``--process_id``, or
``env`` under torchrun) both factors are row-sharded over the group's
ranks, as the JAX script spreads them over every local device; every rank
makes the same calls and prints its lines, and rank 0 alone the JSON
line.
"""

import argparse
import json
import time

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.parallel import IncrementalGP, multihost


def _phases(info) -> dict:
    return {k: round(v, 3) for k, v in info["timings_s"].items()}


def run(a, device, mesh=None) -> dict:
    settings.disable_tf32()
    on_card = device.type == "cuda"
    config = configs.load(a.config)
    model = config.initial_model
    n, m = a.n, a.m
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=n + m, n_test=a.n_test, shape=configs.image_shape(config),
        seed=a.seed)

    def fit(batches):
        gp = IncrementalGP(model, capacity=n + m, batch_size=a.batch_size,
                           block=a.block, jitter=a.jitter, device=device,
                           mesh=mesh)
        walls, peaks, infos = [], [], []
        for bx, by in batches:
            if on_card:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            infos.append(gp.add(bx, by))
            if on_card:
                torch.cuda.synchronize(device)
                peaks.append(torch.cuda.max_memory_allocated(device) / 1e9)
            walls.append(time.perf_counter() - t0)
        preds = gp.classify(te_x)
        return walls, peaks, infos, preds, float(np.mean(preds == te_y))

    # online: the first fit at n, then m points in --batches add() calls
    nb = max(1, a.batches)
    cuts = np.linspace(n, n + m, nb + 1).astype(int)
    stream = [(tr_x[:n], tr_y[:n])] + [
        (tr_x[c0:c1], tr_y[c0:c1]) for c0, c1 in zip(cuts[:-1], cuts[1:])]
    walls, peaks, infos, preds_inc, acc_inc = fit(stream)
    ev_inc = infos[-1]["log_evidence"]
    residuals = ", ".join(f"{i['rel_residual']:.2e}" for i in infos)
    print(f"incremental: first_fit(n={n})={walls[0]:.3f}s adds(m={m} in "
          f"{nb})={[round(t, 3) for t in walls[1:]]}s acc={acc_inc:.4f} "
          f"log_evidence={ev_inc:.10g} rel_residuals=[{residuals}] "
          f"peak_gb={[round(p, 3) for p in peaks]} phases_s="
          f"{[_phases(i) for i in infos]}", flush=True)

    # the whole n + m system from scratch, on the same card factor
    (t_refit,), refit_peak, infos_f, preds_full, acc_full = fit(
        [(tr_x, tr_y)])
    ev_full = infos_f[-1]["log_evidence"]
    print(f"refit(n+m={n + m}): {t_refit:.3f}s acc={acc_full:.4f} "
          f"log_evidence={ev_full:.10g} rel_residual="
          f"{infos_f[-1]['rel_residual']:.2e} peak_gb="
          f"{[round(p, 3) for p in refit_peak]} phases_s="
          f"{_phases(infos_f[-1])}", flush=True)

    agree = float(np.mean(preds_inc == preds_full))
    ev_rel = abs(ev_inc - ev_full) / max(abs(ev_full), 1e-30)
    # gates: the incremental posterior must BE the refit posterior; the
    # evidence bound allows two float32 factors of one system and catches
    # a broken extension, which is off by orders of magnitude
    assert agree == 1.0, f"prediction agreement {agree}"
    assert ev_rel < 1e-4, f"evidence mismatch rel {ev_rel:.2e}"
    t_add = sum(walls[1:])
    out = {"config": a.config, "n": n, "m": m, "block": a.block,
           "batches": nb, "jitter": a.jitter,
           "first_fit_s": walls[0], "add_s": t_add,
           "add_s_per_batch": walls[1:], "refit_s": t_refit,
           "speedup_vs_refit": t_refit / t_add,
           "first_fit_peak_gb": peaks[0] if peaks else None,
           "add_peak_gb": peaks[1:] if peaks else None,
           "refit_peak_gb": refit_peak[0] if refit_peak else None,
           "first_fit_phases_s": infos[0]["timings_s"],
           "add_phases_s": [i["timings_s"] for i in infos[1:]],
           "refit_phases_s": infos_f[-1]["timings_s"],
           "pred_agreement": agree, "evidence_rel_diff": ev_rel}
    if multihost.is_root(mesh):
        print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mnist_as_tf", help="config name")
    p.add_argument("--n", type=int, default=16384,
                   help="initial training-set size")
    p.add_argument("--m", type=int, default=2048, help="points added online")
    p.add_argument("--batches", type=int, default=1,
                   help="split the m added points into this many add() "
                        "calls")
    p.add_argument("--n_test", type=int, default=512,
                   help="held-out points for the prediction-agreement gate")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--block", type=int, default=1024,
                   help="Cholesky block size")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="jitter relative to the first batch's mean diagonal")
    p.add_argument("--seed", type=int, default=0, help="synthetic data seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    with multihost.grouped(a) as (device, mesh):
        return run(a, device, mesh=mesh)


if __name__ == "__main__":
    main()

"""Validate every single-card solver on a real paper-config NNGP Gram.

PyTorch counterpart of ``scripts/solver_validation.py``, with its flags
and defaults plus ``--device``: assembles a genuine config's Gram at
nontrivial N on the card (``gram_device``; a ResNet-32 Gram's diagonal
reaches the ~1e12 scale that the float64 reference solve exists for) and
runs the float64 scipy solve beside the card's solvers, reporting each
one's wall seconds (device synchronised before every clock read), float64
residual, distance from the scipy solution and prediction agreement.

The rows: ``scipy`` (host float64 LAPACK), ``chol_ir`` (whole-matrix
float32 Cholesky on the card, float64 refinement), ``chol_dist`` (the
blocked float32 card factor of the equilibrated Gram, fed from the Gram
already on the card, float64 refinement) and ``device_large``
(``classify_device_large``: tiles regenerated into the factor, nothing
N^2 on the host, its jitter the same absolute jitter).  The mesh CG row
of the JAX script (``cg_solve_sharded`` on ``make_mesh``) belongs to the
multi-GPU work (ROADMAP item 11): ``--solvers=cg`` raises.

    python -m cnn_gp_tpu_torch.scripts.solver_validation \\
        --config=mnist_as_tf --n=4096

Prints a markdown table, then one JSON line.
"""

import argparse
import json
import time

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import classify_device_large, gram_device
from cnn_gp_tpu_torch.parallel.chol_dist import chol_solve_dist
from cnn_gp_tpu_torch.utils import (add_bool_flag, resolve_device,
                                    synced_clock)

SOLVERS = ("scipy", "chol_ir", "chol_dist", "device_large")


def assemble(model, n, n_test, batch, in_channels, device, side=28):
    """Kxx [n, n] on the card and in host float64, Kzx [n_test, n] in host
    float64, and the data, on a real paper kernel with synthetic inputs
    (conditioning depends on the architecture and the input statistics,
    not on which digits the pixels draw)."""
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=n, n_test=n_test, shape=(in_channels, side, side), seed=0)
    t0 = synced_clock(device)
    k_dev = gram_device(model, tr_x, batch_size=batch, device=device)
    kxx = k_dev.cpu().numpy().astype(np.float64)
    kzx = gram_device(model, te_x, tr_x, batch_size=batch,
                      device=device).cpu().numpy().astype(np.float64)
    print(f"assembled Kxx {kxx.shape} + Kzx {kzx.shape} in "
          f"{synced_clock(device) - t0:.1f}s")
    return kxx, kzx, k_dev, (tr_x, tr_y, te_x, te_y)


def cond_estimate(kxx, jitter):
    """Condition number of the Jacobi-equilibrated system (what the
    float32 factorisation sees) and its smallest eigenvalue."""
    d = np.sqrt(np.diagonal(kxx) + jitter)
    ks = (kxx + jitter * np.eye(len(kxx))) / d[:, None] / d[None, :]
    w = np.linalg.eigvalsh(ks)
    return float(w[-1] / w[0]), float(w[0])


def run(a, device) -> dict:
    solvers = a.solvers.split(",")
    if "cg" in solvers:
        raise NotImplementedError(
            "--solvers=cg: the mesh CG solver (cg_solve_sharded on "
            "make_mesh) is not ported, ROADMAP item 11 (multi-GPU)")
    unknown = sorted(set(solvers) - set(SOLVERS))
    if unknown:
        raise ValueError(f"unknown solvers {unknown}; choose from "
                         f"{', '.join(SOLVERS)}")
    settings.disable_tf32()
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    config = configs.load(a.config)
    model = config.initial_model
    n, jitter = a.n, a.jitter
    kxx, kzx, k_dev, (tr_x, tr_y, te_x, te_y) = assemble(
        model, n, a.n_test, a.batch, config.in_channels, device)
    y = solve.one_hot_targets(tr_y)
    diag = np.diagonal(kxx)
    print(f"diag range: [{diag.min():.3e}, {diag.max():.3e}]  offdiag max: "
          f"{np.abs(kxx - np.diag(diag)).max():.3e}")
    cond = None
    if a.eig:
        t0 = time.perf_counter()
        cond, lmin = cond_estimate(kxx, jitter)
        print(f"equilibrated cond(Ks) = {cond:.3e} (lambda_min {lmin:.3e}, "
              f"eigvalsh {time.perf_counter() - t0:.0f}s)")

    results = {}

    def record(name, fn):
        t0 = synced_clock(device)
        sol, extra = fn()
        dt = synced_clock(device) - t0
        r = y - (kxx @ sol + jitter * sol)
        rel = float(np.max(np.linalg.norm(r, axis=0)
                           / np.linalg.norm(y, axis=0)))
        results[name] = dict(a=sol, t=dt, rel=rel,
                             pred=solve.predict(kzx, sol), extra=extra)
        print(f"{name:12s} {dt:8.3f}s  rel_resid {rel:.2e}  {extra}")

    if "scipy" in solvers:
        record("scipy", lambda: (
            solve.solve_gp(kxx.copy(), y, jitter=jitter, method="scipy"),
            "float64 LAPACK"))
    if "chol_ir" in solvers:
        record("chol_ir", lambda: (
            solve.solve_gp(kxx.copy(), y, jitter=jitter, method="chol_ir",
                           device=device),
            "whole-matrix f32 + IR"))
    if "chol_dist" in solvers:
        def _dist():
            sol, _, iters = chol_solve_dist(kxx.copy(), y, jitter=jitter,
                                            block=a.block, k_dev=k_dev,
                                            device=device)
            return sol, (f"blocked f32 + IR, {iters} refinements "
                         f"(card-resident gram)")
        record("chol_dist", _dist)
    del k_dev                 # chol_dist consumed it
    if "device_large" in solvers:
        def _large():
            _, info = classify_device_large(
                model, tr_x, tr_y, (te_x, te_y), batch_size=a.batch,
                block=a.block, jitter=jitter / float(np.mean(diag)),
                residual_check="full", verbose=False, device=device)
            return info["alpha"], (f"regenerated tiles, f32 factor + IR, "
                                   f"{info['refinements']} refinements")
        record("device_large", _large)

    base = results.get("scipy")
    rows = {}
    print("\n| solver | wall | rel residual | vs scipy (rel) | "
          "pred agreement | notes |")
    print("|---|---|---|---|---|---|")
    for name, r in results.items():
        vs = agree = None
        if base is not None and name != "scipy":
            vs = float(np.abs(r["a"] - base["a"]).max()
                       / np.abs(base["a"]).max())
            agree = float(np.mean(r["pred"] == base["pred"]))
        print(f"| {name} | {r['t']:.3f}s | {r['rel']:.2e} | "
              f"{'—' if vs is None else f'{vs:.2e}'} | "
              f"{'—' if agree is None else f'{agree:.4f}'} | {r['extra']} |")
        rows[name] = {"seconds": r["t"], "rel_residual": r["rel"],
                      "vs_scipy": vs, "pred_agreement": agree,
                      "test_accuracy": solve.accuracy(r["pred"], te_y),
                      "notes": r["extra"]}
    out = {"config": a.config, "n": n, "n_test": a.n_test,
           "jitter": jitter, "equilibrated_cond": cond, "rows": rows}
    print(json.dumps(out), flush=True)
    out["solutions"] = {k: r["a"] for k, r in results.items()}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mnist_as_tf",
                   help="config to build the kernel")
    p.add_argument("--n", type=int, default=4096, help="train Gram size")
    p.add_argument("--n_test", type=int, default=512, help="test rows")
    p.add_argument("--batch", type=int, default=128, help="Gram tile size")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="diagonal jitter (absolute)")
    p.add_argument("--block", type=int, default=1024,
                   help="chol_dist / device_large block size")
    p.add_argument("--solvers", default=",".join(SOLVERS),
                   help="comma list of solvers to run (cg: not ported)")
    add_bool_flag(p, "eig", True,
                  "compute the equilibrated condition number")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

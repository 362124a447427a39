"""Given a pre-computed kernel and a data set, compute accuracy.

PyTorch counterpart of ``exp_mnist_resnet/classify_gp.py``, with the same
flag names plus ``--device``: loads the (upper-triangle) train Gram, adds
``--jitter`` to the diagonal, solves Kxx^-1 Y with +-1 one-hot targets and
reports validation/test accuracy.  ``--solver=scipy`` is the float64 host
oracle; ``--solver=chol`` is a float64 Cholesky on ``--device``;
``--solver=chol_ir`` a float32 Cholesky on ``--device`` refined in float64;
``--solver=chol_dist`` the Jacobi-equilibrated blocked float32 factor on
``--device`` (``parallel/chol_dist.py``), fed from one float32 copy of the
store's Kxx, streamed (``--stream``, the default: read, mirror and upload
overlap) or read whole (``--nostream``).

``--variances`` (predictive-std summaries per split, from the stored
Kv_diag/Kt_diag), ``--evidence`` (train log marginal likelihood, also
printed with ``--variances``) and ``--lpd`` (held-out log predictive
density, with ``--jitter`` as the observation noise) need the factor of
the solve: ``--solver=scipy`` (one float64 factorisation serves all three)
or ``--solver=chol_dist`` (through the float32 card factor).

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp \\
        --config=mnist_paper_convnet_gp --in_path=k.h5 --solver=chol

With ``--coordinator_address`` (``--num_processes`` / ``--process_id``, or
``env`` under torchrun), ``--solver=chol_dist`` row-shards the factor over
the group's ranks (``ShardedFactor``): rank 0 alone reads Kxx and sends
each rank its rows; every rank reads the cross Grams and reports:

    torchrun --nproc_per_node=4 \\
        -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp \\
        --coordinator_address=env --solver=chol_dist --in_path=k.h5 ...
"""

import argparse
import time
from typing import Optional

import numpy as np

from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.data import DatasetFromConfig, open_store
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import multihost
from cnn_gp_tpu_torch.utils import add_bool_flag


def _checked(name, arr):
    """Refuse a Gram with NaN or Inf entries (an incomplete or unmerged
    assembly) instead of turning it into a garbage accuracy."""
    if not np.isfinite(np.asarray(arr)).all():
        raise RuntimeError(
            f"{name} has non-finite entries (incomplete or unmerged "
            f"assembly?); rerun assembly — tile-level resume will skip "
            f"finished tiles")
    return arr


def flag_error(solver: str, jitter: float, variances: bool, evidence: bool,
               lpd: bool) -> Optional[str]:
    """Why this flag combination is refused before anything is read, or
    None."""
    if (variances or evidence or lpd) and solver not in ("scipy",
                                                         "chol_dist"):
        return ("--variances/--evidence/--lpd need a factor to whiten "
                "against: use --solver=scipy (float64 oracle, one "
                "factorisation serves solve, variances and evidence) or "
                "--solver=chol_dist (float32 card factor)")
    if lpd and jitter <= 0:
        return ("--lpd uses --jitter as the observation noise, so it needs "
                "--jitter > 0 (a variance clipped to 0 has no density)")
    return None


def run(config, in_path: str, *, datasets_path: str, device=None,
        jitter: float = 0.0, solver: str = "scipy", variances: bool = False,
        evidence: bool = False, lpd: bool = False,
        stream: bool = True, store_backend: str = "auto",
        mesh=None) -> dict:
    """Solve on the stored Kxx and score both splits.  Returns
    ``{"validation": (accuracy, predictions), "test": (...)}``, plus
    ``"log_evidence"`` (with ``evidence`` or ``variances``),
    ``"variances"`` (split -> [n] array, with ``variances`` or ``lpd``) and
    ``"lpd"`` (split -> (mean, se), with ``lpd``).  ``mesh`` (with
    ``solver="chol_dist"`` only) row-shards the factor over a rank
    group."""
    err = flag_error(solver, jitter, variances, evidence, lpd)
    if err:
        raise ValueError(err)
    if mesh is not None and solver != "chol_dist":
        raise ValueError("a rank group row-shards --solver=chol_dist's "
                         "factor; the other solvers run on one device")
    want_var = variances or lpd
    want_stats = want_var or evidence
    t = [time.perf_counter()]

    def tick(name):
        now = time.perf_counter()
        print(f"[classify_gp] {name}: {now - t[0]:.1f}s", flush=True)
        t[0] = now

    dataset = DatasetFromConfig(datasets_path, config)
    y_1hot = solve.one_hot_targets(dataset.train.labels)
    splits = (("validation", "Kxvx", "Kv_diag", dataset.validation),
              ("test", "Kxtx", "Kt_diag", dataset.test))
    results = {}
    var = None
    with open_store(in_path, "r", backend=store_backend) as f:
        if solver == "chol_dist":
            from cnn_gp_tpu_torch.parallel.chol_dist import (
                chol_solve_dist_from_store, chol_solve_stream_from_store,
                evidence_from_factor, variances_from_cross_host)
            if stream:
                out = chol_solve_stream_from_store(
                    f, "Kxx", y_1hot, jitter=jitter, check_finite=True,
                    verbose=True, return_factor=want_stats,
                    device=device, mesh=mesh)
            else:
                out = chol_solve_dist_from_store(
                    f, "Kxx", y_1hot, jitter=jitter, check_finite=True,
                    return_factor=want_stats,
                    device=device, mesh=mesh)
            a, rel, iters = out[:3]
            print(f"refined to rel residual {rel:.2e} in {iters} iterations")
            if rel > 1e-6:
                print("warning: refinement stagnated -- consider a larger "
                      "--jitter")
            tick("solve (incl. Kxx read)")
        else:
            kxx = _checked("Kxx", solve.symmetrize_from_upper(
                f.read("Kxx", dtype=np.float64)))
        kzx = {s: _checked(name, f.read(name)) for s, name, _, _ in splits}
        kzz = ({s: _checked(name, f.read(name)) for s, _, name, _ in splits}
               if want_var else None)
    tick("read")
    if solver == "chol_dist":
        if want_stats:
            factor, s = out[3], out[4]
            if want_var:
                # float32-factor floor ~eps32 * k_zz (the float64 oracle is
                # --solver=scipy)
                var = {sp: variances_from_cross_host(factor, s, kzx[sp],
                                                     kzz[sp])
                       for sp, *_ in splits}
                results["variances"] = var
            if variances or evidence:
                ev = evidence_from_factor(factor, s, y_1hot, a)
                results["log_evidence"] = ev
                print(f"train log evidence: {ev:.6g}")
            del factor, out
            tick("variances+evidence")
    elif want_stats:
        stats = solve.solve_gp_stats(
            kxx, y_1hot, jitter=jitter,
            splits=[(kzx[s], kzz[s]) for s, *_ in splits] if want_var
            else ())
        a = stats["alpha"]
        if want_var:
            var = dict(zip((s for s, *_ in splits), stats["variances"]))
            results["variances"] = var
        if variances or evidence:
            results["log_evidence"] = stats["log_evidence"]
            print(f"train log evidence: {stats['log_evidence']:.6g}")
    else:
        a = solve.solve_gp(kxx, y_1hot, jitter=jitter, method=solver,
                           device=device)
    if solver != "chol_dist":
        del kxx
        tick("solve")
    for split, _, _, labels in splits:
        scores = np.asarray(kzx[split], a.dtype) @ a
        pred = np.argmax(scores, axis=1)
        acc = solve.accuracy(pred, labels.labels)
        print(f"{split} accuracy: {acc * 100}%")
        results[split] = (acc, pred)
        if variances:
            std = np.sqrt(var[split])
            print(f"{split} predictive std: mean {std.mean():.4e}  "
                  f"min {std.min():.4e}  max {std.max():.4e}")
        if lpd:
            mean, se, _ = solve.gaussian_lpd(scores, var[split],
                                             labels.labels, noise=jitter)
            results.setdefault("lpd", {})[split] = (mean, se)
            print(f"{split} lpd: {mean:.4f} +- {se:.4f} nats/point")
    tick("predict")
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--config", default="mnist",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--in_path", default=None,
                   help="path of h5 file to load kernels from")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="add to the diagonal")
    p.add_argument("--store_backend", default="auto",
                   choices=["auto", "h5", "zarr"],
                   help="auto (by extension) | h5 | zarr (TensorStore)")
    p.add_argument("--solver", default="scipy",
                   choices=["scipy", "chol", "chol_ir", "chol_dist"],
                   help="scipy (float64 LAPACK on the host) | chol "
                        "(float64 Cholesky on --device) | chol_ir (float32 "
                        "Cholesky on --device + float64 iterative "
                        "refinement) | chol_dist (equilibrated blocked "
                        "float32 Cholesky on --device + refinement)")
    p.add_argument("--variances", action="store_true",
                   help="also report GP posterior predictive-std summaries "
                        "per split from the stored Kv_diag/Kt_diag "
                        "(--solver=scipy: float64 oracle; --solver=chol_dist: "
                        "float32-factor floor)")
    p.add_argument("--evidence", action="store_true",
                   help="also report the train GP log marginal likelihood "
                        "(implied by --variances)")
    p.add_argument("--lpd", action="store_true",
                   help="also report held-out log predictive density (mean "
                        "+- SE nats/point) per split; the noise is --jitter, "
                        "which must be > 0 (--solver=scipy or chol_dist)")
    add_bool_flag(p, "stream", True,
                  "--solver=chol_dist only: stream the Kxx read, mirror "
                  "and upload concurrently (--nostream: read it whole "
                  "first; the same outputs)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --solver=chol/chol_ir/chol_dist")
    multihost.add_group_flags(p)
    a = p.parse_args(argv)
    if a.in_path is None:
        p.error("--in_path is required")
    err = flag_error(a.solver, a.jitter, a.variances, a.evidence, a.lpd)
    if err:
        p.error(err)
    if a.coordinator_address and a.solver != "chol_dist":
        p.error("--coordinator_address needs --solver=chol_dist (the "
                "row-sharded factor)")
    with multihost.grouped(a) as (device, mesh):
        run(configs.load(a.config), a.in_path,
            datasets_path=a.datasets_path, device=device, jitter=a.jitter,
            solver=a.solver, variances=a.variances, evidence=a.evidence,
            lpd=a.lpd, stream=a.stream, store_backend=a.store_backend,
            mesh=mesh)


if __name__ == "__main__":
    main()

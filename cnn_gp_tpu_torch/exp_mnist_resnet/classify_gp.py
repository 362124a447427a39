"""Given a pre-computed kernel and a data set, compute accuracy.

PyTorch counterpart of ``exp_mnist_resnet/classify_gp.py``, with the same
flag names plus ``--device``: loads the (upper-triangle) train Gram, adds
``--jitter`` to the diagonal, solves Kxx^-1 Y with +-1 one-hot targets and
reports validation/test accuracy.  ``--solver=scipy`` is the float64 host
oracle; ``--solver=chol`` is a float64 Cholesky on ``--device``.

``--variances`` (predictive-std summaries per split, from the stored
Kv_diag/Kt_diag), ``--evidence`` (train log marginal likelihood, also
printed with ``--variances``) and ``--lpd`` (held-out log predictive
density, with ``--jitter`` as the observation noise) need the factor of
the solve: one float64 factorisation serves all three (``--solver=scipy``
only; ``chol_dist`` is not ported).

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp \\
        --config=mnist_paper_convnet_gp --in_path=k.h5 --solver=chol
"""

import argparse
import time
from typing import Optional

import numpy as np

from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch.data import DatasetFromConfig, GramStore
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.utils import resolve_device


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
    if (variances or evidence or lpd) and solver != "scipy":
        return ("--variances/--evidence/--lpd need the factor of the "
                "solve: use --solver=scipy (one float64 factorisation "
                "serves solve, variances and evidence); --solver=chol_dist "
                "is not ported yet (ROADMAP.md)")
    if lpd and jitter <= 0:
        return ("--lpd uses --jitter as the observation noise, so it needs "
                "--jitter > 0 (a variance clipped to 0 has no density)")
    return None


def run(config, in_path: str, *, datasets_path: str, device=None,
        jitter: float = 0.0, solver: str = "scipy", variances: bool = False,
        evidence: bool = False, lpd: bool = False) -> dict:
    """Solve on the stored Kxx and score both splits.  Returns
    ``{"validation": (accuracy, predictions), "test": (...)}``, plus
    ``"log_evidence"`` (with ``evidence`` or ``variances``),
    ``"variances"`` (split -> [n] array, with ``variances`` or ``lpd``) and
    ``"lpd"`` (split -> (mean, se), with ``lpd``)."""
    err = flag_error(solver, jitter, variances, evidence, lpd)
    if err:
        raise ValueError(err)
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
    with GramStore(in_path, "r") as f:
        kxx = _checked("Kxx", solve.symmetrize_from_upper(
            f.read("Kxx", dtype=np.float64)))
        kzx = {s: _checked(name, f.read(name)) for s, name, _, _ in splits}
        kzz = ({s: _checked(name, f.read(name)) for s, _, name, _ in splits}
               if want_var else None)
    tick("read")
    results = {}
    var = None
    if want_stats:
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
    p.add_argument("--store_backend", default="auto", choices=["auto", "h5"],
                   help="HDF5 only; the TensorStore backend is not ported")
    p.add_argument("--solver", default="scipy", choices=["scipy", "chol"],
                   help="scipy (float64 LAPACK on the host) | chol "
                        "(float64 Cholesky on --device)")
    p.add_argument("--variances", action="store_true",
                   help="also report GP posterior predictive-std summaries "
                        "per split from the stored Kv_diag/Kt_diag "
                        "(--solver=scipy)")
    p.add_argument("--evidence", action="store_true",
                   help="also report the train GP log marginal likelihood "
                        "(implied by --variances)")
    p.add_argument("--lpd", action="store_true",
                   help="also report held-out log predictive density (mean "
                        "+- SE nats/point) per split; the noise is --jitter, "
                        "which must be > 0 (--solver=scipy)")
    p.add_argument("--device", default="cuda",
                   help="torch device for --solver=chol")
    a = p.parse_args(argv)
    if a.in_path is None:
        p.error("--in_path is required")
    err = flag_error(a.solver, a.jitter, a.variances, a.evidence, a.lpd)
    if err:
        p.error(err)
    run(configs.load(a.config), a.in_path, datasets_path=a.datasets_path,
        device=resolve_device(a.device), jitter=a.jitter, solver=a.solver,
        variances=a.variances, evidence=a.evidence, lpd=a.lpd)


if __name__ == "__main__":
    main()

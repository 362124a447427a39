"""Run the JAX package's ``__graft_entry__.dryrun_multichip(n)`` and save
what its sequence computed, for ``tests/test_torch_entry.py``.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N \\
        python tests/_torch_jax_dryrun.py N OUT.npz

The dry run prints its numbers to four digits and returns None, so the
library calls it makes are wrapped, before it imports them, by recorders
that keep their results at full precision: the two sharded Grams, the
Cholesky solve's weights, ``classify_device_large``'s predictions,
variances and evidence, the held-out LPD, the grown factor's evidence and
predictions, and the probed fit's losses.  The summary line goes to
standard output as the dry run prints it.
"""

import importlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(n: int, out_path: str) -> None:
    sys.path.insert(0, REPO)
    import __graft_entry__ as G
    from cnn_gp_tpu import parallel
    from cnn_gp_tpu.ops import solve
    jfit = importlib.import_module("cnn_gp_tpu.fit")
    calls = {}

    def record(owner, name):
        body = getattr(owner, name)

        def recorded(*a, **k):
            out = body(*a, **k)
            calls.setdefault(name, []).append(out)
            return out
        setattr(owner, name, recorded)

    for name in ("compute_gram_sharded", "chol_solve_dist",
                 "classify_device_large"):
        record(parallel, name)
    record(solve, "gaussian_lpd")
    record(jfit, "fit_large")
    record(parallel.IncrementalGP, "add")
    record(parallel.IncrementalGP, "classify")
    G.dryrun_multichip(n)

    kxx, kzx = (np.asarray(k) for k in calls["compute_gram_sharded"])
    a = np.asarray(calls["chol_solve_dist"][0][0])
    _, info = calls["classify_device_large"][0]
    lpd = calls["gaussian_lpd"][-1][0]
    np.savez(
        out_path, kxx=kxx, kzx=kzx,
        predictions=solve.predict(np.asarray(kzx, np.float64), a),
        large_predictions=np.asarray(info["predictions"][0]),
        variances=np.asarray(info["variances"][0]),
        log_evidence=info["log_evidence"], logdet=info["logdet"], lpd=lpd,
        incremental_predictions=np.asarray(calls["classify"][-1]),
        incremental_log_evidence=calls["add"][-1]["log_evidence"],
        losses=np.asarray(calls["fit_large"][0][1]))


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])

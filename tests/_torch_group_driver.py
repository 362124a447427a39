"""Run one of the port's drivers and save what its library calls returned.

    python tests/_torch_group_driver.py OUT.npz <module> [args...]

imports ``<module>``, records the results of the library calls that a
rank group shards (``classify_device_large``, ``GPPredictor.classify`` /
``.variances``, ``fit_large``, ``IncrementalGP.add`` / ``.classify``)
while its ``main(args)`` runs, and the ``rows`` its ``main`` returns,
and saves them to OUT.npz, one array per call in call order: the
accuracies and predictions, the log evidence, the mean predictive std,
the fit's losses and each row's numbers.  ``recording(module)`` does the
same in the calling process, so a test holds a group's ranks against the
same driver on one device.  The process imports the port only, never
jax.
"""

import contextlib
import importlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _concat(arrays):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays])


def _mean_std(variances):
    return [float(np.mean(np.sqrt(v))) for v in variances]


def rows(res) -> dict:
    """The numbers of the ``rows`` a driver's ``main`` returned (a dict of
    tuples, or a list of dicts), by row."""
    got = res.get("rows") if isinstance(res, dict) else None
    if isinstance(got, dict):
        return {f"rows.{k}": np.asarray(v, np.float64)
                for k, v in got.items()}
    return {f"rows.{i}": np.asarray([r["log_evidence"], r["test_acc"]])
            for i, r in enumerate(got or ())}


@contextlib.contextmanager
def recording(module):
    """Record the sharded library calls ``module`` makes inside the
    ``with``: a dict of named arrays, keys numbered in call order."""
    from cnn_gp_tpu_torch.parallel import IncrementalGP
    from cnn_gp_tpu_torch.serving import GPPredictor
    out, undo = {}, []

    def put(name, **values):
        i = sum(k.startswith(name + ".") for k in out) // len(values)
        for k, v in values.items():
            out[f"{name}.{k}.{i}"] = np.asarray(v)

    def patch(owner, attr, after):
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            res = orig(*a, **k)
            after(res)
            return res
        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))

    def large(res):
        accs, info = res
        put("large", accs=accs, predictions=_concat(info["predictions"]),
            log_evidence=info["log_evidence"],
            std=(_mean_std(info["variances"])
                 if info["variances"] is not None else np.nan))

    if hasattr(module, "classify_device_large"):
        patch(module, "classify_device_large", large)
    if hasattr(module, "fit_large"):
        patch(module, "fit_large", lambda res: put("fit", losses=res[1]))
    patch(GPPredictor, "classify", lambda res: put("classify", out=res))
    patch(GPPredictor, "variances",
          lambda res: put("variances", std=_mean_std([res])))
    patch(IncrementalGP, "add",
          lambda res: put("add", log_evidence=res["log_evidence"]))
    patch(IncrementalGP, "classify",
          lambda res: put("gp_classify", out=res))
    try:
        yield out
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


def main():
    path, name, args = sys.argv[1], sys.argv[2], sys.argv[3:]
    module = importlib.import_module(name)
    with recording(module) as out:
        res = module.main(args)
    np.savez(path, **out, **rows(res))


if __name__ == "__main__":
    main()

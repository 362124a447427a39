"""Kernel model selection by GP marginal likelihood (evidence).

PyTorch counterpart of ``scripts/model_selection.py``, with its flags and
defaults plus ``--device``: ranks kernels by ``log p(y | X)`` on the
training split alone (``classify_device_large``'s ``log_evidence``, read
off the card's blocked factor), and checks the ranking against held-out
accuracy.  Every model sees the same raw data: the hard, non-separable
digits task of ``scripts/make_fake_dataset.py`` (``data.digits`` with
``hard=True``), scaled to [0, 1].

    python -m cnn_gp_tpu_torch.scripts.model_selection --n_train=2048 \\
        --n_test=512

Prints one line per model (evidence in total and per training point, test
accuracy, seconds with the device synchronised before each clock read),
the ranking, then one JSON line.
"""

import argparse
import json

import numpy as np

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import digits
from cnn_gp_tpu_torch.parallel import classify_device_large
from cnn_gp_tpu_torch.utils import resolve_device, synced_clock

MODELS = "mnist_paper_convnet_gp,mnist_paper_residual_cnn_gp,mnist_as_tf"


def task(n_train: int, n_test: int):
    """The hard digits task: (train x, train y, test x, test y)."""
    tr_x8, tr_y = digits(n_train, 28, seed=1, hard=True)
    te_x8, te_y = digits(n_test, 28, seed=2, proto_seed=1, hard=True)
    return (tr_x8[:, None].astype(np.float32) / 255.0, tr_y,
            te_x8[:, None].astype(np.float32) / 255.0, te_y)


def run(a, device) -> dict:
    settings.disable_tf32()
    tr_x, tr_y, te_x, te_y = task(a.n_train, a.n_test)

    rows = []
    for name in a.models.split(","):
        model = configs.load(name).initial_model
        t0 = synced_clock(device)
        accs, info = classify_device_large(
            model, tr_x, tr_y, (te_x, te_y), batch_size=a.batch_size,
            block=a.block, jitter=a.jitter, verbose=False, device=device)
        seconds = synced_clock(device) - t0
        ev = info["log_evidence"]
        rows.append({"config": name, "log_evidence": ev,
                     "per_datum": ev / a.n_train, "test_acc": accs[0],
                     "seconds": seconds,
                     "rel_residual": info["rel_residual"]})
        print(f"{name:32s} log_evidence {ev:.6g} (per-datum "
              f"{ev / a.n_train:.3f})  test_acc {accs[0]:.4f}  "
              f"[{seconds:.1f}s]", flush=True)

    ranked = sorted(rows, key=lambda r: -r["log_evidence"])
    best = ranked[0]
    print(f"\nevidence ranking: {' > '.join(r['config'] for r in ranked)}")
    print(f"selected {best['config']} (test_acc {best['test_acc']:.4f}; "
          f"best test_acc {max(r['test_acc'] for r in rows):.4f})")
    out = {"n_train": a.n_train, "n_test": a.n_test, "jitter": a.jitter,
           "rows": rows, "ranking": [r["config"] for r in ranked],
           "selected": best["config"]}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_train", type=int, default=2048,
                   help="training examples")
    p.add_argument("--n_test", type=int, default=512, help="held-out examples")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--block", type=int, default=512,
                   help="factor block size")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="relative diagonal jitter")
    p.add_argument("--models", default=MODELS,
                   help="comma list of configs to rank (must share the "
                        "input shape)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

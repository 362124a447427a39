"""Posterior-serving throughput on the card.

PyTorch counterpart of ``scripts/serving_bench.py``, with its flags and
defaults plus ``--device``: what a deployed ``serving.GPPredictor``
sustains, as mean-prediction queries/s and variance queries/s against an
N-point training set, through the bounded tile-regeneration sweeps
(nothing O(N^2) resident, O(len(z)) fetched per query batch).

Protocol: solve once with ``classify_device_large`` (or load a saved
posterior with ``--posterior``), then time ``classify(z)`` and
``variances(z)`` over ``--rounds`` batches of ``--query_batch`` fresh
queries.  The first call of each kind is a warm-up and is not timed; the
device is synchronised before every clock read; the reported rate is the
median over the rounds.  Prints one JSON line.

    python -m cnn_gp_tpu_torch.scripts.serving_bench \\
        --config=mnist_paper_convnet_gp --n_train=16384
"""

import argparse
import json

import numpy as np

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.parallel import classify_device_large
from cnn_gp_tpu_torch.serving import GPPredictor, Posterior, load_posterior
from cnn_gp_tpu_torch.utils import (add_bool_flag, resolve_device,
                                    synced_clock)


def median_rate(fn, make_z, rounds, batch, device):
    """(median q/s, per-round q/s list, latency percentiles dict).

    Latency is per batch (queries in, scores on the host), the number a
    serving objective is written against; with few rounds p99 tends to
    the max (raise --rounds for tail resolution)."""
    fn(make_z(0))                       # warm-up: uploads, first launches
    rates, lats = [], []
    for r in range(1, rounds + 1):
        z = make_z(r)
        t0 = synced_clock(device)
        out = fn(z)
        dt = synced_clock(device) - t0
        assert np.asarray(out).shape[0] == batch
        rates.append(batch / dt)
        lats.append(dt)
    lat_ms = np.asarray(lats) * 1e3
    pct = {"p50_ms": round(float(np.percentile(lat_ms, 50)), 1),
           "p99_ms": round(float(np.percentile(lat_ms, 99)), 1),
           "max_ms": round(float(lat_ms.max()), 1)}
    return float(np.median(rates)), rates, pct


def solve_posterior(a, model, shape, device) -> Posterior:
    """The synthetic training set (``--seed``) solved by
    ``classify_device_large``: the posterior to serve."""
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=a.n_train, n_test=a.query_batch, shape=shape, seed=a.seed)
    t0 = synced_clock(device)
    _, info = classify_device_large(
        model, tr_x, tr_y, (te_x, te_y), batch_size=a.batch_size,
        block=a.block, verbose=True, device=device)
    seconds = synced_clock(device) - t0
    print(f"solved n={a.n_train} in {seconds:.1f}s (serving would normally "
          f"load this from a posterior artifact)")
    return Posterior(train_x=tr_x, alpha=info["alpha"],
                     scalings=info["scalings"],
                     jitter_raw=info["jitter_raw"], config_name=a.config,
                     settings_snapshot=None)


def query_maker(a, shape):
    """Fresh query batches, round r of them the r-th draw of one stream
    (round 0 is the warm-up)."""
    rng = np.random.RandomState(a.seed + 1)
    return lambda r: rng.rand(a.query_batch, *shape).astype(np.float32)


def run(a, device) -> dict:
    settings.disable_tf32()
    config = configs.load(a.config)
    model = config.initial_model
    shape = configs.image_shape(config)

    if a.posterior:
        post = load_posterior(a.posterior)
        print(f"loaded posterior: n={post.n}")
    else:
        post = solve_posterior(a, model, shape, device)

    pred = GPPredictor(model, post, batch_size=a.batch_size, device=device)
    qb = a.query_batch
    make_z = query_maker(a, shape)

    mean_qps, mean_rates, mean_lat = median_rate(pred.classify, make_z,
                                                 a.rounds, qb, device)
    print(f"mean-prediction: median {mean_qps:.1f} q/s over {a.rounds} x "
          f"{qb}-query batches ({[f'{r:.1f}' for r in mean_rates]}) "
          f"latency {mean_lat}")

    var_qps = var_lat = prep = None
    if a.variances:
        t0 = synced_clock(device)
        pred.prepare_variances(block=a.block,
                               factor_cache=a.factor_cache or None)
        prep = synced_clock(device) - t0
        print(f"prepare_variances"
              f"{' (factor_cache)' if a.factor_cache else ''}: {prep:.1f}s")
        var_qps, var_rates, var_lat = median_rate(pred.variances, make_z,
                                                  a.rounds, qb, device)
        print(f"variances: median {var_qps:.1f} q/s "
              f"({[f'{r:.1f}' for r in var_rates]}) latency {var_lat}")

    out = {
        "n_train": post.n, "config": a.config,
        "query_batch": qb, "rounds": a.rounds,
        "mean_queries_per_s": round(mean_qps, 2),
        "mean_batch_latency": mean_lat,
        "variance_queries_per_s": (round(var_qps, 2)
                                   if var_qps is not None else None),
        "variance_batch_latency": var_lat,
        "prepare_variances_s": (round(prep, 3) if prep is not None
                                else None),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="mnist_as_tf",
                   help="config name from cnn_gp_tpu_torch.configs")
    p.add_argument("--posterior", default="",
                   help="serve this saved posterior artifact instead of "
                        "solving a synthetic one")
    p.add_argument("--n_train", type=int, default=16384,
                   help="training-set size when solving")
    p.add_argument("--batch_size", type=int, default=128,
                   help="Gram tile size")
    p.add_argument("--block", type=int, default=2048,
                   help="factor block size")
    p.add_argument("--query_batch", type=int, default=256,
                   help="queries per timed batch")
    p.add_argument("--rounds", type=int, default=20,
                   help="timed batches per measurement")
    p.add_argument("--factor_cache", default="",
                   help="opt-in on-disk factor cache directory (an O(N^2) "
                        "file) for prepare_variances")
    p.add_argument("--seed", type=int, default=0, help="synthetic data seed")
    add_bool_flag(p, "variances", True,
                  "also measure variance-query throughput (needs the "
                  "solve-free factor rebuild first)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

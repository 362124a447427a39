"""Gram tile-size sweep for the CIFAR-10 config on the card.

PyTorch counterpart of ``scripts/cifar_sweep.py``, with ``--config`` and
``--tiles`` as there and ``--device``: the steady-state rate of one
config's Gram tiles across tile sizes, each tile the port's
``parallel/gram.py::_tile_body`` (the tile ``compute_gram`` and
``gram_device`` launch), so the outcome is a measured default or a
written no-go.  The config's own ``kernel_batch_size`` (350 for cifar10)
is swept as it is: the CUDA path needs no lane alignment.

Protocol: per tile size, ``--reps`` tiles over a rotating set of offsets
into 4 b images are timed with CUDA events (a host clock after a
synchronisation off the card), after a warm-up; the median over
``--samples`` windows is reported.  Each row also carries the tile's FP32
operation count (``tile_ops``: counted from the shapes and the plain
path's arithmetic) and the rate that count gives, against the card's FP32
peak.  Prints one JSON line per tile size and one for the best.

    python -m cnn_gp_tpu_torch.scripts.cifar_sweep \\
        --tiles=64,128,192,256,350
"""

import argparse
import json
import time

import numpy as np
import torch

from cnn_gp_tpu_torch import configs, kernels as K, settings
from cnn_gp_tpu_torch.ops import boxfilter, megakernel
from cnn_gp_tpu_torch.parallel.gram import _tile_body
from cnn_gp_tpu_torch.utils import FP32_PEAK, resolve_device

RELU_OPS = 38              # per pair and pixel: the arccos update (37
                           # counted from csrc/megakernel.cu, acos 23 of
                           # them) and the same-example select


def _conv_ops(layer, fields, w, h):
    """(operations, w', h') of one Conv2d on ``fields`` maps of w x h: the
    separable shift-sum (k - 1 adds per output of each pass, over the
    padded length), then the scale and bias."""
    k, s, d = layer.kernel_size, layer.stride, layer.dilation
    lo, hi = layer.pad_lo_hi
    w2 = boxfilter.out_size(w, k, s, (lo, hi), d)
    h2 = boxfilter.out_size(h, k, s, (lo, hi), d)
    ops = fields * (k - 1) * (w2 * (h + lo + hi) + w2 * h2)
    return ops + 2 * fields * w2 * h2, w2, h2


def tile_ops(model, b: int, shape) -> float:
    """FP32 operations of one symmetric [b, b] tile of ``model`` on the
    plain path: the channel-mean moments (2 C per pair and pixel), then
    per layer over the b^2 pair maps and the 2 b variance maps: box sums,
    scale and bias for a Conv2d; the arccos update for a ReLU (halving
    for the variance maps); one add per extra branch of a Sum (and one
    multiply per branch of a Mixture)."""
    c, w, h = shape
    pairs, fields = b * b, b * b + 2 * b

    def walk(m, w, h):
        if isinstance(m, K.Conv2d):
            return _conv_ops(m, fields, w, h)
        if isinstance(m, K.ReLU):
            return RELU_OPS * pairs * w * h + 2 * b * w * h, w, h
        if isinstance(m, K.Sequential):
            ops = 0.0
            for child in m.mods:
                o, w, h = walk(child, w, h)
                ops += o
            return ops, w, h
        if isinstance(m, (K.Sum, K.Mixture)):
            outs = [walk(child, w, h) for child in m.mods]
            w2, h2 = outs[0][1:]
            extra = (len(outs) - 1) + (len(outs) if isinstance(m, K.Mixture)
                                       else 0)
            return (sum(o for o, _, _ in outs) + extra * fields * w2 * h2,
                    w2, h2)
        raise TypeError(f"no operation count for {type(m).__name__}")

    ops, _, _ = walk(model, w, h)
    return float(ops + 2 * c * (pairs + 2 * b) * w * h)


def measure(config_name: str, b: int, reps: int, samples: int,
            device) -> dict:
    config = configs.load(config_name)
    model = config.initial_model
    shape = configs.image_shape(config)
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(b * 4, *shape).astype(np.float32),
                        device=device)
    spec = megakernel.match(model)
    on_card = device.type == "cuda"

    def window():
        """Seconds per tile over ``reps`` tiles."""
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
        else:
            t0 = time.perf_counter()
        for k in range(reps):
            _tile_body(model, spec, x, x, b * (k % 4),
                       b * ((k * 7 + 1) % 4), b, True)
        if on_card:
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / 1e3 / reps
        return (time.perf_counter() - t0) / reps

    with torch.no_grad():
        for k in range(2):                   # warm-up
            _tile_body(model, spec, x, x, 0, b * k, b, True)
        per_tile = [window() for _ in range(samples)]
    med = float(np.median(per_tile))
    ops = tile_ops(model, b, shape)
    return {"tile": b, "entries_per_s": b * b / med,
            "ms_per_tile": med * 1e3, "ops_per_tile": ops,
            "tflops_per_s": ops / med / 1e12,
            "fp32_peak_share": ops / med / FP32_PEAK,
            "n_samples": len(per_tile)}


def run(a, device) -> list:
    settings.disable_tf32()
    rows = []
    for b in [int(t) for t in a.tiles.split(",")]:
        r = measure(a.config, b, a.reps, a.samples, device)
        print(json.dumps(r), flush=True)
        rows.append(r)
    best = max(rows, key=lambda r: r["entries_per_s"])
    print(json.dumps({"best": best}), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="cifar10", help="config to sweep")
    p.add_argument("--tiles", default="64,128,192,256,350",
                   help="comma list of tile sizes (350: the config's "
                        "kernel_batch_size)")
    p.add_argument("--reps", type=int, default=16,
                   help="tiles per timed window")
    p.add_argument("--samples", type=int, default=3,
                   help="timed windows per size (the median is reported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

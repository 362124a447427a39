"""The control of ``correct``: the plain reference put in the program's
place and computed one precision below the configuration's (float32 with
TF32 off, so TF32: every field an operation produces rounded to TF32's
10-bit mantissa, ``reference.nngp.round_tf32``), compared with the
float64 reference by the cell's own numbers at the cell's own sizes.  A
sound limit lies between the program's readings and these.  For a fit
cell it also reads the faults a training check must catch, planted in
the reference put in the program's place: half of the batch left out
with the loss and gradient scaled to the whole (``half_batch``), and the
loss altered by 1% where it is produced (``altered``); a step that
leaves the leaves unchanged reads 1 on ``change_gap`` by that number's
measure.  The benchmark's own runs never run this.

    python3 benchmark/control.py --workload convnet_gp.gram_card \\
        --seeds 11,12,13

prints one JSON line per seed with each number's reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness, recursions  # noqa: E402
from benchmark.drivers import fit as fit_driver  # noqa: E402
from benchmark.drivers import gram as gram_driver  # noqa: E402
from benchmark.reference import fit as ref_fit  # noqa: E402
from benchmark.reference import nngp  # noqa: E402

TF32 = {"dtype": torch.float32, "rounding": nngp.round_tf32}


def gram_readings(cell: dict, seed: int, device) -> dict:
    sizes, mix = cell["sizes"], cell["mix"]
    n, b = int(sizes["n"]), int(sizes["batch_size"])
    rec, tree = cell["cfg"]["recursion"], cell["cfg"]["tree"]
    shape = tuple(cell["cfg"]["image_shape"])
    x = gram_driver.images(seed, int(mix["image_sets"]), n, shape, device)
    pos = gram_driver.positions(n, b, sizes["sample_rows"],
                                sizes["sample_cols"], seed)
    errs = []
    for s in range(int(mix["image_sets"])):
        want = gram_driver.reference(rec, tree, x[s], pos)
        got = gram_driver.reference(rec, tree, x[s], pos, **TF32)
        errs.append(gram_driver.rel_err(got, want))
    return {"gram_rel_err": max(errs)}


def _numbers(got: dict, want: dict, rec, tree, m: int) -> dict:
    raw0 = ref_fit.initial_raw(rec, tree)
    moved = np.abs(want["grad0"]) >= 1e-3 * np.median(np.abs(want["grad0"]))
    return {"loss_gap": float(np.max(np.abs(got["losses"] - want["losses"])
                                     / np.abs(want["losses"]))),
            "grad_gap": fit_driver.gap(got["grad0"], want["grad0"]),
            "change_gap": fit_driver.gap(got["starts"][m] - raw0,
                                         want["starts"][m] - raw0, moved)}


def _half_batch(rec, tree, x, y, raw, jitter, b, rounding, dtype):
    h = len(x) // 2
    loss, g = ref_fit.value_and_grad(rec, tree, x[:h], y[:h], raw, jitter,
                                     b, rounding, dtype)
    return 2 * loss, 2 * g


def _altered(rec, tree, x, y, raw, jitter, b, rounding, dtype):
    loss, g = ref_fit.value_and_grad(rec, tree, x, y, raw, jitter, b,
                                     rounding, dtype)
    return loss * 1.01, g


def fit_readings(cell: dict, seed: int, device) -> dict:
    sizes, mix = cell["sizes"], cell["mix"]
    n, b = int(sizes["n"]), int(sizes["batch_size"])
    rec, tree = cell["cfg"]["recursion"], cell["cfg"]["tree"]
    recursions.require_fit(rec)
    shape = tuple(cell["cfg"]["image_shape"])
    m, jitter = int(mix["checked_steps"]), float(mix["jitter"])
    sets = int(mix["image_sets"])
    x = gram_driver.images(seed, sets, n, shape, device)[0]
    y = fit_driver.labels(seed, sets, n, int(mix["classes"]), device)[0]
    want = ref_fit.follow(rec, tree, x, y, m, jitter, b)
    out = {"control": _numbers(ref_fit.follow(rec, tree, x, y, m, jitter, b,
                                              **TF32), want, rec, tree, m)}
    for name, fn in (("half_batch", _half_batch), ("altered", _altered)):
        got = ref_fit.follow(rec, tree, x, y, m, jitter, b,
                             value_and_grad_fn=fn)
        out[name] = _numbers(got, want, rec, tree, m)
    return out


def readings(name: str, seed: int, device, overrides=None,
             spec=None) -> dict:
    cell = harness._apply(harness.load_cell(name, spec), overrides)
    if cell["mix"]["driver"] == "fit":
        return fit_readings(cell, seed, device)
    return {"control": gram_readings(cell, seed, device)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(a.workload, seed, torch.device("cuda"))
        print(json.dumps({"workload": a.workload, "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

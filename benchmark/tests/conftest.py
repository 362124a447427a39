"""Tests of the benchmark itself, on the CPU at small sizes:
``python -m pytest benchmark/tests -q`` from the checkout's root.  The
port runs its plain versions on CPU tensors, so a whole run of a cell
(set-up, window, check, result line) can be driven here; tests that need
the card carry the ``cuda`` marker and decide inside the test.

The tests find BENCHMARK.json's cells and configurations by name, each
at the size a test run holds in a file of its own:
``small/cells/<cell>.json`` (sizes that replace the cell's, with ragged
edge tiles) and ``small/configs/<config>.json`` (``n`` and
``batch_size`` of the reference's test against the port).  So a cell or
a configuration gets its CPU run, its fault runs and its reference test
by files."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2 ** 31 + 12345   # past 32 signed bits, as a run's seed may be


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The four-card cell, proved on the chip but kept out of BENCHMARK.json
# for its spread (PERF.md, Open questions): its entries, so that the
# tests still drive the ranks' path (a gloo world of four) and its
# per-layer metric.
X4 = "convnet_gp.gram_card_x4"
X4_WORKLOAD = {"name": X4, "config": "convnet_gp", "traffic": "gram_card_x4",
               "chips": 4, "why": "compute_gram_sharded Kxx on 4 ranks"}
X4_NCCL = {"name": "nccl_share.gram", "unit": "%", "better": "lower",
           "source": "device_trace", "layer": "rank group",
           "moves": "gram_entries_per_s", "workloads": [X4]}
X4_SMALL = {"n": 30, "batch_size": 8, "sample_rows": 6, "sample_cols": 5}


def spec_with_x4():
    """BENCHMARK.json with the four-card cell added as its entries were."""
    from benchmark import harness
    spec = harness.benchmark_spec()
    spec["workloads"].append(dict(X4_WORKLOAD))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m.get("moves", m["name"]) == "gram_entries_per_s" and \
                "workloads" in m:
            m["workloads"].append(X4)
    spec["per_layer"].append(dict(X4_NCCL))
    return spec


def _small(*parts):
    path = os.path.join(HERE, "small", *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: a test run's sizes, one file a "
                                f"cell or configuration")
    with open(path) as f:
        return json.load(f)


def small(cell: str) -> dict:
    """The cell's sizes for a test run."""
    return dict(X4_SMALL) if cell == X4 else _small("cells", f"{cell}.json")


def small_config(name: str) -> dict:
    """``n`` and ``batch_size`` of the configuration's reference test."""
    return _small("configs", f"{name}.json")


def cells(driver=None):
    """The cells of BENCHMARK.json and the four-card one, sorted; those
    whose traffic runs ``drivers/<driver>.py`` where it is given."""
    from benchmark import harness
    spec = spec_with_x4()
    names = sorted(w["name"] for w in spec["workloads"])
    return [c for c in names if driver is None
            or harness.load_cell(c, spec)["mix"]["driver"] == driver]


def configs():
    """The configurations of BENCHMARK.json, sorted."""
    from benchmark import harness
    return sorted(c["name"] for c in harness.benchmark_spec()["configs"])

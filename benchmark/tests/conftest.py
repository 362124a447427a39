"""Tests of the benchmark itself, on the CPU at small sizes:
``python -m pytest benchmark/tests -q`` from the checkout's root.  The
port runs its plain versions on CPU tensors, so a whole run of a cell
(set-up, window, check, result line) can be driven here; tests that need
the card carry the ``cuda`` marker and decide inside the test."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell at a size a test run holds: ragged edge tiles in each
SMALL = {
    "convnet_gp.gram_card": {"n": 20, "batch_size": 8, "sample_rows": 6,
                             "sample_cols": 5},
    "resnet32.gram_card": {"n": 11, "batch_size": 4, "sample_rows": 4,
                           "sample_cols": 3},
    "convnet_gp.fit_exact": {"n": 24, "batch_size": 8},
    "convnet_gp.gram_card_x4": {"n": 30, "batch_size": 8,
                                "sample_rows": 6, "sample_cols": 5},
}
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

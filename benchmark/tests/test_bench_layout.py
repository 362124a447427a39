"""The benchmark is driven by data: every name in BENCHMARK.json finds its
files, and a new cell, configuration or metric is added by adding files
only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT, SEED, SMALL

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_every_workload_finds_its_files():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"], SPEC)
        assert os.path.exists(os.path.join(
            harness.HERE, "drivers", f"{cell['mix']['driver']}.py"))
        assert cell["config"] in {c["name"] for c in SPEC["configs"]}
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")


def test_names_and_shapes():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in SPEC[section]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_per_layer_metrics_name_cells_that_report_what_they_move():
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
        moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moves.get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        e2e = harness.reported(SPEC, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.reported(SPEC, w["name"], "per_layer")


ADDED = {
    "config": {"name": "tiny_convnet", "source": "a test",
               "image_shape": [1, 28, 28], "port_config": None,
               "model": {"op": "seq", "layers": [
                   {"op": "conv", "kernel_size": 5, "stride": 1,
                    "padding": "same", "var_weight": 2.0, "var_bias": 0.5},
                   {"op": "relu"},
                   {"op": "conv", "kernel_size": 28, "stride": 1,
                    "padding": 0, "var_weight": 1.0, "var_bias": 0.1}]}},
    "cell": {"n": 9, "batch_size": 4, "sample_rows": 3, "sample_cols": 4,
             "limits": {"gram_rel_err": 1e-05}},
    "metric": '"""entries_per_call: a metric a later change might add."""\n'
              '\n\ndef read(ctx):\n'
              '    return ctx["units_per_call"] if ctx["kind"] == "gram" '
              'else None\n',
}

DRIVE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
spec = harness.benchmark_spec()
run = harness.run_world("tiny_convnet.gram_card", int(sys.argv[2]), 0.2,
                        False, device="cpu")
print(json.dumps(harness.result_line(spec, run, False, "cpu")))
print(json.dumps(harness.reported(spec, "tiny_convnet.gram_card",
                                  "per_layer")))
print(harness.__file__)
"""


def test_a_cell_config_and_metric_are_added_by_files(tmp_path):
    """A copy of the benchmark with one configuration, one cell and one
    per-layer metric added as files, and their entries added to
    BENCHMARK.json, runs the new cell and finds the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "benchmark").rglob("*") if q.is_file())}
    spec = json.loads(json.dumps(SPEC))
    b = root / "benchmark"
    (b / "configs" / "tiny_convnet.json").write_text(
        json.dumps(ADDED["config"]))
    (b / "workloads" / "tiny_convnet.gram_card.json").write_text(
        json.dumps(ADDED["cell"]))
    (b / "metrics" / "entries_per_call.py").write_text(ADDED["metric"])
    spec["configs"].append({"name": "tiny_convnet", "source": "a test",
                            "file": "benchmark/configs/tiny_convnet.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_convnet.gram_card",
                              "config": "tiny_convnet",
                              "traffic": "gram_card", "chips": 1,
                              "why": "a test"})
    e2e = next(m for m in spec["end_to_end"]
               if m["name"] == "gram_entries_per_s")
    e2e["workloads"].append("tiny_convnet.gram_card")
    spec["per_layer"].append({"name": "entries_per_call", "unit": "entries",
                              "better": "higher", "source": "host_clock",
                              "layer": "Gram call",
                              "moves": "gram_entries_per_s",
                              "workloads": ["tiny_convnet.gram_card"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", DRIVE, str(root), str(SEED)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line, per_layer, where = out.stdout.strip().splitlines()[-3:]
    assert where.startswith(str(root))
    line = json.loads(line)
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"gram_entries_per_s", "setup_s"}
    assert "entries_per_call" in {m["name"] for m in json.loads(per_layer)}
    for p, data in before.items():      # nothing already there changed
        assert open(p, "rb").read() == data

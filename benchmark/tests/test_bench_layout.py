"""The benchmark is driven by data: every name in BENCHMARK.json finds its
files, and a new cell, configuration, metric or covariance recursion is
added by adding files only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT, SEED

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


# A recursion a later configuration might bring: the diagonal one and an
# ``identity`` op that the diagonal parser rejects.  Each hook notes its
# call, so that a run shows where parse, build, reference and count
# came from.
RECURSION = '''"""diag_identity: the diagonal recursion and an identity op,
which builds an empty Sequential, leaves the reference's fields as they
are and counts no operation."""

import torch

from benchmark import arch
from benchmark.recursions import diagonal

CALLS = set()


class Identity:
    pass


def _parse(node):
    if node["op"] == "identity":
        return Identity()
    if node["op"] == "seq":
        return arch.Seq(tuple(_parse(n) for n in node["layers"]))
    if node["op"] == "sum":
        return arch.Sum(tuple(_parse(n) for n in node["branches"]))
    return arch.parse(node)


def _plain(tree):
    """The tree with each identity an empty seq."""
    if isinstance(tree, Identity):
        return arch.Seq(())
    if isinstance(tree, arch.Seq):
        return arch.Seq(tuple(_plain(t) for t in tree.layers))
    if isinstance(tree, arch.Sum):
        return arch.Sum(tuple(_plain(t) for t in tree.branches))
    return tree


def parse(node):
    CALLS.add("parse")
    return _parse(node)


def gram_work(tree, shape, n, b, peaks):
    CALLS.add("gram_work")
    return diagonal.gram_work(_plain(tree), shape, n, b, peaks)


def build_model(tree, learnable=False):
    CALLS.add("build_model")
    return diagonal.build_model(_plain(tree), learnable)


def entries(tree, images, rows, cols, dtype=torch.float64, rounding=None):
    CALLS.add("entries")
    return diagonal.entries(_plain(tree), images, rows, cols, dtype,
                            rounding)
'''

CONV = {"op": "conv", "kernel_size": 5, "stride": 1, "padding": "same",
        "var_weight": 2.0, "var_bias": 0.5}
READOUT = {"op": "conv", "kernel_size": 12, "stride": 1, "padding": 0,
           "var_weight": 1.0, "var_bias": 0.1}
IDENTITY_MODEL = {"op": "seq", "layers": [CONV, {"op": "relu"},
                                          {"op": "identity"}, READOUT]}
PLAIN_MODEL = {"op": "seq", "layers": [CONV, {"op": "relu"}, READOUT]}


def _config(name, recursion):
    return {"name": name, "source": "a test", "recursion": recursion,
            "image_shape": [2, 12, 12], "port_config": None,
            "model": IDENTITY_MODEL}


@pytest.fixture(scope="module")
def with_recursion(tmp_path_factory):
    """A checkout of the benchmark (the port linked in) with a recursion,
    a configuration that names it, one that names a recursion with no
    file, a Gram cell of the first and its test sizes, all added as files
    and BENCHMARK.json entries; and every file that was there before,
    with its bytes."""
    root = tmp_path_factory.mktemp("recursion") / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "cnn_gp_tpu_torch"),
               root / "cnn_gp_tpu_torch")
    before = {str(q): q.read_bytes()
              for q in (root / "benchmark").rglob("*") if q.is_file()}
    b = root / "benchmark"
    (b / "recursions" / "diag_identity.py").write_text(RECURSION)
    (b / "configs" / "tiny_identity.json").write_text(json.dumps(
        _config("tiny_identity", "diag_identity")))
    (b / "configs" / "tiny_unknown.json").write_text(json.dumps(
        _config("tiny_unknown", "no_such_recursion")))
    (b / "workloads" / "tiny_identity.gram_card.json").write_text(
        json.dumps({"n": 4096, "batch_size": 128, "sample_rows": 64,
                    "sample_cols": 64, "limits": {"gram_rel_err": 1e-05}}))
    (b / "tests" / "small" / "cells" / "tiny_identity.gram_card.json"
     ).write_text(json.dumps({"n": 20, "batch_size": 8, "sample_rows": 6,
                              "sample_cols": 5}))
    (b / "tests" / "small" / "configs" / "tiny_identity.json").write_text(
        json.dumps({"n": 10, "batch_size": 4}))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "tiny_identity", "source": "a test",
                            "file": "benchmark/configs/tiny_identity.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_identity.gram_card",
                              "config": "tiny_identity",
                              "traffic": "gram_card", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m.get("moves", m["name"]) == "gram_entries_per_s" and \
                "workloads" in m:
            m["workloads"].append("tiny_identity.gram_card")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


def _python(root, code, *args, timeout=300):
    return subprocess.run([sys.executable, "-c", code, str(root), *args],
                          capture_output=True, text=True, cwd=root,
                          timeout=timeout)


DRIVE_RECURSION = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import arch, harness, peaks
spec = harness.benchmark_spec()
small = {"n": 20, "batch_size": 8, "sample_rows": 6, "sample_cols": 5}
run = harness.run_world("tiny_identity.gram_card", int(sys.argv[2]), 0.2,
                        False, device="cpu", overrides=small, spec=spec)
line = harness.result_line(spec, run, False, "cpu")
rec = run["cell"]["cfg"]["recursion"]
cell = harness.load_cell("tiny_identity.gram_card", spec)
work = cell["cfg"]["recursion"].gram_work(
    cell["cfg"]["tree"], (2, 12, 12), 4096, 128, peaks)
plain = arch.gram_work(arch.parse(json.loads(sys.argv[3])), (2, 12, 12),
                       4096, 128, peaks)
try:
    arch.parse(json.loads(sys.argv[4]))
    rejected = None
except ValueError as e:
    rejected = str(e)
print(json.dumps({"correct": line["correct"], "attempted": line["attempted"],
                  "calls": sorted(rec.CALLS), "file": rec.__file__,
                  "work": [work.ops, work.bound_s, work.entries],
                  "plain": [plain.ops, plain.bound_s, plain.entries],
                  "rejected": rejected}))
"""


def test_a_recursion_is_added_by_files(with_recursion):
    """A configuration that names its own recursion, with a Gram cell and
    its test sizes, is added as files: the run takes parse, build,
    reference and count from the named module and is correct, the
    identity counts nothing, and the tests find the new cell's CPU run,
    fault runs, control and reference test.  No file that was there
    changes."""
    root, before = with_recursion
    out = _python(root, DRIVE_RECURSION, str(SEED),
                  json.dumps(PLAIN_MODEL), json.dumps(IDENTITY_MODEL))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True and got["attempted"] >= 1
    assert got["calls"] == ["build_model", "entries", "gram_work", "parse"]
    assert got["file"] == str(root / "benchmark" / "recursions" /
                              "diag_identity.py")
    assert got["work"] == got["plain"]
    assert "identity" in got["rejected"]
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "benchmark/tests", "-q",
         "-p", "no:cacheprovider", "-k", "tiny_identity"],
        capture_output=True, text=True, cwd=root, timeout=900)
    assert tests.returncode == 0, tests.stdout[-3000:]
    # three faults, the sound run, the control, the run's imports, the
    # per-layer readers, the reference against the port
    assert re.search(r"\b8 passed\b", tests.stdout), tests.stdout[-3000:]
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def test_an_unknown_recursion_names_its_file(with_recursion):
    root, _ = with_recursion
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from benchmark import arch; arch.load_config('tiny_unknown')")
    out = _python(root, code)
    assert out.returncode != 0
    assert "FileNotFoundError" in out.stderr
    assert os.path.join("recursions", "no_such_recursion.py") in out.stderr


DRIVE_FIT = """
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import control, harness
spec = harness.benchmark_spec()
spec["workloads"].append({"name": "tiny_identity.fit_exact",
                          "config": "tiny_identity", "traffic": "fit_exact",
                          "chips": 1, "why": "a test"})
small = {"n": 8, "batch_size": 4}
refused = {}
try:
    harness.run_world("tiny_identity.fit_exact", 1, 0.2, False,
                      device="cpu", overrides=small, spec=spec)
except ValueError as e:
    refused["run"] = str(e)
try:
    control.readings("tiny_identity.fit_exact", 1, "cpu", small, spec)
except ValueError as e:
    refused["control"] = str(e)
print(json.dumps(refused))
"""


def test_a_fit_cell_refuses_a_recursion_without_fit_hooks(with_recursion):
    """The fit driver and the control's fit path raise at set-up, naming
    the recursion, where it gives no fit hooks: they never fall back to
    the diagonal one."""
    root, _ = with_recursion
    (root / "benchmark" / "workloads" / "tiny_identity.fit_exact.json"
     ).write_text(json.dumps({"n": 2048, "batch_size": 256, "limits": {
         "loss_gap": 2e-05, "grad_gap": 5e-04, "change_gap": 2e-05}}))
    out = _python(root, DRIVE_FIT)
    assert out.returncode == 0, out.stderr[-3000:]
    refused = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(refused) == {"run", "control"}
    for message in refused.values():
        assert "'diag_identity'" in message and "fit hooks" in message

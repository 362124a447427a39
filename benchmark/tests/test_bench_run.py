"""A whole run of each cell on the CPU at a small size: what it loads,
its last line's keys, and the command's refusal without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT, SEED, cells, small, spec_with_x4

KEYS = ["correct", "attempted", "failed", "metrics", "device", "call_seconds",
        "checks"]

RUN = """
import json, sys
sys.path.insert(0, "benchmark/tests")
from benchmark import harness
from conftest import spec_with_x4
cell, seed = sys.argv[1], int(sys.argv[2])
small = json.loads(sys.argv[3])
spec = spec_with_x4()
run = harness.run_world(cell, seed, 0.2, False, device="cpu",
                        overrides=small, spec=spec)
line = harness.result_line(spec, run, False, "cpu")
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
print(json.dumps(harness.forbidden_loaded()))
print(json.dumps(line))
"""


@pytest.mark.parametrize("cell", cells())
def test_a_run_loads_nothing_forbidden(cell):
    """A subprocess runs the cell and lists the top-level names of every
    loaded module, compared whole: the port's name begins with the JAX
    package's and is not it."""
    out = subprocess.run(
        [sys.executable, "-c", RUN, cell, str(SEED),
         json.dumps(small(cell))], capture_output=True, text=True,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, found, line = out.stdout.strip().splitlines()[-3:]
    loaded = set(json.loads(loaded))
    assert "cnn_gp_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)
    assert json.loads(found) == []
    line = json.loads(line)
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cnn_gp_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.nngp, "
            "benchmark.reference.fit, benchmark.arch; "
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout))
    assert "cnn_gp_tpu_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "convnet_gp.gram_card", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def _made_up_steps():
    """Two fit steps' spans as the program records them: each
    ``fit.step`` holds a ``fit.gram``, a ``fit.host_f64`` and a
    ``fit.grad_vjp``."""
    from cnn_gp_tpu_torch.utils import timing
    out, t = [], 1_000_000_000
    for _ in range(2):
        step = timing.Span("fit.step", {})
        step.start_ns = t
        for name, ns in (("fit.gram", 40_000_000),
                         ("fit.host_f64", 6_000_000),
                         ("fit.grad_vjp", 280_000_000)):
            s = timing.Span(name, {})
            s.start_ns, s.end_ns, t = t, t + ns, t + ns
            out.append(s)
        step.end_ns = t + 1_000_000
        t = step.end_ns
        out.append(step)
    return out


@pytest.mark.parametrize("cell", cells())
def test_per_layer_readers_on_a_trace_summary(cell, monkeypatch):
    """Each reader on a made-up traced call (its trace summary, and the
    program's spans of its fit steps) returns a number in its cells' kind
    and nothing in the other."""
    from benchmark import peaks
    from cnn_gp_tpu_torch.utils import timing
    spans = _made_up_steps()
    monkeypatch.setattr(timing, "spans", lambda: list(spans))
    spec = spec_with_x4()
    c = harness.load_cell(cell, spec)
    kind = c["mix"]["driver"]
    tree, shape = c["cfg"]["tree"], tuple(c["cfg"]["image_shape"])
    work = c["cfg"]["recursion"].gram_work(tree, shape, 256, 128, peaks)
    traced = [{"wall_s": 0.01, "busy_s": 0.008, "kernels": 18,
               "nccl_s": 0.001}] * c["chips"]
    ctx = {"kind": kind, "chips": c["chips"], "calls": 3,
           "window_s": 0.05, "work_per_call": work,
           "units_per_call": 3, "tiles_per_call": 3, "traced": traced,
           "peaks": peaks}
    for m in harness.reported(spec, cell, "per_layer"):
        value = harness.reader(m["name"])(ctx)
        assert value is not None and value > 0, m["name"]
        other = dict(ctx, kind="fit" if kind == "gram" else "gram")
        assert harness.reader(m["name"])(other) is None

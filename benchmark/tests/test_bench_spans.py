"""The per-layer metrics read from the program's spans
(``host_f64_share.fit``, ``grad_vjp_share.fit``): nothing without a
traced call or without the spans, and a share of the steps on the spans
of a profiled fit on the CPU."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, program
from conftest import SEED

NAMES = ("host_f64_share.fit", "grad_vjp_share.fit")
TRACED = [{"wall_s": 1.0, "busy_s": 0.4, "kernels": 10, "nccl_s": 0.0}]


def _ctx(traced, kind="fit"):
    return {"kind": kind, "chips": 1, "calls": 1, "window_s": 1.0,
            "traced": traced}


@pytest.fixture
def fit_spans():
    """The spans of a profiled two-step exact fit of the ConvNet cell's
    model at 24 images, tile 8, on the CPU."""
    from benchmark.drivers import fit, gram
    from cnn_gp_tpu_torch.utils import timing
    cfg = harness.load_cell("convnet_gp.fit_exact")["cfg"]
    x = gram.images(SEED, 1, 24, tuple(cfg["image_shape"]), "cpu")[0]
    y = fit.labels(SEED, 1, 24, 10, "cpu")[0]
    model = program.build_model(cfg["tree"], learnable=True)
    timing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        program.entries()["fit_large"](model, x, y, steps=2, batch_size=8,
                                       jitter=1e-6, device=torch.device("cpu"))
    yield
    timing.clear()


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_trace_or_spans(name):
    from cnn_gp_tpu_torch.utils import timing
    timing.clear()
    read = harness.reader(name)
    assert read(_ctx([])) is None        # a --trace 0 run, or the CPU
    assert read(_ctx(TRACED)) is None    # traced, but no fit.step span


def test_nothing_from_a_program_without_spans(monkeypatch, fit_spans):
    """A program whose timing module has no spans (the parent's) gives
    nothing, and raises nothing."""
    from cnn_gp_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "spans")
    for name in NAMES:
        assert harness.reader(name)(_ctx(TRACED)) is None


def test_shares_of_a_profiled_fit(fit_spans):
    values = {n: harness.reader(n)(_ctx(TRACED)) for n in NAMES}
    assert all(0.0 < v < 100.0 for v in values.values()), values
    assert sum(values.values()) < 100.0
    for name in NAMES:
        assert harness.reader(name)(_ctx(TRACED, kind="gram")) is None


def test_reported_by_the_fit_cell_only():
    spec = harness.benchmark_spec()
    for cell in ("convnet_gp.gram_card", "resnet32.gram_card",
                 "convnet_gp.fit_exact"):
        names = {m["name"] for m in harness.reported(spec, cell,
                                                     "per_layer")}
        assert (set(NAMES) <= names) == (cell == "convnet_gp.fit_exact")
    np.testing.assert_equal(
        [m["layer"] for m in spec["per_layer"] if m["name"] in NAMES],
        ["fit step", "fit step"])

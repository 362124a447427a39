"""Port box filter (cnn_gp_tpu_torch.ops.boxfilter) against the JAX
package's on the same inputs: padding helpers exactly, box_filter_2d within
1e-5 of value scale."""

import numpy as np
import pytest
import torch

from cnn_gp_tpu.ops import boxfilter as jbox
from cnn_gp_tpu_torch.ops import boxfilter as tbox

CASES = [
    dict(k=3, stride=1, padding="same", dilation=1),
    dict(k=7, stride=1, padding="same", dilation=1),
    dict(k=4, stride=1, padding="same", dilation=1),   # even-k asym padding
    dict(k=2, stride=1, padding="same", dilation=2),   # even k, dilated
    dict(k=3, stride=2, padding="same", dilation=1),
    dict(k=4, stride=2, padding="same", dilation=1),
    dict(k=3, stride=1, padding=0, dilation=1),
    dict(k=5, stride=1, padding=2, dilation=2),
    dict(k=1, stride=2, padding=0, dilation=1),
    dict(k=3, stride=2, padding=(0, 2), dilation=1),   # explicit (lo, hi)
    dict(k=10, stride=1, padding=0, dilation=1),       # full-map readout
]


def check(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    assert np.abs(got - want).max() / scale < 1e-5


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["separable", "shifts"])
def test_box_filter_matches_jax(case, method):
    x = np.random.RandomState(0).randn(2, 3, 10, 10).astype(np.float32)
    args = (case["k"], case["stride"], case["padding"], case["dilation"])
    want = jbox.box_filter_2d(x, *args, method=method)
    check(tbox.box_filter_2d(torch.from_numpy(x), *args), want)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("dilation", [1, 2])
def test_padding_helpers_match_jax(k, dilation):
    assert tbox.same_padding(k, dilation) == jbox.same_padding(k, dilation)
    for padding in ("same", 0, 3, (1, 2)):
        pad = tbox.resolve_padding(padding, k, dilation)
        assert pad == jbox.resolve_padding(padding, k, dilation)
        for stride in (1, 2):
            assert (tbox.out_size(28, k, stride, pad, dilation)
                    == jbox.out_size(28, k, stride, pad, dilation))


def test_unknown_padding_refused():
    with pytest.raises(ValueError):
        tbox.resolve_padding("valid", 3)


def test_box_filter_avoids_conv2d(monkeypatch):
    """cuDNN would run F.conv2d in TF32; the box filter must not use it."""
    def boom(*a, **k):
        raise AssertionError("box_filter_2d called F.conv2d")

    monkeypatch.setattr(torch.nn.functional, "conv2d", boom)
    x = torch.ones(1, 6, 6)
    out = tbox.box_filter_2d(x, 3, 1, "same")
    assert out[0, 2, 2].item() == 9.0 and out[0, 0, 0].item() == 4.0

"""Port kernel DSL (cnn_gp_tpu_torch.kernels) against the JAX package on
the same inputs: the seven specs of tests/test_vs_reference.py, built for
both packages by its ``pair`` helper, on cross, same, diag and explicit
``diag_mask`` blocks, within 1e-5 of value scale."""

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu_torch import settings
from tests.test_vs_reference import SPECS, check, pair


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("spec", SPECS)
def test_cross_block(spec, rng):
    tm, jm = pair(T, spec)
    x = rng.randn(5, 3, 10, 10).astype(np.float32)
    y = rng.randn(7, 3, 10, 10).astype(np.float32)
    check(np.asarray(jm(x, y, same=False)), _np(tm(x, y, same=False)))


@pytest.mark.parametrize("spec", SPECS)
def test_same_block_and_exact_symmetry(spec, rng):
    tm, jm = pair(T, spec)
    x = rng.randn(6, 3, 10, 10).astype(np.float32)
    got = _np(tm(x))
    check(np.asarray(jm(x)), got)
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("spec", SPECS)
def test_explicit_diag_mask_block(spec, rng):
    """An off-diagonal Gram tile whose rows 2.. are columns 0.. of the
    same global examples (the tile sweep's global-index mask)."""
    tm, jm = pair(T, spec)
    x = rng.randn(6, 3, 10, 10).astype(np.float32)
    y = np.concatenate([x[2:], rng.randn(3, 3, 10, 10).astype(np.float32)])
    mask = (2 + np.arange(6))[:, None] == np.arange(7)[None, :]
    check(np.asarray(jm(x, y, same=False, diag_mask=mask)),
          _np(tm(x, y, same=False, diag_mask=mask)))


@pytest.mark.parametrize("spec", ["conv_relu", "resnet"])
def test_diag(spec, rng):
    tm, jm = pair(T, spec)
    x = rng.randn(6, 3, 10, 10).astype(np.float32)
    check(np.asarray(jm(x, diag=True)), _np(tm(x, diag=True)))


def test_cross_diag(rng):
    tm, jm = pair(T, "conv_relu")
    x = rng.randn(6, 3, 10, 10).astype(np.float32)
    y = rng.randn(6, 3, 10, 10).astype(np.float32)
    check(np.asarray(jm(x, y, same=False, diag=True)),
          _np(tm(x, y, same=False, diag=True)))


@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_mixture_and_relu_forms(relu_impl, rng):
    logits = np.array([0.3, -0.7], np.float32)

    def build(M):
        return M.Sequential(
            M.Mixture([M.Conv2d(3), M.Sequential(M.Conv2d(3), M.ReLU())],
                      logits),
            M.Conv2d(10, padding=0))

    x = rng.randn(4, 3, 10, 10).astype(np.float32)
    y = rng.randn(5, 3, 10, 10).astype(np.float32)
    with G.settings.override(relu_impl=relu_impl):
        want = np.asarray(build(G)(x, y, same=False))
    with settings.override(relu_impl=relu_impl):
        got = build(T)(x, y, same=False)
    assert isinstance(build(T).mods[0].logit, torch.nn.Parameter)
    check(want, _np(got))


def test_paper_model_full_width(rng):
    """The 7-layer paper ConvNet GP on 28x28 inputs."""
    from cnn_gp_tpu_torch.configs import load
    import configs
    tm = load("mnist_paper_convnet_gp").initial_model
    jm = configs.load("mnist_paper_convnet_gp").initial_model
    x = rng.rand(3, 1, 28, 28).astype(np.float32)
    y = rng.rand(4, 1, 28, 28).astype(np.float32)
    check(np.asarray(jm(x, y, same=False)), _np(tm(x, y, same=False)))


def test_layers_counts():
    m = T.Sequential(T.Conv2d(3), T.ReLU(),
                     T.resnet_block(stride=2, projection_shortcut=True,
                                    multiplier=2))
    assert m.layers() == 3
    assert T.ReLU().layers() == 0
    assert T.Conv2d(5).layers() == 1


def test_layers_are_modules_and_forward_is_propagate(rng):
    m = T.Sequential(T.Conv2d(3), T.ReLU(), T.Conv2d(10, padding=0))
    assert isinstance(m, torch.nn.Module)
    assert len(list(m.modules())) == 5      # Sequential, ModuleList, 3 layers
    x = torch.from_numpy(rng.randn(3, 2, 10, 10).astype(np.float32))
    kp = T.input_patch(x, x, True, False)
    out = m(kp)
    assert isinstance(out, T.KernelPatch) and out.spatial == (1, 1)
    np.testing.assert_array_equal(out.xy.reshape(3, 3).numpy(), _np(m(x)))


def test_kernel_fn_device_and_precision_guard(rng):
    m = T.Sequential(T.Conv2d(3), T.ReLU(), T.Conv2d(6, padding=0))
    x = rng.randn(2, 1, 6, 6).astype(np.float32)
    out = T.kernel_fn(m, x, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float32
    # TF32 under moment_precision="highest" is refused
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            settings.check_precision()
        settings.disable_tf32()
        settings.check_precision()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def test_conv_padding_refused():
    with pytest.raises(TypeError):
        T.Conv2d(3, padding=(1, 2))

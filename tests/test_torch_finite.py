"""The port's finite-width mirror (cnn_gp_tpu_torch.finite) against the
JAX package's (cnn_gp_tpu.finite), on the CPU: the weight distribution,
the even-kernel trick, channel threading, the residual identity, apply
parity on parameters carried across from JAX, S stacked networks against
single ones, and Monte-Carlo convergence to the analytic kernel.

JAX's random streams and torch's differ, so sampling is held to the
kernel statistically and apply parity is tested on JAX's own draws."""

import math

import jax
import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import configs as jconfigs
from cnn_gp_tpu.finite import FiniteNet as JFiniteNet
from cnn_gp_tpu_torch import (Conv2d, FiniteNet, ReLU, Sequential, Sum,
                              configs, sample_nn_outputs)
from cnn_gp_tpu_torch.convert import finite_params_from_jax, from_jax_model
from cnn_gp_tpu_torch.finite import DRAW_BLOCK, _Conv, conv_ops

CPU = torch.device("cpu")
TOL = 1e-5          # max |delta| / max |y|, the repo's parity rule


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as tests/test_torch_fit.py: several test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed=0):
    return torch.Generator(CPU).manual_seed(seed)


def convs(net):
    return [m for m in net.root.modules() if isinstance(m, _Conv)]


def test_conv_weight_distribution():
    """std = sqrt(var_weight / in_total) / kernel_size; the bias std is
    sqrt(var_bias); both by moments over many draws."""
    net = FiniteNet(Conv2d(5, var_weight=3.0, var_bias=2.0), channels=64,
                    in_channels=32, out_channels=16).init(gen(), n_nets=64)
    (conv,) = convs(net)
    w, b = conv.w.numpy(), conv.b.numpy()
    assert w.shape == (64, 16, 32, 5, 5) and b.shape == (64, 16)
    assert abs(w.std() / (math.sqrt(3.0 / 32) / 5) - 1) < 0.01
    assert abs(w.mean()) < 0.01 * w.std()
    assert abs(b.std() / math.sqrt(2.0) - 1) < 0.06


def test_weight_std_per_layer_of_a_sequential():
    """Each layer's std follows its own in_total and kernel size; no bias
    is drawn where var_bias is 0."""
    m = Sequential(Conv2d(3, var_weight=2.0), ReLU(),
                   Conv2d(5, var_weight=0.5, var_bias=0.25), ReLU(),
                   Conv2d(8, padding=0, var_weight=1.5,
                          in_channel_multiplier=2))
    net = FiniteNet(m, channels=24, in_channels=3,
                    out_channels=2).init(gen(1), n_nets=32)
    c = convs(net)
    assert [x.w.shape[1:3] for x in c] == [(24, 3), (24, 24), (2, 48)]
    assert c[0].b is None and c[2].b is None and c[1].b.shape == (32, 24)
    for conv, (vw, in_total, k) in zip(c, [(2.0, 3, 3), (0.5, 24, 5),
                                           (1.5, 48, 8)]):
        want = math.sqrt(vw / in_total) / k
        assert abs(conv.w.std().item() / want - 1) < 0.03


def test_even_trick_zero_row_col():
    net = FiniteNet(Conv2d(4), channels=8, in_channels=4,
                    out_channels=4).init(gen(2), n_nets=3)
    (conv,) = convs(net)
    w = conv.w.numpy()
    assert w.shape[-2:] == (5, 5) and conv.padding == 2
    assert (w[..., 0, :] == 0).all() and (w[..., :, 0] == 0).all()
    assert (w[..., 1:, 1:] != 0).all()


def test_channel_multipliers():
    net = FiniteNet(Conv2d(3, in_channel_multiplier=2,
                           out_channel_multiplier=4), channels=8)
    (conv,) = convs(net.init(gen(), n_nets=2))
    assert conv.w.shape[:3] == (2, 32, 16)


def test_sequential_channel_threading_and_empty_sequential():
    m = Sequential(Conv2d(3), ReLU(), Conv2d(3), ReLU(),
                   Conv2d(8, padding=0))
    net = FiniteNet(m, channels=16, in_channels=3,
                    out_channels=1).init(gen(), n_nets=2)
    x = np.random.RandomState(0).randn(5, 3, 8, 8).astype(np.float32)
    assert net(x).shape == (2, 5, 1, 1, 1)
    c = convs(net)
    assert c[0].w.shape[1:3] == (16, 3) and c[-1].w.shape[1:3] == (1, 16)
    ident = FiniteNet(Sequential(), channels=4).init(gen(), n_nets=3)
    got = ident(x)
    assert got.shape == (3, 5, 3, 8, 8)
    assert all(torch.equal(got[s], torch.as_tensor(x)) for s in range(3))


def _ref_conv(conv, s, x):
    """Network s's conv by plain F.conv2d on its own weights."""
    y = torch.nn.functional.conv2d(x, conv.w[s], stride=conv.stride,
                                   padding=conv.padding,
                                   dilation=conv.dilation)
    return y if conv.b is None else y + conv.b[s][None, :, None, None]


@pytest.mark.parametrize("in_channels", [None, 1])
def test_sum_residual_identity(in_channels):
    """Sum([identity, conv -> relu]): with in_channels None the identity
    and the conv branch have `channels` channels; with in_channels 1 the
    identity's one channel broadcasts across the branch's, as JAX's sum
    does.  Each of the S networks gets the shared input."""
    m = Sum([Sequential(), Sequential(Conv2d(3, var_bias=0.5), ReLU())])
    ch = 4
    c_in = ch if in_channels is None else 1
    net = FiniteNet(m, channels=ch, in_channels=in_channels).init(gen(3), 3)
    x = torch.as_tensor(np.random.RandomState(0).randn(
        2, c_in, 6, 6).astype(np.float32))
    got = net(x)
    (conv,) = convs(net)
    assert got.shape == (3, 2, ch, 6, 6)
    for s in range(3):
        want = x + torch.relu(_ref_conv(conv, s, x))
        torch.testing.assert_close(got[s], want, rtol=1e-5, atol=1e-6)


def test_resnet32_mirror_shapes_and_values():
    """model.nn() threads the channel multipliers through all 15 blocks of
    mnist_as_tf (its readout has in_channel_multiplier=4); the outputs are
    finite and not all equal."""
    model = configs.load("mnist_as_tf").initial_model
    net = model.nn(4, in_channels=1, out_channels=10).init(gen(), n_nets=2)
    mults = [(c.w.shape[2], c.w.shape[1]) for c in convs(net)]
    assert mults[0] == (1, 4) and mults[-1] == (16, 10)
    assert {m for m in mults[1:-1]} == {(4, 4), (4, 8), (8, 8), (8, 16),
                                        (16, 16)}
    x = np.random.RandomState(0).rand(2, 1, 28, 28).astype(np.float32)
    y = net(x)
    assert y.shape == (2, 2, 10, 1, 1) and torch.isfinite(y).all()
    assert y.std() > 0


def _parity_cases():
    """(JAX model, in_channels, out_channels, channels, input shape)."""
    conv8 = G.Sequential(G.Conv2d(4, var_bias=0.5), G.ReLU(),
                         G.Conv2d(3, stride=2), G.ReLU(),
                         G.Conv2d(4, padding=0))
    mixture = G.Sequential(
        G.Conv2d(3, var_weight=1.5),
        G.Mixture([G.Sequential(G.ReLU(), G.Conv2d(3, var_bias=0.2)),
                   G.Sequential(G.ReLU(), G.Conv2d(5)), G.Sequential()],
                  logit_proportions=np.float32([0.3, -0.2, 0.5])),
        G.ReLU(), G.Conv2d(8, padding=0, var_bias=0.1))
    return {
        "convnet_8x8": (conv8, 3, 2, 6, (3, 3, 8, 8)),
        "residual_even_kernel_28x28": (
            jconfigs.load("mnist_paper_residual_cnn_gp").initial_model, 1, 1,
            4, (2, 1, 28, 28)),
        "mixture": (mixture, 2, 3, 5, (3, 2, 8, 8)),
        "mnist_as_tf": (jconfigs.load("mnist_as_tf").initial_model, 1, 10,
                        4, (2, 1, 28, 28)),
        "cifar10": (jconfigs.load("cifar10").initial_model, 3, 10, 4,
                    (2, 3, 32, 32)),
    }


@pytest.mark.parametrize("case", sorted(_parity_cases()))
def test_apply_parity_with_jax(case):
    """JAX's FiniteNet.init parameters carried across by
    finite_params_from_jax give JAX's apply within 1e-5 of max|y|, one
    draw as S = 1 and three draws stacked as S = 3."""
    jm, cin, cout, ch, shape = _parity_cases()[case]
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    jnet = JFiniteNet(jm, ch, cin, cout)
    draws = [jnet.init(jax.random.key(k)) for k in range(3)]
    wants = [np.asarray(jnet.apply(p, x)) for p in draws]
    net = FiniteNet(from_jax_model(jm), ch, cin, cout)
    got = finite_params_from_jax(net, draws[0])(x).numpy()
    assert got.shape == (1,) + wants[0].shape
    scale = np.abs(wants[0]).max()
    assert np.abs(got[0] - wants[0]).max() <= TOL * scale
    got3 = finite_params_from_jax(net, draws)(x).numpy()
    for s in range(3):
        scale = np.abs(wants[s]).max()
        assert np.abs(got3[s] - wants[s]).max() <= TOL * scale, s


def test_finite_params_shape_mismatch_refused():
    jnet = JFiniteNet(G.Sequential(G.Conv2d(3), G.Conv2d(3)), 4, 2, 1)
    net = FiniteNet(Sequential(Conv2d(3), Conv2d(3)), 5, 2, 1)
    with pytest.raises(ValueError, match="weight shape"):
        finite_params_from_jax(net, jnet.init(jax.random.key(0)))


@pytest.mark.parametrize("config", ["mnist_paper_convnet_gp",
                                    "mnist_paper_residual_cnn_gp"])
def test_stacked_draws_equal_single_forwards(config):
    """One grouped forward of S networks equals the S networks run one at
    a time (select(i): S = 1), within 1e-5 of max|y|."""
    model = configs.load(config).initial_model
    net = model.nn(5, in_channels=1, out_channels=1).init(gen(4), n_nets=4)
    x = np.random.RandomState(2).rand(3, 1, 28, 28).astype(np.float32)
    ys = net(x)
    for s in range(4):
        one = net.select(s)(x)
        assert one.shape == (1, 3, 1, 1, 1)
        scale = one.abs().max().item()
        assert (ys[s] - one[0]).abs().max().item() <= TOL * scale


def test_sample_nn_outputs_chunks_follow_the_generator():
    """sample_nn_outputs draws whole blocks of DRAW_BLOCK networks from the
    generator, so its outputs follow the seed alone: init(g, 24) draws the
    parameters of init(g, 8) three times, bit for bit, and chunks of 8,
    16 (a requested 20 rounds down), 64 (None on the CPU) and 1 (one
    block at least) give the same outputs of channel 0 at pixel (0, 0)
    within 1e-5 of max|y|, equal to networks drawn by hand."""
    assert DRAW_BLOCK == 8
    m = Sequential(Conv2d(3, var_bias=0.3), ReLU(), Conv2d(4, padding=0))
    whole = FiniteNet(m, 7, 2, 1).init(gen(5), 24)
    g = gen(5)
    parts = [FiniteNet(m, 7, 2, 1).init(g, 8) for _ in range(3)]
    for i, conv in enumerate(convs(whole)):
        assert torch.equal(conv.w, torch.cat([convs(p)[i].w for p in parts]))
        if conv.b is not None:
            assert torch.equal(conv.b,
                               torch.cat([convs(p)[i].b for p in parts]))
    x = np.random.RandomState(3).randn(4, 2, 6, 6).astype(np.float32)
    g, net = gen(5), FiniteNet(m, 7, 2, 1)
    want = torch.cat([net.init(g, s)(x)[:, :, 0, 0, 0] for s in (16, 16, 6)])
    scale = want.abs().max().item()
    for sample_batch in (8, 20, None, 1):
        info = {}
        got = sample_nn_outputs(m, x, n_samples=38, channels=7,
                                in_channels=2, sample_batch=sample_batch,
                                generator=gen(5), device=CPU, info=info)
        assert got.shape == (38, 4)
        assert (got - want).abs().max().item() <= TOL * scale
        assert info["sample_batch"] == {8: 8, 20: 16, None: 64, 1: 8}[
            sample_batch]
        assert info["seconds"] >= 0 and "bytes_per_net" not in info


def test_mc_convergence_to_kernel():
    """Wide finite nets' empirical covariance approaches the analytic
    kernel (tests/test_finite.py:90-107 on the port): width 96, 4,000
    draws, error below 0.12 of max|K|."""
    model = Sequential(Conv2d(3, var_weight=2.0), ReLU(),
                       Conv2d(8, padding=0, var_weight=1.5, var_bias=0.1))
    x = np.random.RandomState(0).randn(6, 2, 8, 8).astype(np.float32)
    true_cov = model(x).numpy().astype(np.float64)
    r = sample_nn_outputs(model, x, n_samples=4000, channels=96,
                          in_channels=2, sample_batch=200,
                          generator=gen(0), device=CPU).numpy()
    est = r.T.astype(np.float64) @ r / len(r)
    err = np.abs(est - true_cov).max() / np.abs(true_cov).max()
    assert err < 0.12, err


def test_refusals():
    with pytest.raises(TypeError, match="no finite-width mirror"):
        FiniteNet(Sequential(Conv2d(3), torch.nn.Tanh()), 4, 1, 1)
    net = Conv2d(3).nn(4, 1, 1)
    assert isinstance(net, FiniteNet) and net.n_nets == 0
    with pytest.raises(RuntimeError, match="call init"):
        net(np.zeros((1, 1, 4, 4), np.float32))
    with pytest.raises(IndexError):
        net.init(gen(), 2).select(2)


def test_conv_ops_hand_count():
    """finite.conv_ops (the FP32 rate's numerator on the card): 2 C_out
    C_in k^2 per output pixel, the even trick's 5x5 as it runs."""
    m = Sequential(Conv2d(4), ReLU(), Conv2d(3, stride=2),
                   Conv2d(4, padding=0))
    want = (2 * 6 * 2 * 25 * 8 * 8 + 2 * 6 * 6 * 9 * 4 * 4
            + 2 * 1 * 6 * 16 * 1)
    assert conv_ops(m, 6, (2, 8, 8)) == want

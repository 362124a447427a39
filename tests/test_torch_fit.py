"""The port's type-II ML (cnn_gp_tpu_torch.fit) against the JAX package's
(cnn_gp_tpu/fit.py) on the same numpy inputs, on the CPU: the grad-safe
ReLU, learnable leaves on the megakernel, the whole-matrix and the exact
tiled NMLL, the fit loops, the leaf files and the fit scripts.  The
probed path is in tests/test_torch_fit_probed.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu import settings as jsettings
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu_torch import fit as tfit
from cnn_gp_tpu_torch import settings
from cnn_gp_tpu_torch.convert import from_jax_model, leaf_items
from cnn_gp_tpu_torch.data import digits, hard_mnist
from cnn_gp_tpu_torch.ops import megakernel
from scripts.fit_hyperparams import draw_gp_targets
from scripts.fit_hyperparams import make_model as jax_conv_model

jfit = importlib.import_module("cnn_gp_tpu.fit")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small autograd ops: more
    only adds OpenMP barriers, which stall for long when several test
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mixture_model():
    """The mixture of tests/test_fit.py: an informative ConvNet branch and
    a near-degenerate 1x1-readout branch."""
    good = G.Sequential(G.Conv2d(5, var_weight=2.0), G.ReLU(),
                        G.Conv2d(14, padding=0))
    weak = G.Sequential(G.Conv2d(14, padding=0, var_weight=1e-3,
                                 var_bias=1.0))
    return G.Mixture([good, weak])


MODELS = {"conv": lambda: jax_conv_model(2.0, 1.0, learnable=True),
          "mixture": jax_mixture_model}


def jax_grads(tree):
    """A JAX gradient pytree as the port's dict, keyed by pytree path."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_grads_close(got, want, rel):
    """Per leaf: |got - want| < rel * max(|want|, 1e-3), elementwise
    against the leaf's largest entry (tests/test_fit.py:156-161)."""
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        bound = rel * max(float(np.abs(w).max()), 1e-3)
        assert np.abs(g - w).max() < bound, (k, g, w)


def onehot_problem(n, seed):
    x, labels, _, _ = synthetic_arrays(n_train=n, n_test=0,
                                       shape=(1, 14, 14), seed=seed)
    return x, jsolve.one_hot_targets(labels, dtype=np.float32)


def gp_problem(n, seed, n_functions=8):
    """Targets drawn from the (3.0, 1.5) truth's GP, as the JAX tests."""
    x, _, _, _ = synthetic_arrays(n_train=n, n_test=0, shape=(1, 14, 14),
                                  seed=seed)
    return x, draw_gp_targets(jax_conv_model(3.0, 1.5), x, n_functions, 0)


# -- the grad-safe ReLU ------------------------------------------------------

@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
def test_grad_safe_primal_bit_equal(relu_impl):
    """settings.grad_safe changes gradients only, never a primal bit (and
    the port's Gram stays JAX's within 1e-5)."""
    x, _ = onehot_problem(12, 0)
    model = from_jax_model(jax_conv_model(2.0, 1.0))
    with settings.override(relu_impl=relu_impl):
        base = model(x).numpy()
        with settings.override(grad_safe=True):
            safe = model(x).numpy()
    np.testing.assert_array_equal(base.view(np.uint32),
                                  safe.view(np.uint32))
    want = np.asarray(jax_conv_model(2.0, 1.0)(x))
    assert np.abs(base - want).max() < 1e-5 * np.abs(want).max()


def _masked_tile_loss(model, x, ct):
    """<ct, K> of a ragged tile whose rows 3..7 are its columns 0..4."""
    rows, cols = 3 + torch.arange(6), torch.arange(9)
    mask = rows[:, None] == cols[None, :]
    xt = torch.from_numpy(x)
    k = T.apply_kernel(model, xt[3:9], xt[:9], False, False, mask)
    return (k * torch.from_numpy(ct)).sum()


def test_masked_tile_gradients_finite_and_match_jax():
    """Leaf gradients through a masked tile: NaN without grad_safe (0 *
    inf in the backward pass), finite with it, and JAX's VJP of the same
    tile within 3e-3."""
    x, _ = onehot_problem(12, 1)
    ct = np.random.RandomState(0).randn(6, 9).astype(np.float32)
    model = from_jax_model(jax_conv_model(1.0, 0.5, learnable=True))
    params = [p for _, p in leaf_items(model)]
    bad = torch.autograd.grad(_masked_tile_loss(model, x, ct), params)
    assert not all(np.isfinite(float(g)) for g in bad)
    with settings.override(grad_safe=True):
        good = torch.autograd.grad(_masked_tile_loss(model, x, ct), params)
    got = {k: g.numpy() for (k, _), g in zip(leaf_items(model), good)}
    assert all(np.isfinite(g) and g != 0 for g in got.values())

    from cnn_gp_tpu.kernels import apply_kernel as japply
    rows, cols = 3 + np.arange(6), np.arange(9)
    mask = jnp.asarray(rows[:, None] == cols[None, :])

    def tile_loss(m):
        return jnp.sum(jnp.asarray(ct) * japply(
            m, jnp.asarray(x[3:9]), jnp.asarray(x[:9]), False, False, mask))
    with jsettings.override(grad_safe=True):
        want = jax_grads(jax.grad(tile_loss)(jax_conv_model(
            1.0, 0.5, learnable=True)))
    assert_grads_close(got, want, 3e-3)


def test_learnable_model_tiles_equal_static_bits():
    """megakernel.match reads learnable leaves: a learnable paper ConvNet
    and the static one of the same values give the same tile bits (the
    hyperparameters enter the kernels as float32 either way), and the
    learnable model's tile equals its own apply_kernel within 1e-5."""
    from cnn_gp_tpu_torch.scripts.fit_paper_scale import paper_convnet
    x = hard_mnist(10, 1)[0]
    xt = torch.from_numpy(x)
    mask = torch.arange(4)[:, None] == torch.arange(10)[None, :]
    spec_l = megakernel.match(paper_convnet(2.79, 7.86, learnable=True))
    spec_s = megakernel.match(paper_convnet(2.79, 7.86))
    assert spec_l is not None and spec_s is not None
    assert spec_l.layer_scales() == spec_s.layer_scales()
    got = megakernel.gram_tile(spec_l, xt[:4], xt, mask)
    want = megakernel.gram_tile(spec_s, xt[:4], xt, mask)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    with torch.no_grad():
        plain = T.apply_kernel(paper_convnet(2.79, 7.86, learnable=True),
                               xt[:4], xt, False, False, mask).numpy()
    assert np.abs(got.numpy() - plain).max() < 1e-5 * np.abs(plain).max()


# -- the whole-matrix and tiled NMLL ------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_whole_matrix_nmll_matches_jax(name):
    x, y = onehot_problem(32, 4)
    jm = MODELS[name]()
    want_v, want_g = jax.value_and_grad(
        lambda m: jfit.neg_marginal_log_likelihood(
            m, jnp.asarray(x), jnp.asarray(y)))(jm)
    tm = from_jax_model(jm)
    loss = tfit.neg_marginal_log_likelihood(tm, x, y, device=CPU)
    grads = torch.autograd.grad(loss, [p for _, p in leaf_items(tm)])
    got = {k: g.numpy() for (k, _), g in zip(leaf_items(tm), grads)}
    want_v = float(want_v)
    assert abs(float(loss.detach()) - want_v) < 1e-4 * abs(want_v)
    assert_grads_close(got, jax_grads(want_g), 3e-3)


@pytest.mark.parametrize("name,n,b", [("conv", 37, 16), ("mixture", 37, 16),
                                      ("mixture", 24, 8)])
def test_tiled_nmll_matches_jax(name, n, b):
    """Ragged tiles (N = 37, b = 16) are sliced in the port and padded
    cyclically in JAX; the value within 1e-4, the gradient per leaf within
    3e-3, and both within the same of the port's whole-matrix NMLL."""
    x, y = onehot_problem(n, 5 if n == 37 else 6)
    jm = MODELS[name]()
    want_v, want_g = jfit.nmll_value_and_grad_tiled(jm, x, y, batch_size=b,
                                                    tiles_per_call=3)
    tm = from_jax_model(jm)
    phases = {}
    got_v, got_g = tfit.nmll_value_and_grad_tiled(tm, x, y, batch_size=b,
                                                  device=CPU, phases=phases)
    assert set(phases) == {"gram", "host_f64", "grad_vjp"}
    assert abs(got_v - want_v) < 1e-4 * abs(want_v)
    assert_grads_close(got_g, jax_grads(want_g), 3e-3)
    loss = tfit.neg_marginal_log_likelihood(tm, x, y, device=CPU)
    grads = torch.autograd.grad(loss, [p for _, p in leaf_items(tm)])
    whole = {k: g.numpy() for (k, _), g in zip(leaf_items(tm), grads)}
    assert abs(got_v - float(loss.detach())) < 1e-4 * abs(got_v)
    assert_grads_close(got_g, whole, 3e-3)


# -- the fit loops ------------------------------------------------------------

def test_fit_trajectory_matches_jax():
    """Three Adam steps of the whole-matrix fit (log-space leaves): the
    loss per step within 1e-3 of JAX's, the fitted leaves within 1e-3, and
    the input model untouched."""
    x, y = gp_problem(32, 3)
    jm = jax_conv_model(1.0, 0.5, learnable=True)
    want_m, want = jfit.fit(jm, x, y, steps=3, learning_rate=0.1)
    tm = from_jax_model(jm)
    before = {k: p.detach().clone() for k, p in leaf_items(tm)}
    got_m, got = tfit.fit(tm, x, y, steps=3, learning_rate=0.1, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    for k, p in leaf_items(tm):
        assert torch.equal(p.detach(), before[k])
    got_leaves = {k: p.detach().numpy() for k, p in leaf_items(got_m)}
    assert_grads_close(got_leaves, jax_grads(want_m), 1e-3)


def test_fit_large_exact_trajectory_matches_jax():
    x, y = gp_problem(40, 3)
    jm = jax_conv_model(1.0, 0.5, learnable=True)
    want_m, want = jfit.fit_large(jm, x, y, steps=3, batch_size=16)
    got_m, got = tfit.fit_large(from_jax_model(jm), x, y, steps=3,
                                batch_size=16, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    got_leaves = {k: p.detach().numpy() for k, p in leaf_items(got_m)}
    assert_grads_close(got_leaves, jax_grads(want_m), 1e-3)


def test_fit_positive_leaves_survive_big_steps():
    """Log-space variances: an aggressive rate on a small var_bias must
    not cross zero and collapse the fit to NaN (tests/test_fit.py:121)."""
    x, _ = onehot_problem(24, 4)
    y = np.random.RandomState(1).randn(24, 4).astype(np.float32)
    model = from_jax_model(jax_conv_model(0.8, 0.05, learnable=True))
    fitted, losses = tfit.fit(model, x, y, steps=12, learning_rate=0.3,
                              device=CPU)
    assert np.isfinite(losses).all(), losses
    assert float(fitted.mods[0].var_weight.detach()) > 0
    assert float(fitted.mods[0].var_bias.detach()) > 0


def _rejections(losses, tol=1e-3):
    best, r = np.inf, 0
    for lo in losses:
        if lo < best:
            best = lo
        if not np.isfinite(lo) or lo > best + tol * abs(best):
            r += 1
    return r


def test_fit_large_backtracks_on_overshoot(capsys):
    """At a huge rate the guard rejects diverging steps, shrinks the rate
    and still ends below the initial NMLL; the returned model is the best
    iterate (tests/test_fit.py:333-359)."""
    x, y = gp_problem(48, 3)
    model = from_jax_model(jax_conv_model(1.0, 0.5, learnable=True))
    fitted, losses = tfit.fit_large(model, x, y, steps=14, learning_rate=2.0,
                                    batch_size=16, verbose=True, device=CPU)
    assert _rejections(losses) >= 1, losses
    assert "REJECTED" in capsys.readouterr().out
    assert np.min(losses) < losses[0], losses
    final = float(tfit.neg_marginal_log_likelihood(fitted, x, y, 1e-6,
                                                   device=CPU).detach())
    assert final <= np.min(losses) + 1e-3 * abs(np.min(losses))
    _, losses_off = tfit.fit_large(model, x, y, steps=6, learning_rate=2.0,
                                   batch_size=16, backtrack=False,
                                   device=CPU)
    assert len(losses_off) == 6


def test_fit_large_default_lr_resolution(monkeypatch):
    """learning_rate=None: 0.1 for exact and 0.05 for probed gradients."""
    x, y = gp_problem(32, 1, n_functions=4)
    model = from_jax_model(jax_conv_model(1.0, 0.5, learnable=True))
    rates = []
    real_adam = tfit._adam
    monkeypatch.setattr(tfit, "_adam",
                        lambda raw, lr: rates.append(lr) or real_adam(raw, lr))
    for grad in ("exact", "probed"):
        _, losses = tfit.fit_large(model, x, y, steps=2, batch_size=16,
                                   grad=grad, probes=4, device=CPU)
        assert len(losses) == 2 and np.isfinite(losses).all()
    assert rates == [0.1, 0.05]
    with pytest.raises(ValueError, match="grad"):
        tfit.fit_large(model, x, y, steps=1, grad="sampled", device=CPU)


def test_fit_refuses_a_model_without_leaves():
    x, y = onehot_problem(8, 0)
    with pytest.raises(ValueError, match="learnable"):
        tfit.fit(from_jax_model(jax_conv_model(1.0, 0.5)), x, y, steps=1,
                 device=CPU)


# -- leaf files, the data generator, the scripts -----------------------------

def test_fitted_leaves_cross_packages(tmp_path):
    """Leaves the port fitted and saved load in JAX fit.load_leaves with
    the same kernel, and JAX's saved leaves load in the port."""
    x, y = gp_problem(24, 3)
    fitted, _ = tfit.fit(from_jax_model(jax_conv_model(1.0, 0.5,
                                                       learnable=True)),
                         x, y, steps=2, device=CPU)
    path = str(tmp_path / "port.npz")
    tfit.save_leaves(fitted, path)
    loaded = jfit.load_leaves(jax_conv_model(7.0, 7.0, learnable=True), path)
    want = fitted(x).numpy()
    got = np.asarray(loaded(x))
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    jpath = str(tmp_path / "jax.npz")
    jfit.save_leaves(jax_conv_model(2.7, 1.3, learnable=True), jpath)
    back = tfit.load_leaves(from_jax_model(jax_conv_model(
        1.0, 1.0, learnable=True)), jpath)
    assert float(back.mods[0].var_weight.detach()) == np.float32(2.7)
    assert float(back.mods[0].var_bias.detach()) == np.float32(1.3)


def test_hard_mnist_bit_equal_to_jax_scripts():
    from scripts.fit_paper_scale import hard_mnist as jhard
    from scripts.make_fake_dataset import _digits
    for got, want in zip(hard_mnist(40, 24), jhard(40, 24)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(hard_mnist(16, 8, flip_frac=0.0),
                         jhard(16, 8, flip_frac=0.0)):
        np.testing.assert_array_equal(got, want)
    for seed, proto, hard in ((3, None, False), (7, 1, True)):
        for got, want in zip(digits(20, 14, seed, proto, hard),
                             _digits(20, 14, seed, proto, hard)):
            np.testing.assert_array_equal(got, want)


def test_fit_hyperparams_script_matches_jax_helpers():
    """The demo script on the CPU at a small size: its targets are the
    JAX script's draws, and two steps lower the NMLL."""
    from cnn_gp_tpu_torch.scripts import fit_hyperparams as script
    x, _, _, _ = synthetic_arrays(n_train=16, n_test=0, shape=(1, 14, 14),
                                  seed=3)
    got = script.draw_gp_targets(script.make_model(3.0, 1.5), x, 4, 3,
                                 device=CPU)
    want = draw_gp_targets(jax_conv_model(3.0, 1.5), x, 4, 3)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    out = script.main(["--n_train=16", "--n_functions=4", "--steps=3",
                       "--device=cpu"])
    assert out["losses"][-1] < out["losses"][0]


def test_fit_scripts_run_on_cpu(tmp_path, capsys):
    """fit_paper_scale (exact fit, init / paper / fitted rows) and
    fit_deploy_large (probed fit, then the large path), at toy sizes;
    the saved leaves load in JAX and drive the deploy rows."""
    from cnn_gp_tpu_torch.scripts import fit_deploy_large, fit_paper_scale
    leaves = str(tmp_path / "fitted.npz")
    out = fit_paper_scale.main(["--n_train=12", "--n_test=8",
                                "--batch_size=8", "--steps=1",
                                f"--save_fitted={leaves}", "--device=cpu"])
    assert set(out["rows"]) == {"init", "paper", "fitted"}
    assert all(np.isfinite(v).all() for v in out["rows"].values())
    jfit.load_leaves(G.Sequential(*[
        m for _ in range(7) for m in (G.Conv2d(7, learnable=True),
                                      G.ReLU())],
        G.Conv2d(28, padding=0, learnable=True)), leaves)
    out = fit_deploy_large.main(["--n_fit=12", "--n_large=16",
                                 "--n_test=8", "--batch_size=8",
                                 "--fit_block=8", "--block=8", "--steps=1",
                                 f"--load_fitted={leaves}",
                                 "--eval_models=init,fitted",
                                 "--device=cpu"])
    assert set(out["rows"]) == {"init", "fitted"} and out["losses"] is None
    out = fit_deploy_large.main(["--n_fit=12", "--n_large=16",
                                 "--n_test=8", "--batch_size=8",
                                 "--fit_block=8", "--block=8", "--steps=2",
                                 "--eval_models=fitted", "--device=cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    text = capsys.readouterr().out
    assert "held-out LPD" in text and "[fit_large] step 1" in text


@pytest.mark.parametrize("script", ["fit_hyperparams", "fit_paper_scale",
                                    "fit_deploy_large"])
def test_fit_scripts_refuse_cuda_without_a_card(script):
    """The scripts run on the card by default and raise where there is
    none: nothing moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run the script")
    module = importlib.import_module(f"cnn_gp_tpu_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])

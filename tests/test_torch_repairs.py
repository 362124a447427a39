"""Public names of the JAX package that the port lacked, each held against
the JAX function on the same numpy inputs on the CPU: ``ops.solve.
classify``, ``parallel.scheduler.n_tiles`` and ``fit.fit(loss_fn=)``; and
the held-out LPD of the port's ``scripts/fit_paper_scale.py::evaluate``
against JAX's ``log_predictive_density`` on a fresh copy of the Gram."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import scheduler as jscheduler
from cnn_gp_tpu_torch import fit as tfit
from cnn_gp_tpu_torch.convert import from_jax_model
from cnn_gp_tpu_torch.ops import solve
from cnn_gp_tpu_torch.parallel import scheduler
from scripts.fit_hyperparams import make_model as jax_conv_model

jfit = importlib.import_module("cnn_gp_tpu.fit")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's small autograd ops (as
    tests/test_torch_fit.py: several workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rbf_problem(n, n_split, seed):
    """An upper-triangle RBF Gram of n points, and three splits of cross
    Grams with labels that depend on the points."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(4, 6)

    def draw(m):
        y = rng.randint(0, 4, m)
        return centres[y] + 0.8 * rng.randn(m, 6), y

    def rbf(a, b):
        d = ((a[:, None] - b[None]) ** 2).sum(-1)
        return np.exp(-d / 6.0)

    x, y = draw(n)
    kxx = np.triu(rbf(x, x))             # the store holds the upper tiles
    splits = {}
    for name in ("validation", "test", "extra"):
        z, yz = draw(n_split)
        splits[name] = (rbf(z, x), yz)
    return kxx, y, splits


@pytest.mark.parametrize("method", ["scipy", "chol"])
def test_classify_matches_jax(method):
    """ops.solve.classify: the upper triangle symmetrised, one solve, an
    accuracy per split, equal to JAX's on the same Gram and three
    splits."""
    kxx, y, splits = _rbf_problem(60, 25, 0)
    want = jsolve.classify(kxx.copy(), y, jitter=1e-3, method="scipy",
                           **splits)
    got = solve.classify(kxx.copy(), y, jitter=1e-3, method=method,
                         device=CPU, **splits)
    assert got == want
    assert sorted(got) == ["extra", "test", "validation"]
    assert 0.3 < min(got.values())       # the labels are learnable


@pytest.mark.parametrize("n1,n2,symmetric", [(5, 5, True), (3, 4, False),
                                             (0, 0, True), (1, 7, False),
                                             (4, 9, True)])
def test_n_tiles_matches_jax(n1, n2, symmetric):
    """scheduler.n_tiles: the cases of tests/test_scheduler.py:60-63 (with
    the reference's max(1, ...) when symmetric) and the manifest's own
    length, against JAX."""
    want = jscheduler.n_tiles(n1, n2, symmetric)
    assert scheduler.n_tiles(n1, n2, symmetric) == want
    if n1:
        n2_b = n1 if symmetric else n2   # a symmetric Gram is square
        assert len(scheduler.tile_manifest(n1, n2_b, symmetric)) == want


def test_fit_custom_loss_fn_matches_jax():
    """fit(loss_fn=...) optimises any scalar function of the model: a
    weighted NMLL at another jitter plus the mean diagonal kernel, whose
    per-step losses stay within 1e-3 of JAX's fit(loss_fn=...) over three
    steps."""
    x, labels, _, _ = synthetic_arrays(n_train=24, n_test=0,
                                       shape=(1, 14, 14), seed=2)
    y = jsolve.one_hot_targets(labels, dtype=np.float32)

    def jax_loss(m):
        return (0.5 * jfit.neg_marginal_log_likelihood(
            m, jnp.asarray(x), jnp.asarray(y), jitter=1e-3)
            + 0.1 * jnp.mean(m(jnp.asarray(x[:8]), diag=True)))

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    def port_loss(m):
        return (0.5 * tfit.neg_marginal_log_likelihood(m, xt, yt, 1e-3,
                                                       device=CPU)
                + 0.1 * m(xt[:8], diag=True).mean())

    jm = jax_conv_model(1.0, 0.5, learnable=True)
    _, want = jfit.fit(jm, x, y, steps=3, learning_rate=0.1,
                       loss_fn=jax_loss)
    _, got = tfit.fit(from_jax_model(jm), None, None, steps=3,
                      learning_rate=0.1, loss_fn=port_loss, device=CPU)
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # the default objective is not what was optimised
    _, default = tfit.fit(from_jax_model(jm), x, y, steps=1,
                          learning_rate=0.1, device=CPU)
    assert abs(default[0] - got[0]) > 1e-2 * abs(got[0])


def test_fit_paper_scale_lpd_matches_fresh_copy():
    """The port's scripts/fit_paper_scale.py::evaluate solves on a copy of
    Kxx, so its held-out LPD equals JAX's ops.solve.log_predictive_density
    on a fresh copy of Kxx, and its predictions equal JAX's.

    The gap: JAX's scripts/fit_paper_scale.py::evaluate passes its ``kxx``
    to ``solve_gp(method="scipy")``, which adds the jitter in place, and
    then the same ``kxx`` to ``log_predictive_density``, which adds
    ``jitter_rel * mean(diag)`` again: its LPD is that of K + ~2 jr I.  The
    predictions are the same; the LPD differs in the noise term only.  The
    last assertion pins that: JAX's script equals the oracle on Kxx with
    the jitter already added once."""
    from cnn_gp_tpu_torch.scripts.fit_paper_scale import evaluate
    from scripts.fit_paper_scale import evaluate as jax_evaluate

    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=40, n_test=24, shape=(1, 14, 14), seed=4)
    jm = jax_conv_model(2.0, 1.0)
    jitter_rel = 1e-2                   # large enough to see the gap
    acc, lml, lpd, lpd_se = evaluate(from_jax_model(jm), tr_x, tr_y, te_x,
                                     te_y, 16, jitter_rel, device=CPU)

    kxx = np.asarray(jgram(jm, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzx = np.asarray(jgram(jm, te_x, tr_x, batch_size=16, progress=False),
                     np.float64)
    kzz = np.asarray(jm(te_x, diag=True), np.float64)
    jr = jitter_rel * float(np.mean(np.diagonal(kxx)))
    want_lpd, want_se, _ = jsolve.log_predictive_density(
        kxx.copy(), kzx, kzz, tr_y, te_y, jitter_rel=jitter_rel)
    assert abs(lpd - want_lpd) < 1e-5 * abs(want_lpd)
    assert abs(lpd_se - want_se) < 1e-4 * abs(want_se)
    a = jsolve.solve_gp(kxx.copy(), jsolve.one_hot_targets(tr_y),
                        jitter=jr, method="scipy")
    assert acc == jsolve.accuracy(jsolve.predict(kzx, a), te_y)
    assert abs(lml - jsolve.log_marginal_likelihood(
        kxx, jsolve.one_hot_targets(tr_y),
        jitter_rel=jitter_rel)) < 1e-6 * abs(lml)

    j_acc, _, j_lpd, _ = jax_evaluate(jm, tr_x, tr_y, te_x, te_y, 16,
                                      jitter_rel)
    assert j_acc == acc
    once = kxx.copy()
    jsolve.diag_add(once, jr)
    twice_lpd, _, _ = jsolve.log_predictive_density(
        once, kzx, kzz, tr_y, te_y, jitter_rel=jitter_rel)
    assert abs(j_lpd - twice_lpd) < 1e-6 * abs(twice_lpd)
    assert abs(j_lpd - lpd) > 1e-4 * abs(lpd)

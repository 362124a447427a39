"""The port's probed NMLL (cnn_gp_tpu_torch.fit.ProbedNMLL and
fit_large(grad="probed")) against its exact tiled path and against the
JAX package's ProbedNMLL on the same numpy inputs and seeds, on the CPU.
Counterparts of tests/test_fit.py:182-277."""

import importlib

import jax
import numpy as np
import pytest
import torch

from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu_torch import fit_lib as tfit
from cnn_gp_tpu_torch.convert import from_jax_model
from scripts.fit_hyperparams import draw_gp_targets
from scripts.fit_hyperparams import make_model as jax_conv_model

jfit = importlib.import_module("cnn_gp_tpu.fit")
CPU = torch.device("cpu")
LEAVES = ("[<flat index 0>][0].var_weight", "[<flat index 0>][0].var_bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_fit.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_grads(tree):
    return {jax.tree_util.keystr(p): float(np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def problem():
    """N = 37 with b = 16: ragged edge tiles, nt = 3."""
    x, labels, _, _ = synthetic_arrays(n_train=37, n_test=0,
                                       shape=(1, 14, 14), seed=5)
    y = jsolve.one_hot_targets(labels, dtype=np.float32)
    return x, y, jax_conv_model(2.0, 1.0, learnable=True)


BASIS = np.sqrt(37.0) * np.eye(37)


def test_probed_matches_tiled_under_basis_probes(problem):
    """Under sqrt(n) I probes the estimator is exact: value and gradient
    equal the port's exact tiled path within 1e-4 (tests/test_fit.py:200),
    and every phase is timed."""
    x, y, jm = problem
    tm = from_jax_model(jm)
    want_v, want_g = tfit.nmll_value_and_grad_tiled(tm, x, y, batch_size=16,
                                                    device=CPU)
    plan = tfit.ProbedNMLL(x, y, batch_size=16, block=16, device=CPU)
    got_v, got_g = plan.value_and_grad(tm, _probe_matrix=BASIS)
    assert set(plan.last_phases) == {"diag", "assemble", "factor", "solve",
                                     "grad_vjp"}
    assert abs(got_v - want_v) < 1e-4 * abs(want_v), (got_v, want_v)
    for k in LEAVES:
        w, g = float(want_g[k]), float(got_g[k])
        assert abs(g - w) < 1e-4 * max(abs(w), 1e-3), (k, g, w)


@pytest.mark.parametrize("tile_fraction", [1.0, 0.5])
def test_probed_rademacher_matches_jax(problem, tile_fraction):
    """The same seed gives the same Rademacher probes and, with
    tile_fraction < 1, the same importance-sampled tiles as JAX: value
    within 1e-4, gradient within 3e-3."""
    x, y, jm = problem
    jplan = jfit.ProbedNMLL(x, y, batch_size=16, block=16,
                            tile_fraction=tile_fraction, tiles_per_call=4)
    want_v, want_g = jplan.value_and_grad(jm, seed=3)
    want_g = jax_grads(want_g)
    plan = tfit.ProbedNMLL(x, y, batch_size=16, block=16,
                           tile_fraction=tile_fraction, device=CPU)
    got_v, got_g = plan.value_and_grad(from_jax_model(jm), seed=3)
    assert abs(got_v - want_v) < 1e-4 * abs(want_v), (got_v, want_v)
    for k in LEAVES:
        w, g = want_g[k], float(got_g[k])
        assert abs(g - w) < 3e-3 * max(abs(w), 1e-3), (k, g, w)


def test_tile_subsampled_grad_unbiased(problem, monkeypatch):
    """The importance-sampled estimator is exactly unbiased: with the draw
    forced to each strictly-upper tile in turn, the probability-weighted
    mean of the estimates equals the full sweep's gradient
    (tests/test_fit.py:207-255)."""
    x, y, jm = problem
    tm = from_jax_model(jm)
    full = tfit.ProbedNMLL(x, y, batch_size=16, block=16, device=CPU)
    _, g_full = full.value_and_grad(tm, _probe_matrix=BASIS)
    sub = tfit.ProbedNMLL(x, y, batch_size=16, block=16, tile_fraction=0.5,
                          device=CPU)
    probs = {}

    class ForcedRng:
        def __init__(self, tile):
            self.tile = tile

        def choice(self, n, size, replace, p):
            probs["p"] = np.asarray(p)
            return np.full(size, self.tile, np.int64)

    ests = {k: [] for k in LEAVES}
    for t in range(3):                     # nt = 3: 3 strictly-upper tiles
        monkeypatch.setattr(np.random, "default_rng",
                            lambda *a, t=t, **k: ForcedRng(t))
        _, g = sub.value_and_grad(tm, _probe_matrix=BASIS)
        for k in ests:
            ests[k].append(float(g[k]))
    monkeypatch.undo()
    p = probs["p"]
    assert p.shape == (3,) and abs(p.sum() - 1.0) < 1e-12
    for k in LEAVES:
        want = float(g_full[k])
        got = float((p * np.asarray(ests[k])).sum())
        assert abs(got - want) < 1e-3 * max(abs(want), 1e-3), (
            k, got, want, ests[k])


def test_probed_frees_the_factor_before_assembly(problem, monkeypatch):
    """The previous step's factor is released before the next assembly,
    so one N_pad^2 buffer is resident, not two."""
    x, y, jm = problem
    plan = tfit.ProbedNMLL(x, y, batch_size=16, block=16, device=CPU)
    seen = []
    real = tfit._assemble_scaled

    def spy(*a, **k):
        seen.append(plan.factor.l is None)
        return real(*a, **k)

    monkeypatch.setattr(tfit, "_assemble_scaled", spy)
    tm = from_jax_model(jm)
    for seed in range(2):
        plan.value_and_grad(tm, seed=seed)
        assert plan.factor.l is not None
    assert seen == [True, True]
    with pytest.raises(ValueError, match="tile_fraction"):
        tfit.ProbedNMLL(x, y, tile_fraction=0.0, device=CPU)


def _gp_problem(n, seed):
    x, _, _, _ = synthetic_arrays(n_train=n, n_test=0, shape=(1, 14, 14),
                                  seed=seed)
    return x, draw_gp_targets(jax_conv_model(3.0, 1.5), x, 8, 0)


def test_fit_large_probed_trajectory_matches_jax():
    """Three probed steps (seeds 0, 1, 2; refine_iters 0 and 1): the loss
    per step within 1e-3 of JAX's."""
    x, y = _gp_problem(40, 3)
    jm = jax_conv_model(1.0, 0.5, learnable=True)
    for refine_iters in (1, 0):
        _, want = jfit.fit_large(jm, x, y, steps=3, batch_size=16,
                                 grad="probed", probes=8, block=16,
                                 refine_iters=refine_iters)
        _, got = tfit.fit_large(from_jax_model(jm), x, y, steps=3,
                                batch_size=16, grad="probed", probes=8,
                                block=16, refine_iters=refine_iters,
                                device=CPU)
        np.testing.assert_allclose(got, want, rtol=1e-3)


def test_fit_large_probed_improves_nmll(capsys):
    """The probed fit lowers the (solver-exact) NMLL and moves var_weight
    toward the generating 3.0 (tests/test_fit.py:258-277); its verbose
    lines carry the phases."""
    x, y = _gp_problem(48, 3)
    model = from_jax_model(jax_conv_model(1.0, 0.5, learnable=True))
    fitted, losses = tfit.fit_large(model, x, y, steps=12,
                                    learning_rate=0.15, batch_size=16,
                                    grad="probed", probes=8, block=16,
                                    verbose=True, device=CPU)
    assert losses[-1] < losses[0], losses
    assert float(fitted.mods[0].var_weight.detach()) > 1.3
    assert "'grad_vjp'" in capsys.readouterr().out

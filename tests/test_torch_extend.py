"""The port's in-place factor extension (``CardFactor(capacity=...)``,
``extend``, ``extend_device``) against the JAX package's
``_ShardedFactor`` on a one-device mesh and against LAPACK, on the CPU, on
the unit-diagonal SPD matrices of tests/test_extend.py."""

import numpy as np
import pytest
import torch

from cnn_gp_tpu.parallel import make_mesh
from cnn_gp_tpu.parallel.chol_dist import _ShardedFactor
from cnn_gp_tpu_torch.parallel.chol_dist import CardFactor
from tests.test_extend import _gather_factor, _spd_equilibrated

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_devices=1)


def port_factor(k, n, block, capacity, pad_to=1):
    f = CardFactor(n, block, pad_to=pad_to, capacity=capacity, device=CPU)
    f.factorize(np.asarray(k[:n, :n], np.float32))
    return f


def jax_factor(mesh, k, n, block, capacity, pad_to=1):
    f = _ShardedFactor(mesh, n, block, pad_to=pad_to, capacity=capacity)
    f.factorize(np.asarray(k[:n, :n], np.float32))
    return f


def lower(f):
    return np.tril(f.l.numpy()[:f.n, :f.n])


@pytest.mark.parametrize("n,block,pad_to,capacity", [
    (40, 16, 1, 52), (37, 16, 1, 56), (40, 16, 24, 100), (30, 8, 16, None),
    (128, 32, 16, 200)])
def test_capacity_geometry_equals_jax(mesh1, n, block, pad_to, capacity):
    f = CardFactor(n, block, pad_to=pad_to, capacity=capacity, device=CPU)
    assert f.n_pad == _ShardedFactor(mesh1, n, block, pad_to=pad_to,
                                     capacity=capacity).n_pad
    assert f.n_pad >= max(n, capacity or n)


@pytest.mark.parametrize("n,m,block", [
    (40, 12, 16),    # unaligned n and n + m, inside one block row
    (37, 19, 16),    # crosses a block boundary mid-extension
])
def test_extend_matches_full_factor_and_jax(mesh1, n, m, block):
    m2 = _spd_equilibrated(n + m, seed=n)
    f = port_factor(m2, n, block, n + m)
    f.extend(m2[n:, :n], m2[n:, n:])
    assert f.n == n + m
    jf = jax_factor(mesh1, m2, n, block, n + m)
    jf.extend(m2[n:, :n], m2[n:, n:])

    got = lower(f)
    np.testing.assert_allclose(got, np.linalg.cholesky(m2), atol=5e-5)
    np.testing.assert_allclose(got, _gather_factor(jf), atol=5e-5)
    # the buffer past n + m is still the identity pad, the upper triangle 0
    full = f.l.numpy()
    assert (np.triu(full, 1) == 0).all()
    np.testing.assert_array_equal(full[n + m:, n + m:],
                                  np.eye(f.n_pad - n - m))
    assert (full[n + m:, :n + m] == 0).all()
    # the diagonal blocks (read from the live buffer) equal JAX's
    # refreshed diag stack
    np.testing.assert_allclose(np.tril(f.diag_blocks().numpy()),
                               np.tril(np.asarray(jf.diags)), atol=5e-5)


def test_extend_solve_with_refinement():
    """The extended factor drives float32 solves with float64 refinement
    to float64 quality, as a factor from scratch does."""
    n, m, block = 96, 32, 32
    m2 = _spd_equilibrated(n + m, seed=3)
    y = np.random.RandomState(7).randn(n + m, 4)
    f = port_factor(m2, n, block, n + m)
    f.extend(m2[n:, :n], m2[n:, n:])
    a = f.solve(y.astype(np.float32)).astype(np.float64)
    for _ in range(3):
        r = y - m2 @ a
        a = a + f.solve(r.astype(np.float32)).astype(np.float64)
    rel = np.linalg.norm(y - m2 @ a) / np.linalg.norm(y)
    assert rel < 1e-10, rel
    np.testing.assert_allclose(a, np.linalg.solve(m2, y), rtol=1e-8)


def test_extend_twice_and_logdet(mesh1):
    """Chained extensions stay exact, and log_diag_sum follows the live
    factor within 1e-4 (LAPACK's and JAX's)."""
    n, m1, m2_, block = 30, 11, 23, 16
    full = _spd_equilibrated(n + m1 + m2_, seed=11)
    f = port_factor(full, n, block, n + m1 + m2_)
    jf = jax_factor(mesh1, full, n, block, n + m1 + m2_)
    for g in (f, jf):
        g.extend(full[n:n + m1, :n], full[n:n + m1, n:n + m1])
        k = n + m1
        g.extend(full[k:, :k], full[k:, k:])
    want = np.linalg.cholesky(full)
    np.testing.assert_allclose(lower(f), want, atol=5e-5)
    np.testing.assert_allclose(lower(f), _gather_factor(jf), atol=5e-5)
    half_logdet = float(np.sum(np.log(np.diagonal(want))))
    assert abs(f.log_diag_sum() - half_logdet) < 1e-4
    assert abs(f.log_diag_sum() - jf.log_diag_sum()) < 1e-4


@pytest.mark.parametrize("device_blocks", [False, True])
def test_extend_non_pd_refused_factor_intact(mesh1, device_blocks):
    """New rows that duplicate training rows make the Schur complement
    singular: the extension raises before any write, like JAX's, and the
    factor stays bit-equal and keeps solving."""
    n, block = 32, 16
    k = _spd_equilibrated(n, seed=2)
    f = port_factor(k, n, block, n + 8)
    before = f.l.clone()
    b_dup = k[:8, :].astype(np.float32)
    c_dup = k[:8, :8].astype(np.float32)
    with pytest.raises(ValueError, match="positive-definite"):
        if device_blocks:
            w = torch.zeros((f.n_pad, 8))
            w[:n] = torch.from_numpy(b_dup.T)
            f.extend_device(w, torch.from_numpy(c_dup))
        else:
            f.extend(b_dup, c_dup)
    assert f.n == n
    assert torch.equal(f.l, before)
    jf = jax_factor(mesh1, k, n, block, n + 8)
    with pytest.raises(ValueError, match="positive-definite"):
        jf.extend(b_dup, c_dup)
    y = np.random.RandomState(0).randn(n, 3)
    a = f.solve(y.astype(np.float32)).astype(np.float64)
    assert np.linalg.norm(y - k @ a) / np.linalg.norm(y) < 1e-3


def test_extend_capacity_refused():
    k = _spd_equilibrated(24, seed=5)
    f = port_factor(k, 24, 8, None)     # no capacity past the alignment
    spare = f.n_pad - f.n
    with pytest.raises(ValueError, match="capacity"):
        f.extend(np.zeros((spare + 1, 24), np.float32),
                 np.eye(spare + 1, dtype=np.float32))
    with pytest.raises(ValueError, match="capacity"):
        f.extend_device(torch.zeros((f.n_pad, f.n_pad)),
                        torch.eye(f.n_pad))
    assert f.n == 24


def test_extend_device_equals_extend():
    """``extend_device`` runs the same core as ``extend``: the same blocks
    give the same factor and solves, bit for bit, and its inputs are left
    as they were."""
    n, m, block = 37, 19, 16
    m2 = _spd_equilibrated(n + m, seed=5)
    rhs = np.random.RandomState(2).randn(n + m, 4).astype(np.float32)
    f_host = port_factor(m2, n, block, n + m)
    f_host.extend(m2[n:, :n], m2[n:, n:])
    f_dev = port_factor(m2, n, block, n + m)
    w = torch.zeros((f_dev.n_pad, m))
    w[:n] = torch.from_numpy(m2[:n, n:].astype(np.float32))
    c = torch.from_numpy(m2[n:, n:].astype(np.float32))
    w0, c0 = w.clone(), c.clone()
    f_dev.extend_device(w, c)
    assert f_dev.n == n + m
    assert torch.equal(w, w0) and torch.equal(c, c0)
    assert torch.equal(f_dev.l, f_host.l)
    np.testing.assert_array_equal(f_dev.solve(rhs), f_host.solve(rhs))


def test_extend_validation():
    f = CardFactor(16, 8, capacity=24, device=CPU)
    with pytest.raises(RuntimeError, match="factorize"):
        f.extend_device(torch.zeros((f.n_pad, 8)), torch.zeros((8, 8)))
    with pytest.raises(RuntimeError, match="factorize"):
        f.extend(np.zeros((8, 16)), np.eye(8))
    f.factorize(_spd_equilibrated(16).astype(np.float32))
    with pytest.raises(ValueError):
        f.extend_device(torch.zeros((3, 8)), torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        f.extend(np.zeros((8, 15)), np.eye(8))
    with pytest.raises(ValueError):
        f.extend(np.zeros((8, 16)), np.eye(7))

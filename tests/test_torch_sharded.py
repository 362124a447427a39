"""The port's rank-group Gram assembly and CG solve
(``compute_gram_sharded``, ``cg_solve_sharded``) on the CPU: with no
process group, a one-rank gloo group in this process, and spawned gloo
worlds of 2 and 4 ranks (``tests/_torch_dist_worker.py``).  Each is held
bit for bit against the port's ``compute_gram``, within 1e-5 of value
scale against the JAX package's ``compute_gram_sharded`` on its 8-device
CPU mesh, and to the tolerances of ``tests/test_sharded.py`` against
``np.linalg.solve`` and JAX's ``cg_solve_sharded``."""

import datetime
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import cnn_gp_tpu as G
import _torch_dist_worker as W
from cnn_gp_tpu_torch.entry import reserved_port
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import cg_solve_sharded as jcg
from cnn_gp_tpu.parallel import compute_gram_sharded as jgram_sharded
from cnn_gp_tpu.parallel import make_mesh as jmake_mesh
from cnn_gp_tpu_torch.parallel import (compute_gram, compute_gram_sharded,
                                       cg_solve_sharded, gram, make_mesh,
                                       multihost)
from cnn_gp_tpu_torch.parallel.mesh import row_span

CPU = torch.device("cpu")
TOL = 1e-5
WORLDS = ["none", "gloo1", 2, 4]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_rank_gloo():
    """A one-rank gloo group, joined as torchrun's ranks join theirs."""
    with reserved_port() as port:
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "RANK": "0", "WORLD_SIZE": "1"}
        with mock.patch.dict(os.environ, env):
            dev = multihost.initialize(
                "env", device="cpu",
                timeout=datetime.timedelta(seconds=W.TIMEOUT_S))
    assert dev == CPU and dist.get_backend() == "gloo"


@pytest.fixture(scope="module", params=WORLDS, ids=str)
def world(request, tmp_path_factory, one_torch_thread):
    """(size, [each rank's results of ``_torch_dist_worker.sharded``])."""
    out_dir = str(tmp_path_factory.mktemp(f"world_{request.param}"))
    if request.param == "none":
        return 1, [W.sharded(make_mesh(device="cpu"), out_dir)]
    if request.param == "gloo1":
        _one_rank_gloo()
        try:
            mesh = make_mesh(device="cpu")
            assert mesh.group is not None and mesh.size == 1
            return 1, [W.sharded(mesh, out_dir)]
        finally:
            dist.destroy_process_group()
    return request.param, W.run_world(request.param, "sharded", out_dir)


def _port_gram(model, x, z=None, b=10):
    n2 = len(x) if z is None else len(z)
    out = np.full((len(x), n2), np.nan, np.float32)
    compute_gram(model, x, z, device=CPU, batch_size=b, out=out,
                 progress=False)
    return out


def _jmodel():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(7, padding=0))


def _jpaper_small():
    return G.Sequential(
        G.Conv2d(7, var_weight=2.79 * 49, var_bias=7.86), G.ReLU(),
        G.Conv2d(14, padding=0, var_weight=2.79, var_bias=7.86))


@pytest.fixture(scope="module")
def ref(one_torch_thread):
    """The port's compute_gram and the JAX package's sharded Grams, CG
    solves and end-to-end predictions on the same inputs."""
    x, xc, zc, xr = W.gram_inputs()
    model = W._model()
    mesh = jmake_mesh()
    r = {"sym": _port_gram(model, x), "cross": _port_gram(model, xc, zc),
         "resume": _port_gram(model, xr),
         "j_sym": jgram_sharded(_jmodel(), x, batch_size=10, mesh=mesh,
                                tiles_per_round_per_device=2,
                                progress=False),
         "j_cross": jgram_sharded(_jmodel(), xc, zc, batch_size=10,
                                  mesh=mesh, progress=False)}
    y100 = jsolve.one_hot_targets(np.arange(100) % 10)
    r["j_cg100"] = jcg(W.spd(100), y100, jitter=0.1, mesh=mesh, tol=1e-6,
                       maxiter=1000)
    y37 = jsolve.one_hot_targets(np.arange(37) % 10)
    r["j_cg37"] = jcg(W.spd(37, seed=1), y37, mesh=mesh, tol=1e-7,
                      maxiter=500)
    tr_x, tr_y, te_x, te_y = W.e2e_inputs()
    jm = _jpaper_small()
    kxx = jgram_sharded(jm, tr_x, batch_size=32, mesh=mesh, progress=False)
    kzx = jgram_sharded(jm, te_x, tr_x, batch_size=32, mesh=mesh,
                        progress=False)
    s = np.sqrt(np.diagonal(kxx).mean())
    a, _, _ = jcg(kxx / s ** 2, jsolve.one_hot_targets(tr_y), jitter=1e-8,
                  mesh=mesh, tol=1e-6, maxiter=2000)
    r["j_e2e_kxx"], r["j_e2e_kzx"] = kxx, kzx
    r["j_e2e_pred"] = jsolve.predict(kzx / s ** 2, a)
    r["e2e_kxx"] = _port_gram(W.paper_small(), tr_x, b=32)
    r["e2e_kzx"] = _port_gram(W.paper_small(), te_x, tr_x, b=32)
    r["te_y"] = te_y
    return r


def _scaled(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(
        want).max()


def test_sharded_gram_matches_compute_gram(world, ref):
    """Symmetric, N = 53 (not a multiple of 10 x ranks): bit for bit the
    port's compute_gram (mirrored), exactly symmetric, within 1e-5 of
    JAX's; every rank reassembles the same out."""
    for res in world[1]:
        np.testing.assert_array_equal(res["sym"], ref["sym"])
        np.testing.assert_array_equal(res["sym"], res["sym"].T)
        assert _scaled(res["sym"], ref["j_sym"]) <= TOL


def test_sharded_gram_cross(world, ref):
    for res in world[1]:
        np.testing.assert_array_equal(res["cross"], ref["cross"])
        assert _scaled(res["cross"], ref["j_cross"]) <= TOL


def test_sharded_gram_store_resume(world, ref):
    """Rank 0 alone writes the store (the other ranks hold a store that
    fails on any use); the first call computes every tile once across
    the ranks (padding repeats tile 0) and returns no out where rank 0
    has a store; the resumed call computes and uploads nothing and
    backfills rank 0's stored tiles into every rank's out."""
    size, results = world
    # 4 row batches of 33: 10 upper tiles, one round padded to the ranks
    assert sum(int(r["first_tiles"]) for r in results) == 10 + (-10) % size
    for res in results:
        assert bool(res["first_out_none"])
        assert int(res["first_uploads"]) == 1
        assert int(res["resume_tiles"]) == 0
        assert int(res["resume_uploads"]) == 0
        np.testing.assert_array_equal(res["resumed"], ref["resume"])


def test_cg_matches_direct(world, ref):
    """tests/test_sharded.py's tolerances against np.linalg.solve; JAX's
    iteration count within 2, the residual within JAX's tol."""
    k = W.spd(100)
    want = np.linalg.solve(k + 0.1 * np.eye(100),
                           jsolve.one_hot_targets(np.arange(100) % 10))
    j_it = ref["j_cg100"][2]
    for res in world[1]:
        rel, it = res["cg100_rel_it"]
        assert rel <= 1e-6
        np.testing.assert_allclose(res["cg100"], want, rtol=1e-3, atol=1e-4)
        assert abs(int(it) - j_it) <= 2, (it, j_it)


def test_cg_uneven_rows(world, ref):
    """N = 37 does not split over 2 or 4 ranks: identity padding must
    not change the solution."""
    want = np.linalg.solve(W.spd(37, seed=1),
                           jsolve.one_hot_targets(np.arange(37) % 10))
    j_it = ref["j_cg37"][2]
    for res in world[1]:
        rel, it = res["cg37_rel_it"]
        np.testing.assert_allclose(res["cg37"], want, rtol=1e-3, atol=1e-4)
        assert rel <= 1e-7 and abs(int(it) - j_it) <= 2, (rel, it, j_it)


def test_sharded_classification_end_to_end(world, ref):
    """Sharded Gram + sharded CG + accuracy (tests/test_sharded.py's
    pipeline): the Grams bit for bit compute_gram's and within 1e-5 of
    JAX's, accuracy > 0.9, predictions equal to JAX's pipeline's."""
    for res in world[1]:
        np.testing.assert_array_equal(res["e2e_kxx"], ref["e2e_kxx"])
        np.testing.assert_array_equal(res["e2e_kzx"], ref["e2e_kzx"])
        assert _scaled(res["e2e_kxx"], ref["j_e2e_kxx"]) <= TOL
        assert _scaled(res["e2e_kzx"], ref["j_e2e_kzx"]) <= TOL
        assert jsolve.accuracy(res["e2e_pred"], ref["te_y"]) > 0.9
        np.testing.assert_array_equal(res["e2e_pred"], ref["j_e2e_pred"])


def test_every_rank_returns_the_same(world):
    size, results = world
    assert len(results) == size
    for res in results[1:]:
        for key, val in results[0].items():
            np.testing.assert_array_equal(res[key], val, err_msg=key)


# -- in this process only ---------------------------------------------------

def _spy_uploads(monkeypatch):
    puts = []
    real = gram._on_device

    def spy(a, device):
        puts.append(np.shape(a))
        return real(a, device)

    monkeypatch.setattr(gram, "_on_device", spy)
    return puts


def test_sharded_gram_single_upload(monkeypatch):
    """The dataset goes to the device once across all rounds."""
    x = W.gram_inputs()[0]
    puts = _spy_uploads(monkeypatch)
    got = compute_gram_sharded(W._model(), x, batch_size=10,
                               mesh=make_mesh(device="cpu"),
                               tiles_per_round_per_device=1,
                               progress=False)
    assert puts == [x.shape]
    np.testing.assert_array_equal(got, _port_gram(W._model(), x))


def test_sharded_gram_resumed_noop_uploads_nothing(tmp_path, monkeypatch):
    from cnn_gp_tpu_torch.data import GramStore
    xr = W.gram_inputs()[3]
    mesh = make_mesh(device="cpu")
    with GramStore(str(tmp_path / "sharded.h5"), "w") as store:
        compute_gram_sharded(W._model(), xr, batch_size=10, mesh=mesh,
                             store=store, name="Kxx", progress=False)
        puts = _spy_uploads(monkeypatch)
        compute_gram_sharded(W._model(), xr, batch_size=10, mesh=mesh,
                             store=store, name="Kxx", progress=False)
        assert not puts, puts
        store.assert_complete("Kxx", upper_triangle_only=True)


def test_sharded_gram_partial_resume(tmp_path):
    """A store holding some tiles: only the others are computed, and the
    out holds both."""
    from cnn_gp_tpu_torch.data import GramStore
    xr = W.gram_inputs()[3]
    want = _port_gram(W._model(), xr)
    mesh = make_mesh(device="cpu")
    with GramStore(str(tmp_path / "part.h5"), "w") as store:
        compute_gram(W._model(), xr, device=CPU, batch_size=10, store=store,
                     name="Kxx", worker_rank=0, n_workers=2, progress=False)
        got = compute_gram_sharded(W._model(), xr, batch_size=10, mesh=mesh,
                                   store=store, name="Kxx",
                                   out=np.full((33, 33), np.nan, np.float32),
                                   progress=False)
        store.assert_complete("Kxx", upper_triangle_only=True)
    np.testing.assert_array_equal(got, want)


def test_mesh_and_identity_without_a_group(monkeypatch):
    """No group: a world of one on cuda:0 unless asked for the CPU, which
    raises without CUDA, as every entry point of the port does."""
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1,
                                                               CPU)
    assert multihost.worker_identity() == (0, 1)
    assert multihost.initialize(num_processes=1, device="cpu") == CPU
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh(2, device="cpu")
    assert row_span(12, mesh) == (0, 12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (make_mesh,
                 lambda: compute_gram_sharded(W._model(), np.zeros(
                     (3, 1, 7, 7), np.float32)),
                 lambda: cg_solve_sharded(np.eye(3), np.eye(3))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_row_span_and_backend_checks(monkeypatch):
    """row_span cuts n_pad evenly over the ranks; a gloo group refuses a
    CUDA device (card tensors are never staged through the CPU)."""
    from cnn_gp_tpu_torch.parallel.mesh import Mesh
    spans = [row_span(12, Mesh(None, r, 4, CPU)) for r in range(4)]
    assert spans == [(0, 3), (3, 6), (6, 9), (9, 12)]
    with pytest.raises(ValueError, match="do not split"):
        row_span(10, Mesh(None, 0, 4, CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    _one_rank_gloo()
    try:
        assert multihost.worker_identity() == (0, 1)
        with pytest.raises(ValueError, match="gloo group cannot carry"):
            make_mesh(device="cuda:0")
    finally:
        dist.destroy_process_group()


def test_cg_float64_and_dtype_names():
    """dtype float64 (torch or numpy spelling) solves to 1e-12."""
    k = W.spd(40, seed=3)
    y = jsolve.one_hot_targets(np.arange(40) % 10)
    want = np.linalg.solve(k, y)
    mesh = make_mesh(device="cpu")
    for dt in (torch.float64, np.float64):
        a, rel, it = cg_solve_sharded(k, y, mesh=mesh, tol=1e-12,
                                      maxiter=500, dtype=dt)
        assert a.dtype == np.float64 and rel <= 1e-12 and it > 0
        assert np.abs(a - want).max() <= 1e-10 * np.abs(want).max()

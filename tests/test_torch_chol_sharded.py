"""The port's row-sharded blocked Cholesky (``ShardedFactor``,
``cholesky_sharded``) and ``mesh=`` on the entry points built on it, on
the CPU: a one-rank gloo group in this process and spawned gloo worlds of
2 and 4 ranks (``tests/_torch_dist_worker.py::chol_sharded``, one world
per size for the whole module).  Each result is held against the JAX
package's on the 8-device CPU mesh of tests/conftest.py, on the same
numpy inputs, and against LAPACK / scipy; every rank must return the same
bits.  The HDF5 store, the posterior and one factor cache the ranks read
are written by the JAX package; the factor cache the ranks write is read
back by it."""

import datetime
import importlib
import os
import shutil
from unittest import mock

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import cnn_gp_tpu as G
import _torch_dist_worker as W
from cnn_gp_tpu_torch.entry import reserved_port
from cnn_gp_tpu import serving as jserving
from cnn_gp_tpu.data import GramStore as JStore
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import IncrementalGP as JIncrementalGP
from cnn_gp_tpu.parallel import chol_dist as jcd
from cnn_gp_tpu.parallel import classify_device_large as jlarge
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import make_mesh as jmake_mesh
from cnn_gp_tpu_torch.parallel import make_mesh, multihost
from scripts.fit_hyperparams import make_model as jax_conv_model

jfit = importlib.import_module("cnn_gp_tpu.fit")
WORLDS = [1, 2, 4]
EVIDENCE_RTOL = 5e-4                 # tests/test_device_large.py
VAR_ATOL, VAR_RTOL = 5e-6, 2e-4      # * mean(kzz); tests/test_device_pipeline.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmodel():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(7, padding=0))


def _jpaper_small():
    return G.Sequential(
        G.Conv2d(7, var_weight=2.79 * 49, var_bias=7.86), G.ReLU(),
        G.Conv2d(14, padding=0, var_weight=2.79, var_bias=7.86))


def _jinc_model():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(3), G.ReLU(),
                        G.Conv2d(8, padding=0))


def _jax_grads(tree):
    return {jax.tree_util.keystr(p): float(np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, one_torch_thread):
    """The numpy inputs, the JAX package's files the ranks read (an HDF5
    store, a posterior, a factor cache on a 2-device mesh) and JAX's
    results on its 8-device CPU mesh."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh of tests/conftest.py")
    d = str(tmp_path_factory.mktemp("jax_files"))
    mesh8 = jmake_mesh()
    r = {"dir": d}
    inp = {f"rhs_{n}": np.random.RandomState(n + 1).randn(n, 3)
           for n in (37, 64, 100, 130)}
    inp["w_100"] = np.random.RandomState(3).randn(100, 7).astype(np.float32)
    inp["rhs_ext"] = np.random.RandomState(4).randn(W.EXT["n0"]
                                                    + W.EXT["m"], 3)
    for n, block in W.FACTOR_CASES + ((64, 16),):
        r[f"j_l_{n}"] = jcd.cholesky_sharded(W.spd_chol(n, seed=n), mesh8,
                                             block=block)

    # extension: JAX's _ShardedFactor on the 8-device mesh
    e = W.EXT
    k = W.spd_chol(e["n"], seed=e["seed"]).astype(np.float32)
    jf = jcd._ShardedFactor(mesh8, e["n0"], e["block"], capacity=e["n"])
    jf.factorize(k[:e["n0"], :e["n0"]])
    jf.extend(k[e["n0"]:e["n0"] + e["m"], :e["n0"]],
              k[e["n0"]:e["n0"] + e["m"], e["n0"]:e["n0"] + e["m"]])
    n1 = e["n0"] + e["m"]
    r["j_ext_l"] = np.asarray(jax.device_put(
        jf.l_loc, jax.sharding.NamedSharding(
            mesh8, jax.sharding.PartitionSpec())))[:n1, :n1]
    r["j_ext_solve"] = jf.solve(inp["rhs_ext"].astype(np.float32))

    y = jsolve.one_hot_targets(np.arange(120) % 10)
    r["j_cd_a"] = jcd.chol_solve_dist(W.spd_chol(120, seed=5), y,
                                      mesh=mesh8, block=16)[0]

    # a small-model Gram (n = 70, tile 16: a ragged edge) in a JAX store
    jm = _jmodel()
    x, yl, zx, _ = synthetic_arrays(n_train=70, n_test=12, shape=(1, 7, 7))
    k = np.asarray(jgram(jm, x, batch_size=16, progress=False))
    inp["k_store"] = k
    inp["kzx_store"] = np.asarray(jgram(jm, zx, x, batch_size=16,
                                        progress=False))
    inp["kzz_store"] = np.asarray(jm(zx, diag=True), np.float64)
    inp["y_store"] = jsolve.one_hot_targets(yl)
    inp["jr_store"] = np.array(1e-4 * float(np.mean(np.diagonal(k))))
    with JStore(os.path.join(d, "k.h5"), "w") as store:
        store.create("Kxx", 70, 70, 16)
        for i in range(0, 70, 16):
            for j in range(i, 70, 16):
                store.write_tile("Kxx", i, j, k[i:i + 16, j:j + 16])
    a, _, _, jf, js = jcd.chol_solve_ir32(
        k, inp["y_store"], jitter=float(inp["jr_store"]), mesh=mesh8,
        block=16, return_factor=True)
    r["j_ir_a"], r["j_ir_s"] = a, js
    r["j_ir_var"] = jcd.variances_from_cross_host(
        jf, js, inp["kzx_store"], inp["kzz_store"])
    r["j_ir_ev"] = jcd.evidence_from_factor(jf, js, inp["y_store"], a)
    with JStore(os.path.join(d, "k.h5"), "r") as store:
        a, _, _, jf, js = jcd.chol_solve_dist_from_store(
            store, "Kxx", inp["y_store"], jitter=1e-6, block=16,
            mesh=mesh8, return_factor=True)
        r["k_store64"] = jsolve.symmetrize_from_upper(
            store.read("Kxx", dtype=np.float64))
    r["j_store_a"] = a
    r["j_store_var"] = jcd.variances_from_cross_host(
        jf, js, inp["kzx_store"], inp["kzz_store"])
    np.savez(os.path.join(d, "inputs.npz"), **inp)
    r["inp"] = inp

    # classify_device_large, its posterior and a 2-device factor cache
    tr_x, tr_y, te_x, te_y = W.e2e_inputs()
    jm = _jpaper_small()
    _, info = jlarge(jm, tr_x, tr_y, (te_x, te_y), batch_size=32, block=32,
                     jitter=1e-4, variances=True, residual_sample_seed=0,
                     mesh=mesh8, verbose=False)
    r["j_large"] = info
    r["kzz_e2e"] = np.asarray(jm(te_x, diag=True), np.float64)
    jserving.save_posterior(os.path.join(d, "posterior"), train_x=tr_x,
                            alpha=info["alpha"], scalings=info["scalings"],
                            jitter_raw=info["jitter_raw"],
                            config_name="unit-test")
    jpred = jserving.GPPredictor(
        jm, jserving.load_posterior(os.path.join(d, "posterior.npz")),
        batch_size=32)
    jpred.prepare_variances(mesh=jmake_mesh(n_devices=2), block=32,
                            factor_cache=os.path.join(d, "jax_cache"))
    r["j_cache_var"] = jpred.variances(te_x)
    kxx = np.asarray(jgram(jm, tr_x, batch_size=32, progress=False),
                     np.float64)
    r["mean_diag_e2e"] = float(np.mean(np.diagonal(kxx)))

    tr_x, tr_y, te_x, te_y = W.edge_inputs()
    _, info = jlarge(_jmodel(), tr_x, tr_y, (te_x, te_y), batch_size=16,
                     block=8, jitter=1e-6, mesh=mesh8, verbose=False)
    r["j_edge_pred"] = info["predictions"][0]

    # IncrementalGP, retained mode, on the 8-device mesh
    jgp = JIncrementalGP(_jinc_model(), capacity=128, jitter=1e-6,
                         batch_size=16, block=16, mesh=mesh8)
    for step, (n, seed) in enumerate(W.INC_BATCHES):
        r[f"j_inc_ev{step}"] = jgp.add(*W.inc_data(n, seed))["log_evidence"]
    zx = W.inc_data(16, 9)[0]
    r["j_inc_alpha"], r["j_inc_pred"] = jgp._alpha, jgp.classify(zx)
    r["j_inc_var"] = jgp.variances(zx)
    x_all = np.concatenate([W.inc_data(n, s)[0] for n, s in W.INC_BATCHES])
    r["inc_mean_diag"] = float(np.mean(np.asarray(
        _jinc_model()(x_all, diag=True))))

    # ProbedNMLL with the seed the ranks use
    x, y = W.probed_inputs()
    jplan = jfit.ProbedNMLL(x, y, batch_size=16, block=16, mesh=mesh8,
                            tiles_per_call=4)
    v, g = jplan.value_and_grad(jax_conv_model(2.0, 1.0, learnable=True),
                                seed=3)
    r["j_probed_v"], r["j_probed_g"] = v, _jax_grads(g)
    r["j_fit_losses"] = jfit.fit_large(
        jax_conv_model(1.0, 0.5, learnable=True), x, y, steps=3,
        batch_size=16, grad="probed", probes=8, block=16, mesh=mesh8)[1]
    return r


def _one_rank_gloo():
    with reserved_port() as port:
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "RANK": "0", "WORLD_SIZE": "1"}
        with mock.patch.dict(os.environ, env):
            multihost.initialize(
                "env", device="cpu",
                timeout=datetime.timedelta(seconds=W.TIMEOUT_S))


@pytest.fixture(scope="module", params=WORLDS, ids=str)
def world(request, ref, tmp_path_factory):
    """(size, [each rank's results of ``_torch_dist_worker.chol_sharded``],
    the directory it wrote its factor cache to)."""
    out_dir = str(tmp_path_factory.mktemp(f"world_{request.param}"))
    for name in ("inputs.npz", "k.h5", "posterior.npz"):
        shutil.copy(os.path.join(ref["dir"], name), out_dir)
    shutil.copytree(os.path.join(ref["dir"], "jax_cache"),
                    os.path.join(out_dir, "jax_cache"))
    if request.param == 1:
        _one_rank_gloo()
        try:
            mesh = make_mesh(device="cpu")
            assert mesh.group is not None and mesh.size == 1
            return 1, [W.chol_sharded(mesh, out_dir)], out_dir
        finally:
            dist.destroy_process_group()
    return (request.param, W.run_world(request.param, "chol_sharded",
                                       out_dir), out_dir)


def _close(got, want, rtol, atol_scale):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def test_factor_matches_jax_and_lapack(world, ref):
    """(n, block) = (37, 8), (100, 16), (130, 32) and (64, 16): the
    gathered factor within rtol 1e-4, atol 1e-5 max|L| of JAX's on the
    8-device mesh and of LAPACK's.  n = 100 puts 56 rows on a rank of 2
    and 28 on a rank of 4: diagonal blocks of 16 straddle two ranks."""
    size, results, _ = world
    for res in results:
        for n, _ in W.FACTOR_CASES + ((64, 16),):
            want = np.linalg.cholesky(W.spd_chol(n, seed=n))
            _close(res[f"l_{n}"], want, 1e-4, 1e-5)
            _close(res[f"l_{n}"], ref[f"j_l_{n}"], 1e-4, 1e-5)
        assert bool(res["straddles_100"]) == (size > 1)


def test_factor_reads_only_lower_triangle(world):
    """tests/test_chol_dist.py's contract: zeros or NaN strictly above the
    diagonal change neither the factor (rtol 1e-4, atol 1e-5 max|L|) nor
    the solve (rtol 1e-3, atol 1e-4)."""
    for res in world[1]:
        for n, _ in W.FACTOR_CASES + ((64, 16),):
            k = W.spd_chol(n, seed=n)
            want = np.linalg.cholesky(k)
            want_a = np.linalg.solve(k, np.random.RandomState(n + 1)
                                     .randn(n, 3))
            for name in ("zeros", "nan"):
                _close(res[f"l_{n}_{name}"], want, 1e-4, 1e-5)
                np.testing.assert_allclose(res[f"solve_{n}_{name}"], want_a,
                                           rtol=1e-3, atol=1e-4)


def test_solve_sumsq_and_log_diag(world, ref):
    """Through one live factor: the solve and the whitened column sums of
    squares against LAPACK's float64, the log-diagonal sum against
    log det / 2."""
    k = W.spd_chol(100, seed=100)
    lk = np.linalg.cholesky(k)
    inp = ref["inp"]
    want_sumsq = np.sum(np.linalg.solve(lk, inp["w_100"]) ** 2, axis=0)
    for res in world[1]:
        np.testing.assert_allclose(res["f_solve"],
                                   np.linalg.solve(k, inp["rhs_100"]),
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(res["f_sumsq"], want_sumsq, rtol=1e-4)
        assert abs(float(res["f_logdiag"])
                   - np.sum(np.log(np.diagonal(lk)))) < 1e-4


def test_extend_across_ranks_and_refusal(world, ref):
    """Rows [50, 80) added onto 50 (block 16: on 2 and 4 ranks the new
    rows cross a rank boundary): the factor of the whole system within
    the factor tolerances of LAPACK's and JAX's extended factor, the diag
    stack equal to the buffer's diagonal blocks, the solve JAX's; then an
    extension by copies of existing rows is refused on every rank with
    the factor, the diag stack and n left bit for bit."""
    e = W.EXT
    n1 = e["n0"] + e["m"]
    k = W.spd_chol(e["n"], seed=e["seed"]).astype(np.float32)
    want = np.linalg.cholesky(k[:n1, :n1].astype(np.float64))
    bs = e["block"]
    for res in world[1]:
        got = res["ext_l"]
        _close(got[:n1, :n1], want, 1e-4, 1e-5)
        _close(got[:n1, :n1], ref["j_ext_l"], 1e-4, 1e-5)
        n_pad = got.shape[0]
        np.testing.assert_array_equal(got[n1:, n1:], np.eye(n_pad - n1))
        blocks = np.stack([got[i:i + bs, i:i + bs]
                           for i in range(0, n_pad, bs)])
        np.testing.assert_array_equal(res["ext_diags"], blocks)
        np.testing.assert_allclose(res["ext_solve"], ref["j_ext_solve"],
                                   rtol=1e-3, atol=1e-4)
        assert bool(res["ext_refused"]) and bool(res["ext_unchanged"])


def test_refined_solvers_float64_parity(world, ref):
    """chol_solve_dist (rank 0's matrix alone) matches float64 LAPACK to
    1e-8 relative, as tests/test_chol_dist.py asks, and JAX's; the
    float32-input chol_solve_ir32 matches JAX's, with its variances and
    evidence through the live sharded factor against JAX's and the
    float64 oracle."""
    k, y = W.spd_chol(120, seed=5), jsolve.one_hot_targets(
        np.arange(120) % 10)
    want = np.linalg.solve(k, y)
    inp = ref["inp"]
    k64 = inp["k_store"].astype(np.float64)
    jr = float(inp["jr_store"])
    kzz = inp["kzz_store"]
    want_var = jsolve.predictive_variance(k64, inp["kzx_store"], kzz,
                                          jitter=jr)
    want_ev = jsolve.log_marginal_likelihood(k64 + jr * np.eye(70),
                                             inp["y_store"])
    for res in world[1]:
        rel, _ = res["cd_rel_it"]
        assert rel < 1e-10, rel
        np.testing.assert_allclose(res["cd_a"], want, rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max())
        np.testing.assert_allclose(res["cd_a"], ref["j_cd_a"], rtol=1e-8,
                                   atol=1e-10 * np.abs(want).max())
        assert res["ir_rel_it"][0] < 1e-10
        amax = np.abs(ref["j_ir_a"]).max()
        np.testing.assert_allclose(res["ir_a"], ref["j_ir_a"], rtol=1e-7,
                                   atol=1e-9 * amax)
        np.testing.assert_array_equal(res["ir_s"], ref["j_ir_s"])
        scale = float(kzz.mean())
        assert (res["ir_var"] >= 0).all()
        assert np.abs(res["ir_var"] - want_var).max() < 1e-5 * scale
        assert np.abs(res["ir_var"] - ref["j_ir_var"]).max() < 1e-5 * scale
        np.testing.assert_allclose(float(res["ir_ev"]), want_ev, rtol=5e-4)
        np.testing.assert_allclose(float(res["ir_ev"]), ref["j_ir_ev"],
                                   rtol=5e-4)


@pytest.mark.parametrize("path", ["stream", "serial"])
def test_store_solvers_on_jax_store(world, ref, path):
    """Both store solvers on the JAX package's HDF5 store, rank 0 alone
    reading it: the scipy oracle's and JAX's solutions, and the variances
    of JAX's live factor (tests/test_torch_chol_dist.py's bounds)."""
    inp = ref["inp"]
    want = jsolve.solve_gp(ref["k_store64"].copy(), inp["y_store"],
                           jitter=1e-6, method="scipy")
    amax = np.abs(want).max()
    for res in world[1]:
        assert float(res[f"store_{path}_rel"]) < 1e-10
        a = res[f"store_{path}_a"]
        np.testing.assert_allclose(a, want, rtol=1e-6, atol=1e-8 * amax)
        np.testing.assert_allclose(a, ref["j_store_a"], rtol=1e-7,
                                   atol=1e-9 * amax)
        np.testing.assert_allclose(res[f"store_{path}_var"],
                                   ref["j_store_var"], rtol=2e-4,
                                   atol=1e-5 * float(inp["kzz_store"]
                                                     .mean()))


def _check_variances(got, want, kzz):
    """The bound of tests/test_device_pipeline.py."""
    atol = VAR_ATOL * float(np.mean(kzz))
    assert got.shape == want.shape and (got >= 0).all()
    assert not (np.abs(got - want) > atol + VAR_RTOL * np.abs(want)).any()


def test_classify_device_large(world, ref):
    """classify_device_large(mesh=) against JAX's on the 8-device mesh:
    equal predictions, evidence within rtol 5e-4, variances within the
    JAX tests' bound; the padding-edge case of tests/test_device_large.py
    (n = 37, tile 16, block 8) predicts as JAX does, its n_pad a multiple
    of the tile, the block and the rank count."""
    size, results, _ = world
    j = ref["j_large"]
    for res in results:
        np.testing.assert_array_equal(res["large_pred"], j["predictions"][0])
        assert float(res["large_rel"]) < 1e-4
        np.testing.assert_allclose(float(res["large_ev"]),
                                   j["log_evidence"], rtol=EVIDENCE_RTOL)
        _check_variances(res["large_var"], j["variances"][0],
                         ref["kzz_e2e"])
        np.testing.assert_array_equal(res["edge_pred"], ref["j_edge_pred"])
        assert float(res["edge_rel"]) < 1e-4
        n_pad = int(res["edge_n_pad"])
        assert n_pad % 16 == 0 and n_pad % 8 == 0 and n_pad % size == 0


def test_factor_cache_crosses_packages(world, ref):
    """JAX's cache, written on a 2-device mesh, loads in the 2-rank world
    (and is refused by the others for its n_devices) and serves JAX's
    variances; the cache the ranks write loads again bit for bit, and in
    JAX on a mesh of as many devices, serving the same variances
    (within 1e-5 of the mean Gram diagonal, tests/test_torch_serving.py's
    bound)."""
    size, results, out_dir = world
    tol = 1e-5 * ref["mean_diag_e2e"]
    for res in results:
        if size == 2:
            assert np.abs(res["jax_cache_var"]
                          - ref["j_cache_var"]).max() < tol
        else:
            assert bool(res["jax_cache_refused"])
        np.testing.assert_array_equal(res["cache_loaded_var"],
                                      res["cache_written_var"])
    from cnn_gp_tpu.parallel import device_large as jdl
    jpred = jserving.GPPredictor(
        _jpaper_small(), jserving.load_posterior(
            os.path.join(out_dir, "posterior.npz")), batch_size=32)
    with mock.patch.object(jdl, "rebuild_factor",
                           side_effect=AssertionError("rebuilt")):
        jpred.prepare_variances(mesh=jmake_mesh(n_devices=size), block=32,
                                factor_cache=os.path.join(out_dir,
                                                          "port_cache"))
    got = jpred.variances(W.e2e_inputs()[2])
    assert np.abs(got - results[0]["cache_written_var"]).max() < tol


def test_incremental_gp(world, ref):
    """IncrementalGP(mesh=) in retained mode against JAX's on the 8-device
    mesh after each of three batches (48, 20, 33): evidence within 1e-4,
    equal predictions, alpha within 1e-4 of solution scale, variances
    within 1e-5 of the mean diagonal; regen mode predicts as retained
    mode, its alpha within 1e-4; the posterior rank 0 saves is read back
    whole by every rank."""
    tol = 1e-5 * ref["inc_mean_diag"]
    for res in world[1]:
        for step in range(3):
            jev = ref[f"j_inc_ev{step}"]
            for mode in ("retained", "regen"):
                assert abs(float(res[f"inc_{mode}_ev{step}"]) - jev) < (
                    1e-4 * abs(jev))
            assert float(res[f"inc_retained_rel{step}"]) < 1e-10
        scale = np.abs(ref["j_inc_alpha"]).max()
        for mode in ("retained", "regen"):
            assert np.abs(res[f"inc_{mode}_alpha"]
                          - ref["j_inc_alpha"]).max() < 1e-4 * scale
            np.testing.assert_array_equal(res[f"inc_{mode}_pred"],
                                          ref["j_inc_pred"])
            assert bool(res[f"inc_{mode}_saved"])
            assert np.abs(res[f"inc_{mode}_var"]
                          - ref["j_inc_var"]).max() < tol


def test_probed_nmll(world, ref):
    """ProbedNMLL(mesh=) with JAX's seed: the same Rademacher probes, the
    value within 1e-4 and the gradient within 3e-3 of JAX's
    (tests/test_torch_fit_probed.py's bounds)."""
    want_v, want_g = ref["j_probed_v"], ref["j_probed_g"]
    for res in world[1]:
        v = float(res["probed_v"])
        assert abs(v - want_v) < 1e-4 * abs(want_v), (v, want_v)
        got = dict(zip(res["probed_keys"], res["probed_g"]))
        assert set(got) == set(want_g)
        for k, w in want_g.items():
            assert abs(got[k] - w) < 3e-3 * max(abs(w), 1e-3), (k, got[k], w)


def test_fit_large_probed(world, ref):
    """Three fit_large(grad="probed", mesh=) steps: the loss per step
    within 1e-3 of JAX's (tests/test_torch_fit_probed.py's bound)."""
    for res in world[1]:
        np.testing.assert_allclose(res["fit_losses"], ref["j_fit_losses"],
                                   rtol=1e-3)


def test_every_rank_returns_the_same_bits(world):
    size, results, _ = world
    assert len(results) == size
    for res in results[1:]:
        assert res.keys() == results[0].keys()
        for key, val in results[0].items():
            np.testing.assert_array_equal(res[key], val, err_msg=key)


# -- in this process only ---------------------------------------------------

def test_sharded_entry_points_take_the_mesh_device():
    """A mesh selects the sharded factor on its device; a device that is
    not the mesh's is refused, and no device or mesh is a TypeError."""
    from cnn_gp_tpu_torch.parallel.chol_dist import (CardFactor,
                                                     ShardedFactor,
                                                     _factor_for)
    mesh = make_mesh(device="cpu")
    assert isinstance(_factor_for(10, 4, None, mesh), ShardedFactor)
    assert isinstance(_factor_for(10, 4, "cpu", None), CardFactor)
    with pytest.raises(ValueError, match="not the mesh's"):
        _factor_for(10, 4, "meta", mesh)
    with pytest.raises(TypeError, match="device="):
        _factor_for(10, 4, None, None)


def test_failed_diagonal_block_raises():
    """A matrix that is not positive-definite raises LinAlgError naming the
    failed block, as CardFactor does."""
    from cnn_gp_tpu_torch.parallel.chol_dist import ShardedFactor
    k = W.spd_chol(40, seed=2)
    k[20, 20] = -1.0
    f = ShardedFactor(make_mesh(device="cpu"), 40, 8)
    with pytest.raises(np.linalg.LinAlgError, match="diagonal block 2"):
        f.factorize(k.astype(np.float32))

"""Worlds of ranks for the port's multi-rank tests, on the CPU with gloo.

``run_world(size, job, out_dir)`` starts ``size`` spawned processes that
join one gloo group through ``multihost.initialize``
(``127.0.0.1:<reserved port>``, a 60 s timeout),
run ``job(mesh, out_dir)`` from this module on each rank and leave the
group; each rank saves what it computed to ``out_dir/rank<r>.npz``.  A
world that does not end within its limit is killed and fails its test.
The children import the port only, never jax.

``launch(procs, log_dir, env=...)`` runs command-line groups (a driver's
ranks, each its own process given ``--coordinator_address``) and, when
one fails, reports every process's group, rank, return code, time-out
and the tail of its output.  Every rendezvous port of these tests is an
``entry.reserved_port``, held by the test until its group has ended.
"""

import contextlib
import datetime
import io
import os
import subprocess
import time

import numpy as np

TIMEOUT_S = 60      # init_process_group and every collective
JOIN_S = 150        # the whole world
TAIL_LINES = 60     # of each process's output in a failure report
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(procs, log_dir, *, env, limit_s=JOIN_S):
    """Run every ``(group, rank, argv)`` of ``procs`` at once from the
    repo's root and wait for all of them, within ``limit_s`` seconds in
    all; the first that fails ends the others.  Each writes its output
    to its own file in ``log_dir`` (no pipe that could fill while the
    test waits on another process).  Returns each one's output, in
    order.  Raises AssertionError when any failed or outlasted the
    limit, reporting every process: its group and rank, its return
    code, whether it was killed (at the limit, or after another failed)
    and the last TAIL_LINES lines of its output."""
    runs, deadline = [], time.monotonic() + limit_s
    try:
        for group, rank, argv in procs:
            path = os.path.join(log_dir, f"{group}.rank{rank}.log")
            with open(path, "w") as out:
                runs.append((group, rank, path, subprocess.Popen(
                    argv, cwd=REPO, env=env, stdout=out,
                    stderr=subprocess.STDOUT)))
        while any(p.poll() is None for *_, p in runs):
            if any(p.returncode not in (None, 0) for *_, p in runs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        timed_out = time.monotonic() > deadline
        killed = set()
        for i, (*_, p) in enumerate(runs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(i)
    outs = []
    for _, _, path, _ in runs:
        with open(path) as f:
            outs.append(f.read())
    if killed or any(p.returncode != 0 for *_, p in runs):
        report = []
        for i, ((group, rank, _, p), out) in enumerate(zip(runs, outs)):
            state = (f"return code {p.returncode}" if i not in killed else
                     f"killed at the {limit_s} s limit" if timed_out else
                     "killed after another process failed")
            tail = "\n".join(out.splitlines()[-TAIL_LINES:])
            report.append(f"--- group {group}, rank {rank}: {state}; the "
                          f"last {TAIL_LINES} lines of its output:\n{tail}")
        raise AssertionError(f"{len(runs)} processes, "
                             f"{len(killed)} killed:\n" + "\n".join(report))
    return outs


def _child(rank, size, port, job_name, out_dir):
    import torch
    import torch.distributed as dist
    from cnn_gp_tpu_torch.parallel import make_mesh, multihost
    torch.set_num_threads(1)
    dev = multihost.initialize(
        f"127.0.0.1:{port}", size, rank, device="cpu",
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
        assert multihost.worker_identity() == (rank, size)
        mesh = make_mesh(size, device="cpu")
        res = globals()[job_name](mesh, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_world(size, job_name, out_dir):
    """Run ``job_name`` on a gloo world of ``size`` ranks; return each
    rank's saved arrays.  A rank that fails, or a world that outlasts
    JOIN_S, fails the call (``entry.spawn_ranks``)."""
    from cnn_gp_tpu_torch.entry import spawn_ranks
    spawn_ranks(size, _child, job_name, out_dir, limit_s=JOIN_S)
    out = []
    for r in range(size):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            out.append(dict(f))
    return out


# -- the jobs ---------------------------------------------------------------

def _model():
    from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
    return Sequential(Conv2d(3), ReLU(), Conv2d(7, padding=0))


def paper_small():
    from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
    return Sequential(
        Conv2d(7, var_weight=2.79 * 49, var_bias=7.86), ReLU(),
        Conv2d(14, padding=0, var_weight=2.79, var_bias=7.86))


def gram_inputs():
    """The inputs of tests/test_sharded.py: symmetric 53 (not a multiple
    of the tile times any rank count used), cross 23 x 31, resume 33."""
    from cnn_gp_tpu_torch.data import synthetic_arrays
    x = synthetic_arrays(n_train=53, n_test=0, shape=(1, 7, 7))[0]
    xc = synthetic_arrays(n_train=23, n_test=0, shape=(1, 7, 7))[0]
    zc = synthetic_arrays(n_train=31, n_test=0, shape=(1, 7, 7), seed=9)[0]
    xr = synthetic_arrays(n_train=33, n_test=0, shape=(1, 7, 7))[0]
    return x, xc, zc, xr


def spd(n, seed=0):
    r = np.random.RandomState(seed)
    a = r.randn(n, n).astype(np.float64)
    return a @ a.T + n * np.eye(n)


def e2e_inputs():
    from cnn_gp_tpu_torch.data import synthetic_arrays
    return synthetic_arrays(n_train=96, n_test=32, shape=(1, 14, 14),
                            seed=4)


class _Untouchable:
    """A store that fails on any use: what ranks other than 0 hold."""

    def __getattr__(self, name):
        raise AssertionError(f"rank other than 0 touched its store "
                             f"({name})")


class _Counts:
    """Counts tiles computed and dataset uploads inside a ``with``."""

    def __enter__(self):
        from cnn_gp_tpu_torch.parallel import gram
        self.gram, self.tiles, self.uploads = gram, 0, 0
        self._tile, self._up = gram._tile_body, gram._on_device

        def tile(*a, **k):
            self.tiles += 1
            return self._tile(*a, **k)

        def up(*a, **k):
            self.uploads += 1
            return self._up(*a, **k)

        gram._tile_body, gram._on_device = tile, up
        return self

    def __exit__(self, *exc):
        self.gram._tile_body, self.gram._on_device = self._tile, self._up


def sharded(mesh, out_dir):
    """Every check of tests/test_torch_sharded.py that runs on ranks:
    the Grams, the store resume, the CG solves and the end-to-end
    classification."""
    from cnn_gp_tpu_torch.data import GramStore
    from cnn_gp_tpu_torch.ops import solve
    from cnn_gp_tpu_torch.parallel import (cg_solve_sharded,
                                           compute_gram_sharded)
    res = {}
    model = _model()
    x, xc, zc, xr = gram_inputs()
    res["sym"] = compute_gram_sharded(model, x, batch_size=10, mesh=mesh,
                                      tiles_per_round_per_device=2,
                                      progress=False)
    res["cross"] = compute_gram_sharded(model, xc, zc, batch_size=10,
                                        mesh=mesh, progress=False)

    path = os.path.join(out_dir, "sharded.h5")
    store = GramStore(path, "w") if mesh.rank == 0 else _Untouchable()
    try:
        with _Counts() as c:
            first = compute_gram_sharded(model, xr, batch_size=10,
                                         mesh=mesh, store=store, name="Kxx",
                                         progress=False)
        res["first_tiles"], res["first_uploads"] = c.tiles, c.uploads
        res["first_out_none"] = first is None
        if mesh.rank == 0:
            store.assert_complete("Kxx", upper_triangle_only=True)
        resumed = np.full((33, 33), np.nan, np.float32)
        # rank 0 broadcasts the stored values 7 rows at a time: five
        # blocks, the last one short
        from cnn_gp_tpu_torch.parallel import gram_sharded
        entries, gram_sharded._BACKFILL_ENTRIES = (
            gram_sharded._BACKFILL_ENTRIES, 7 * 33)
        try:
            with _Counts() as c:
                compute_gram_sharded(model, xr, batch_size=10, mesh=mesh,
                                     store=store, name="Kxx", out=resumed,
                                     progress=False)
        finally:
            gram_sharded._BACKFILL_ENTRIES = entries
        res["resume_tiles"], res["resume_uploads"] = c.tiles, c.uploads
        res["resumed"] = resumed
    finally:
        if mesh.rank == 0:
            store.close()

    y100 = solve.one_hot_targets(np.arange(100) % 10)
    res["cg100"], rel, it = cg_solve_sharded(spd(100), y100, jitter=0.1,
                                             mesh=mesh, tol=1e-6,
                                             maxiter=1000)
    res["cg100_rel_it"] = np.array([rel, it])
    y37 = solve.one_hot_targets(np.arange(37) % 10)
    res["cg37"], rel, it = cg_solve_sharded(spd(37, seed=1), y37,
                                            mesh=mesh, tol=1e-7,
                                            maxiter=500)
    res["cg37_rel_it"] = np.array([rel, it])

    tr_x, tr_y, te_x, te_y = e2e_inputs()
    model = paper_small()
    kxx = compute_gram_sharded(model, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
    kzx = compute_gram_sharded(model, te_x, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
    s = np.sqrt(np.diagonal(kxx).mean())
    a, rel, it = cg_solve_sharded(kxx / s ** 2, solve.one_hot_targets(tr_y),
                                  jitter=1e-8, mesh=mesh, tol=1e-6,
                                  maxiter=2000)
    res["e2e_kxx"], res["e2e_kzx"] = kxx, kzx
    res["e2e_pred"] = solve.predict(kzx / s ** 2, a)
    res["e2e_rel_it"] = np.array([rel, it])
    return res


# -- the row-sharded factor (tests/test_torch_chol_sharded.py) --------------

FACTOR_CASES = ((37, 8), (100, 16), (130, 32))
EXT = dict(n=100, seed=11, n0=50, m=30, block=16)   # new rows cross ranks
INC_BATCHES = ((48, 0), (20, 1), (33, 2))


def spd_chol(n, seed=0):
    """The SPD test matrices of tests/test_chol_dist.py."""
    r = np.random.RandomState(seed)
    a = r.randn(n, n)
    return a @ a.T / n + np.eye(n)


def inc_data(n, seed):
    """tests/test_incremental.py's batches."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, 8, 8).astype(np.float32),
            rng.randint(0, 4, size=n))


def inc_model():
    from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
    return Sequential(Conv2d(3), ReLU(), Conv2d(3), ReLU(),
                      Conv2d(8, padding=0))


def edge_inputs():
    """tests/test_device_large.py's padding-edge case: n = 37, tile 16,
    block 8."""
    from cnn_gp_tpu_torch.data import synthetic_arrays
    return synthetic_arrays(n_train=37, n_test=9, shape=(1, 7, 7), seed=3)


def probed_inputs():
    """tests/test_torch_fit_probed.py's problem: n = 37 at 14 x 14."""
    from cnn_gp_tpu_torch.data import synthetic_arrays
    from cnn_gp_tpu_torch.ops import solve
    x, labels, _, _ = synthetic_arrays(n_train=37, n_test=0,
                                       shape=(1, 14, 14), seed=5)
    return x, solve.one_hot_targets(labels).astype(np.float32)


def chol_sharded(mesh, out_dir):
    """Every check of tests/test_torch_chol_sharded.py that runs on ranks:
    the factor, its solves and extension, the solvers, the store solvers,
    classify_device_large, the factor cache, IncrementalGP and ProbedNMLL,
    with ``mesh``.  Inputs the JAX package wrote (an HDF5 store, a
    posterior, a factor cache) and the numpy inputs are in ``out_dir``."""
    import torch
    from cnn_gp_tpu_torch.data import GramStore
    from cnn_gp_tpu_torch.fit import ProbedNMLL, fit_large
    from cnn_gp_tpu_torch.ops import solve
    from cnn_gp_tpu_torch.parallel import (IncrementalGP,
                                           classify_device_large)
    from cnn_gp_tpu_torch.parallel import chol_dist as cd
    from cnn_gp_tpu_torch.scripts.fit_hyperparams import make_model
    from cnn_gp_tpu_torch.serving import GPPredictor, load_posterior
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    root = mesh.rank == 0
    res = {}

    # the factor: gathered, with zeros and NaN above the diagonal
    for n, block in FACTOR_CASES + ((64, 16),):
        k = spd_chol(n, seed=n)
        f = cd.ShardedFactor(mesh, n, block)
        res[f"straddles_{n}"] = np.array(f.rows_local % block != 0)
        res[f"l_{n}"] = cd.cholesky_sharded(k, mesh, block=block)
        for name, fill in (("zeros", 0.0), ("nan", np.nan)):
            klow = np.tril(k) + np.triu(np.full_like(k, fill), 1)
            res[f"l_{n}_{name}"] = cd.cholesky_sharded(klow, mesh,
                                                       block=block)
            res[f"solve_{n}_{name}"] = cd.cholesky_solve_sharded(
                klow, inp[f"rhs_{n}"], mesh, block=block)

    # solve, forward_sumsq and log_diag_sum through one live factor
    k = spd_chol(100, seed=100)
    f = cd.ShardedFactor(mesh, 100, 16)
    f.factorize(k.astype(np.float32))
    res["f_solve"] = f.solve(inp["rhs_100"])
    res["f_sumsq"] = f.forward_sumsq(torch.from_numpy(
        inp["w_100"])).numpy()
    res["f_logdiag"] = np.array(f.log_diag_sum())

    # extend across a rank boundary, then a refused non-PD extension
    e = EXT
    k = spd_chol(e["n"], seed=e["seed"]).astype(np.float32)
    n0, m = e["n0"], e["m"]
    f = cd.ShardedFactor(mesh, n0, e["block"], capacity=e["n"])
    f.factorize(k[:n0, :n0])
    f.extend(k[n0:n0 + m, :n0], k[n0:n0 + m, n0:n0 + m])
    res["ext_l"] = f.gather().numpy()
    res["ext_diags"] = f.diags.numpy()
    res["ext_solve"] = f.solve(inp["rhs_ext"])
    n1 = n0 + m
    before = (f.l_loc.clone(), f.diags.clone(), f.n)
    try:   # rows equal to the first ones: a singular Schur complement
        f.extend(k[:4, :n1], k[:4, :4])
        res["ext_refused"] = np.array(False)
    except ValueError:
        res["ext_refused"] = np.array(True)
    res["ext_unchanged"] = np.array(
        torch.equal(before[0], f.l_loc) and torch.equal(before[1], f.diags)
        and before[2] == f.n)

    # the float64-refined solvers: rank 0's matrix only
    k, y = spd_chol(120, seed=5), solve.one_hot_targets(np.arange(120) % 10)
    a, rel, it = cd.chol_solve_dist(k.copy() if root else None, y,
                                    mesh=mesh, block=16)
    res["cd_a"], res["cd_rel_it"] = a, np.array([rel, it])
    k32 = inp["k_store"]
    a, rel, it, fac, s = cd.chol_solve_ir32(
        k32 if root else None, inp["y_store"], jitter=inp["jr_store"],
        block=16, mesh=mesh, return_factor=True)
    res["ir_a"], res["ir_rel_it"], res["ir_s"] = a, np.array([rel, it]), s
    res["ir_var"] = cd.variances_from_cross_host(
        fac, s, inp["kzx_store"] if root else None,
        inp["kzz_store"] if root else None, chunk=5)
    res["ir_ev"] = np.array(cd.evidence_from_factor(fac, s, inp["y_store"],
                                                    a))
    del fac

    # the store solvers on the JAX package's HDF5 store: rank 0 alone
    path = os.path.join(out_dir, "k.h5")
    store = GramStore(path, "r") if root else _Untouchable()
    try:
        for name, fn, kw in (
                ("stream", cd.chol_solve_stream_from_store, {"io_rows": 32}),
                ("serial", cd.chol_solve_dist_from_store,
                 {"check_finite": True})):
            a, rel, _, fac, s = fn(store, "Kxx", inp["y_store"],
                                   jitter=1e-6, block=16, mesh=mesh,
                                   return_factor=True, **kw)
            res[f"store_{name}_a"], res[f"store_{name}_rel"] = a, rel
            res[f"store_{name}_var"] = cd.variances_from_cross_host(
                fac, s, inp["kzx_store"] if root else None,
                inp["kzz_store"] if root else None)
            del fac
    finally:
        if root:
            store.close()

    # classify_device_large: the end-to-end data and the padding edge
    tr_x, tr_y, te_x, te_y = e2e_inputs()
    accs, info = classify_device_large(
        paper_small(), tr_x, tr_y, (te_x, te_y), batch_size=32, block=32,
        jitter=1e-4, variances=True, residual_sample_seed=0, verbose=False,
        mesh=mesh)
    res["large_pred"] = info["predictions"][0]
    res["large_var"] = info["variances"][0]
    res["large_ev"] = np.array(info["log_evidence"])
    res["large_rel"] = np.array(info["rel_residual"])
    tr_x, tr_y, te_x, te_y = edge_inputs()
    _, info = classify_device_large(
        _model(), tr_x, tr_y, (te_x, te_y), batch_size=16, block=8,
        jitter=1e-6, verbose=False, mesh=mesh)
    res["edge_pred"] = info["predictions"][0]
    res["edge_rel"] = np.array(info["rel_residual"])
    res["edge_n_pad"] = np.array(info["n_pad"])
    res["edge_seed"] = np.array(info["residual_sample_seed"])

    # the factor cache: JAX's (written on 2 devices), then the port's own
    post = load_posterior(os.path.join(out_dir, "posterior.npz"))
    zx = e2e_inputs()[2]

    def predictor():
        return GPPredictor(paper_small(), post, batch_size=32,
                           device=mesh.device)

    pred = predictor()
    try:
        pred.prepare_variances(block=32, mesh=mesh, write_cache=False,
                               factor_cache=os.path.join(out_dir,
                                                         "jax_cache"))
        res["jax_cache_var"] = pred.variances(zx)
    except ValueError as err:
        res["jax_cache_refused"] = np.array("n_devices" in str(err))
    cache = os.path.join(out_dir, "port_cache")
    pred = predictor()
    pred.prepare_variances(block=32, mesh=mesh, factor_cache=cache)
    res["cache_written_var"] = pred.variances(zx)
    pred = predictor()
    pred.prepare_variances(block=32, mesh=mesh, factor_cache=cache)
    res["cache_loaded_var"] = pred.variances(zx)

    # IncrementalGP, retained mode (and regen against it), three batches
    zx = inc_data(16, 9)[0]
    for mode, retain in (("retained", True), ("regen", False)):
        gp = IncrementalGP(inc_model(), capacity=128, jitter=1e-6,
                           retain_gram=retain, batch_size=16, block=16,
                           mesh=mesh)
        for step, (n, seed) in enumerate(INC_BATCHES):
            info = gp.add(*inc_data(n, seed))
            res[f"inc_{mode}_ev{step}"] = np.array(info["log_evidence"])
            res[f"inc_{mode}_rel{step}"] = np.array(info["rel_residual"])
        res[f"inc_{mode}_alpha"] = gp._alpha
        res[f"inc_{mode}_pred"] = gp.classify(zx)
        res[f"inc_{mode}_var"] = gp.variances(zx)
        # rank 0 writes the posterior; every rank reads it back whole
        path = gp.save_posterior(os.path.join(out_dir, f"inc_{mode}"))
        res[f"inc_{mode}_saved"] = np.array(np.array_equal(
            load_posterior(path).alpha, gp._alpha))

    # ProbedNMLL: value and gradient with JAX's seed
    x, y = probed_inputs()
    plan = ProbedNMLL(x, y, batch_size=16, block=16, mesh=mesh)
    v, g = plan.value_and_grad(make_model(2.0, 1.0, learnable=True), seed=3)
    res["probed_v"] = np.array(v)
    res["probed_keys"] = np.array(sorted(g))
    res["probed_g"] = np.array([np.asarray(g[key]).item()
                                for key in sorted(g)])
    # and three probed fit_large steps (the step guard agreed)
    _, res["fit_losses"] = fit_large(
        make_model(1.0, 0.5, learnable=True), x, y, steps=3, batch_size=16,
        grad="probed", probes=8, block=16, mesh=mesh)
    return res


# -- the dry run (tests/test_torch_entry.py) --------------------------------

def dryrun(mesh, out_dir):
    """``entry.dryrun_multichip`` as this rank of the running group: what
    its sequence computed on this rank."""
    from cnn_gp_tpu_torch import entry
    got = {}
    body = entry._dryrun_rank

    def record(*a, **k):
        got.update(body(*a, **k))
        return got

    entry._dryrun_rank = record
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert entry.dryrun_multichip(mesh.size, device="cpu") is None
    finally:
        entry._dryrun_rank = body
    got["summary"] = out.getvalue()
    return {k: np.asarray(v) for k, v in got.items()}


def failing_rank(rank, size, port):
    """A rank for ``entry.spawn_ranks``: rank 1 fails at once, the others
    wait as if in a collective that never completes."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    time.sleep(JOIN_S)


def ping(mesh, out_dir):
    """A world's least work: the sum of every rank's ``rank + 1`` over
    the group, and this rank's identity."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(mesh.rank + 1)])
    dist.all_reduce(t)
    return {"sum": t.numpy(), "rank": np.array(mesh.rank),
            "size": np.array(mesh.size)}


# -- concurrent creators of one Zarr store (tests/test_torch_store_race.py)

def race_creates(rank, root, n_stores, barrier, errors):
    """Create save_kernel's three datasets in each of ``n_stores`` fresh
    Zarr stores under ``root``, each one after ``barrier`` (the other
    process does the same at the same moment, as two ranks do after
    their rendezvous); put this rank's exception messages on
    ``errors``."""
    from cnn_gp_tpu_torch.data import TensorStoreGramStore
    got = []
    for k in range(n_stores):
        barrier.wait()
        try:
            with TensorStoreGramStore(os.path.join(root, f"s{k}")) as s:
                s.create("Kxx", 96, None, 32)
                s.create("Kxvx", 32, 96, 32)
                s.create("Kxtx", 32, 96, 32)
        except Exception as err:   # noqa: BLE001  (reported by the test)
            got.append(f"rank {rank}, store {k}: {type(err).__name__}: "
                       f"{err}")
    errors.put(got)

"""Worlds of ranks for the port's multi-rank tests, on the CPU with gloo.

``run_world(size, job, out_dir)`` starts ``size`` spawned processes that
join one gloo group through ``multihost.initialize``
(``127.0.0.1:<free port>``, a 60 s timeout),
run ``job(mesh, out_dir)`` from this module on each rank and leave the
group; each rank saves what it computed to ``out_dir/rank<r>.npz``.  A
world that does not end within its limit is killed and fails its test.
The children import the port only, never jax.
"""

import datetime
import multiprocessing
import os
import socket
import time

import numpy as np

TIMEOUT_S = 60      # init_process_group and every collective
JOIN_S = 150        # the whole world


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    rank's saved arrays."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, size, port, job_name, out_dir))
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"{len(hung)} rank(s) of {size} hung"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * size, f"rank exit codes {codes}"
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

"""Entry points: the flagship forward and the multi-rank dry run.

PyTorch counterpart of the JAX package's ``__graft_entry__.py``.
``entry()`` returns the flagship forward step, one ``mnist_as_tf``
ResNet-32 Gram tile with the global-index diagonal mask, and its example
arguments; ``dryrun_multichip(n)`` runs one whole sharded pipeline step of
the paper ConvNet GP on ``n`` ranks at tiny shapes.  Both run on the card
unless the caller passes ``device="cpu"``.

    python -m cnn_gp_tpu_torch.entry                  # the forward, card
    python -m cnn_gp_tpu_torch.entry multichip 1      # the dry run, 1 rank
    python -m cnn_gp_tpu_torch.entry multichip 2 --device=cpu   # gloo

The eager call is the forward: JAX's ``jax.jit`` has no counterpart here.
The dry run does not move to the CPU when cards are missing: asking for
more cards than the host has raises.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import multiprocessing
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from . import Conv2d, ReLU, Sequential, configs, settings
from .data import synthetic_arrays
from .fit import fit_large
from .kernels import apply_kernel
from .ops import solve
from .parallel import (IncrementalGP, cg_solve_sharded,
                       classify_device_large, compute_gram_sharded,
                       make_mesh, multihost)
from .parallel.chol_dist import chol_solve_dist
from .utils import resolve_device

__all__ = ["entry", "dryrun_multichip", "main"]

RANK_TIMEOUT_S = 600    # init_process_group and every collective of a rank


def entry(device="cuda"):
    """``(forward, example_args)`` for the flagship forward step.

    The forward step is one Gram tile of the ``mnist_as_tf`` ResNet-32
    NNGP: two image batches in, one covariance block out, with the
    global-index diagonal mask unifying diagonal and off-diagonal tiles.
    ``example_args`` are the JAX entry's inputs (the same bits) as float32
    tensors on ``device``, with the offsets 0 and 8."""
    dev = resolve_device(str(device))
    settings.disable_tf32()
    model = configs.load("mnist_as_tf").initial_model

    def forward(x, z, row_offset, col_offset):
        b = x.shape[0]
        rows = row_offset + torch.arange(b, device=x.device)
        cols = col_offset + torch.arange(b, device=x.device)
        mask = rows[:, None] == cols[None, :]
        with torch.no_grad():
            return apply_kernel(model, x, z, False, False, mask)

    rng = np.random.RandomState(0)
    x = rng.rand(8, 1, 28, 28).astype(np.float32)
    z = rng.rand(8, 1, 28, 28).astype(np.float32)
    return forward, (torch.from_numpy(x).to(dev), torch.from_numpy(z).to(dev),
                     0, 8)


@contextlib.contextmanager
def reserved_port():
    """A free port on 127.0.0.1, held for a local world's rendezvous
    until the ``with`` block ends.

    The port is bound here with ``SO_REUSEADDR`` and never listened on.
    While it is held, the kernel gives it to no other socket (a bind to
    port 0 and an outgoing connection both skip it), and an explicit
    bind without ``SO_REUSEADDR`` fails; rank 0's TCPStore, which binds
    with ``SO_REUSEADDR``, can still listen on it.  A port that is only
    probed and closed can be taken by another process in the seconds
    before rank 0 binds it, and then a rank fails or joins the wrong
    world."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded pipeline step on ``n_devices`` ranks, tiny shapes.

    Exercises the rank group end to end on a PAPER config kernel
    (``mnist_paper_convnet_gp``, Gram values ~1e12): the tile sweep dealt
    over the ranks, both distributed solvers (the row-sharded blocked
    Cholesky with float64 refinement, and the row-sharded CG), the
    card-resident large-N classifier with variances, evidence and held-out
    LPD, online growth of the sharded factor, and two steps of the probed
    hyperparameter fit.  Rank 0 prints one summary line.

    When ``torch.distributed`` is initialised, this process runs it as its
    rank of the default group, whose size must be ``n_devices``.
    Otherwise it spawns ``n_devices`` local ranks that meet on a
    ``reserved_port``:
    NCCL, one card each, on CUDA; gloo when ``device="cpu"``.  A rank
    that fails makes the call raise."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}) in a group of "
                f"{dist.get_world_size()} ranks")
        _dryrun_rank(n_devices, device)
        return None
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA "
                f"devices, this host has {have}; pass device=\"cpu\" to run "
                f"{n_devices} ranks on the CPU (gloo)")
    # ranks on one host share its cores
    threads = max(1, torch.get_num_threads() // n_devices)
    spawn_ranks(n_devices, _rank_main, str(device), threads)
    return None


def spawn_ranks(size: int, target, *args, limit_s=None) -> None:
    """Run ``target(rank, size, port, *args)`` in ``size`` spawned
    processes that meet on ``127.0.0.1:port``, a ``reserved_port`` held
    for the life of the world; raise RuntimeError
    when one of them fails, or when the world outlasts ``limit_s``
    seconds (None: no limit).  The first rank that fails ends the others
    at once: they would wait for it in a collective until its timeout."""
    ctx = multiprocessing.get_context("spawn")
    with reserved_port() as port:
        procs = [ctx.Process(target=target, args=(r, size, port) + args)
                 for r in range(size)]
        for p in procs:
            p.start()
        deadline = None if limit_s is None else time.monotonic() + limit_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            hung = sum(p.is_alive() for p in procs)
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * size:
        raise RuntimeError(f"{size} ranks: rank exit codes {codes}"
                           + (f", {hung} still running" if hung else ""))


def _rank_main(rank: int, size: int, port: int, device: str,
               threads: int) -> None:
    """One spawned rank: join the group, run the sequence, leave."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    multihost.initialize(f"127.0.0.1:{port}", size, rank, device=device,
                         timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        _dryrun_rank(size, device)
    finally:
        multihost.shutdown()


def _require(cond, msg="") -> None:
    """The dry run's asserts, kept under ``python -O``."""
    if not cond:
        raise AssertionError(msg)


def dryrun_fit_model():
    """The dry run's learnable model for its two probed fit steps:
    Conv-ReLU-Conv with the paper ConvNet's 7x7 filter and 28x28
    readout."""
    return Sequential(
        Conv2d(7, var_weight=2.0, var_bias=1.0, learnable=True),
        ReLU(), Conv2d(28, padding=0, learnable=True))


def _dryrun_rank(n_devices: int, device, mesh=None) -> dict:
    """This rank's part of the dry run: JAX's sequence with JAX's shapes
    for ``n_devices`` and its asserts, on ``mesh`` (the group of
    ``n_devices`` ranks by default; a test passes a world of one to run
    the same shapes without a group).  Returns what it computed; rank 0
    prints it."""
    settings.disable_tf32()
    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    model = configs.load("mnist_paper_convnet_gp").initial_model
    # 16 blocks of 32 over 8 ranks at n = 8: several blocks per rank, and
    # a tile grid (batch 32) that does not align with the classify block
    tr_x, tr_y, te_x, te_y = synthetic_arrays(
        n_train=64 * n_devices, n_test=8 * n_devices, shape=(1, 28, 28))

    kxx = compute_gram_sharded(model, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
    kzx = compute_gram_sharded(model, te_x, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
    _require(not np.isnan(kxx).any() and not np.isnan(kzx).any())
    _require(kxx[0, 0] > 1e11,
             "expected the paper config's ~1e12 Gram scale")

    y = solve.one_hot_targets(tr_y)
    kxx64 = np.asarray(kxx, np.float64)

    # distributed direct solve: blocked sharded Cholesky + refinement,
    # several blocks per rank
    a, rel, iters = chol_solve_dist(kxx64.copy(), y, mesh=mesh, block=32)
    pred = solve.predict(np.asarray(kzx, np.float64), a)
    _require(pred.shape == (len(te_x),))
    _require(np.isfinite(a).all() and rel < 1e-8, rel)
    acc = solve.accuracy(pred, te_y)

    # distributed CG (the iterative fallback), on the equilibrated system
    s2 = float(np.diagonal(kxx).mean())
    a_cg, rel_cg, it_cg = cg_solve_sharded(
        kxx64 / s2, y, jitter=1e-10, mesh=mesh, tol=1e-5, maxiter=500)
    _require(np.isfinite(a_cg).all())

    # the card-resident large-N path: sharded scaled assembly, in-place
    # blocked factor, matrix-free refinement, scores and variances
    accs_l, info_l = classify_device_large(
        model, tr_x, tr_y, (te_x, te_y), batch_size=32, block=64,
        mesh=mesh, variances=True, verbose=False)
    _require(info_l["rel_residual"] < 1e-3, info_l)
    _require(len(info_l["predictions"][0]) == len(te_x))
    _require(len(info_l["variances"][0]) == len(te_x))
    _require(np.isfinite(info_l["variances"][0]).all())
    _require(np.isfinite(info_l["log_evidence"]))
    _require(np.isfinite(info_l["logdet"]))
    lpd, lpd_se, _ = solve.gaussian_lpd(
        info_l["scores"][0], info_l["variances"][0], te_y,
        info_l["jitter_raw"])
    _require(np.isfinite(lpd) and lpd_se >= 0.0)

    # online growth: the sharded factor extends in place
    half = len(tr_x) // 2
    gp = IncrementalGP(model, capacity=len(tr_x), batch_size=32,
                       block=32, mesh=mesh)
    gp.add(tr_x[:half], tr_y[:half])
    info_i = gp.add(tr_x[half:], tr_y[half:])
    _require(info_i["rel_residual"] < 1e-8, info_i)
    _require(np.isfinite(info_i["log_evidence"]))
    pred_i = gp.classify(te_x)
    acc_i = float(np.mean(pred_i == np.asarray(te_y)))

    # hyperparameter training over the ranks: two probed fit_large steps
    _, losses_f = fit_large(dryrun_fit_model(), tr_x[:16 * n_devices],
                            y[:16 * n_devices].astype(np.float32),
                            steps=2, batch_size=32, grad="probed",
                            probes=4, block=32, mesh=mesh)
    _require(np.isfinite(losses_f).all(), losses_f)

    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): paper-config gram "
              f"{kxx.shape} sharded over {mesh.size} devices; chol_dist "
              f"rel={rel:.2e} in {iters} refinements, acc={acc:.2f}; "
              f"CG rel={rel_cg:.2e} in {it_cg} iters; device-resident "
              f"classify rel={info_l['rel_residual']:.2e}, "
              f"acc={accs_l[0]:.2f}, "
              f"log_evidence={info_l['log_evidence']:.4g}, "
              f"lpd={lpd:.4g}+-{lpd_se:.2g}; incremental "
              f"extend rel={info_i['rel_residual']:.2e}, acc={acc_i:.2f}; "
              f"probed fit nmll {losses_f[0]:.4g} -> {losses_f[-1]:.4g}",
              flush=True)
    return {"kxx": kxx, "kzx": kzx, "predictions": pred, "acc": acc,
            "rel": rel, "cg_rel": rel_cg, "large_acc": accs_l[0],
            "large_rel": info_l["rel_residual"],
            "large_predictions": info_l["predictions"][0],
            "variances": info_l["variances"][0],
            "log_evidence": info_l["log_evidence"], "logdet":
            info_l["logdet"], "lpd": lpd, "lpd_se": lpd_se,
            "incremental_predictions": pred_i, "incremental_acc": acc_i,
            "incremental_rel": info_i["rel_residual"],
            "incremental_log_evidence": info_i["log_evidence"],
            "losses": np.asarray(losses_f)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("mode", nargs="?", choices=["multichip"],
                   help="run the multi-rank dry run instead of the forward")
    p.add_argument("n_devices", nargs="?", type=int, default=8,
                   help="ranks of the dry run")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu: gloo ranks for the dry run)")
    a = p.parse_args(argv)
    if a.mode == "multichip":
        dryrun_multichip(a.n_devices, device=a.device)
        return
    fn, args = entry(device=a.device)
    out = fn(*args)
    print("entry forward:", tuple(out.shape), float(out[0, 0]))


if __name__ == "__main__":
    main()

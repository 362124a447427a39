"""Time the in-place factor extension against a refactor from scratch.

PyTorch counterpart of ``scripts/extend_bench.py``, on one card: an SPD
matrix of size n + m is made on the device from a seeded generator; its
leading n x n block is factored with capacity reserved, extended by m rows
(``CardFactor.extend`` from host blocks, then ``extend_device`` from card
blocks, then a second ``extend_device`` into the rows left), and each is
timed against refactoring the whole n + m system.  The extended factors'
float32 solves must agree with the refactor's within 1e-3 (asserted: a
broken extension stops the run).  A small factor and extension of the same
block size run first, untimed.  The work: an extension is ~n^2 m (one
m-wide blocked forward solve and the Schur complement) against
(n + m)^3 / 3 for the refactor.

    python -m cnn_gp_tpu_torch.scripts.extend_bench --n=16384 --m=2048 \\
        --block=1024

Every clock read follows a device synchronisation.
"""

import argparse
import json
import time

import numpy as np
import torch

from cnn_gp_tpu_torch import settings
from cnn_gp_tpu_torch.parallel.chol_dist import CardFactor
from cnn_gp_tpu_torch.utils import resolve_device


def run(a, device) -> dict:
    settings.disable_tf32()
    n, m, block = a.n, a.m, a.block

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, *args):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        return time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(a.seed)
    g = torch.randn((n + m, n + m), generator=gen, device=device)
    k = g @ g.T / (n + m)
    del g
    k.diagonal().add_(1.0)                       # diagonal ~2, mild condition
    b_host = k[n:, :n].cpu().numpy()
    c_host = k[n:, n:].cpu().numpy()
    rhs = np.random.RandomState(1).randn(n + m, 10).astype(np.float32)

    def lead():
        return k[:n, :n].clone()

    # a warm-up on a small system of the same block size, so that no timed
    # step pays for the linear-algebra libraries' first calls
    n_w, m_w = min(2 * block, n), min(block, m)
    f_warm = CardFactor(n_w, block, capacity=n_w + m_w, device=device)
    f_warm.factorize_device(k[:n_w, :n_w].clone())
    f_warm.extend(np.zeros((m_w, n_w), np.float32),
                  np.eye(m_w, dtype=np.float32))
    del f_warm

    def agreement(f, want):
        got = f.solve(rhs)
        rel = float(np.linalg.norm(got - want)
                    / max(np.linalg.norm(want), 1e-30))
        # a gate, not a report: a broken extension must stop the run
        assert np.isfinite(rel) and rel < 1e-3, f"solves disagree: {rel}"
        return rel

    # the whole n + m system from scratch (consumes its copy)
    f_full = CardFactor(n + m, block, device=device)
    t_refactor = timed(f_full.factorize_device, k.clone())
    a_full = f_full.solve(rhs)
    del f_full

    # n with capacity, then m rows from host blocks
    f = CardFactor(n, block, capacity=n + m, device=device)
    t_factor_n = timed(f.factorize_device, lead())
    t_extend = timed(f.extend, b_host, c_host)
    rel = agreement(f, a_full)
    del f

    # from card blocks: W = B^T with zero rows past n, C on the card;
    # capacity n + 2m leaves room for a second extension
    f2 = CardFactor(n, block, capacity=n + 2 * m, device=device)
    w = torch.zeros((f2.n_pad, m), device=device)
    w[:n] = k[:n, n:]
    c = k[n:, n:].clone()
    f2.factorize_device(lead())
    del k
    t_extend_dev = timed(f2.extend_device, w, c)
    rel2 = agreement(f2, a_full)
    # a second extension into the identity rows [n + m, n + 2m): any SPD
    # block does, and only its time counts
    w.zero_()
    t_extend_warm = timed(f2.extend_device, w, torch.eye(m, device=device))
    out = {"n": n, "m": m, "block": block, "refactor_s": t_refactor,
           "factor_n_s": t_factor_n, "extend_host_s": t_extend,
           "extend_device_s": t_extend_dev,
           "extend_device_warm_s": t_extend_warm,
           "speedup_host": t_refactor / t_extend,
           "speedup_device": t_refactor / t_extend_dev,
           "speedup_device_warm": t_refactor / t_extend_warm,
           "solve_agreement_rel": [rel, rel2]}
    print(f"n={n} m={m} block={block} refactor(n+m)={t_refactor:.4f}s "
          f"factor(n,cap)={t_factor_n:.4f}s extend(host)={t_extend:.4f}s "
          f"extend(device)={t_extend_dev:.4f}s "
          f"extend(device,warm)={t_extend_warm:.4f}s "
          f"speedup_host={out['speedup_host']:.2f}x "
          f"speedup_device={out['speedup_device']:.2f}x "
          f"speedup_device_warm={out['speedup_device_warm']:.2f}x "
          f"solve_agreement_rel={rel:.2e}/{rel2:.2e}", flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=16384,
                   help="initial system size")
    p.add_argument("--m", type=int, default=2048, help="rows added by extend")
    p.add_argument("--block", type=int, default=1024,
                   help="Cholesky block size")
    p.add_argument("--seed", type=int, default=0, help="generator seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    return run(a, resolve_device(a.device))


if __name__ == "__main__":
    main()

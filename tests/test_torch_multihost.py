"""Real multi-process assembly with the port: two ``save_kernel``
processes join one gloo group (``--coordinator_address``,
``--num_processes``, ``--process_id``), take their worker identity from
it and each compute their contiguous span.  With HDF5 each writes its own
file and ``merge_stores`` completes the Gram; with ``--store_backend=zarr``
both write ONE store at once.  The JAX counterpart is
tests/test_multihost.py (marked slow); here the synthetic config's
ranges are cut to 96 / 32 / 32 (``tests/_torch_cut_config.py``) so the
run stays in Tier-1.  Each group meets on its own reserved port
(``entry.reserved_port``), and ``W.launch`` reports every process when
one fails.  The Zarr group's ranks create the store's datasets at the
same moment: the race that could kill one of them on a loaded machine
is ``tests/test_torch_store_race.py``'s.  A rank whose peer never comes
ends with an error at ``save_kernel``'s rendezvous timeout."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")

import _torch_dist_worker as W  # noqa: E402
from cnn_gp_tpu_torch.entry import reserved_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANGES = (96, 32, 32)
B = 32


LIMIT_S = 120       # both groups, start to end


def _ranks(group, tmp_path, out_path, backend, port):
    """The two processes of one group, as ``W.launch`` takes them."""
    return [(group, rank, [
        sys.executable, os.path.join(REPO, "tests", "_torch_cut_config.py"),
        "-m", "cnn_gp_tpu_torch.exp_mnist_resnet.save_kernel",
        "--config=synthetic", f"--datasets_path={tmp_path}",
        f"--batch_size={B}", f"--out_path={out_path(rank)}",
        f"--store_backend={backend}", "--device=cpu",
        f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
        f"--process_id={rank}"]) for rank in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups at once: two processes writing an HDF5 file each, and
    two writing one shared Zarr store, each group on its own reserved
    port.  Returns the paths."""
    tmp = tmp_path_factory.mktemp("multihost")
    logs = tmp_path_factory.mktemp("multihost_logs")
    h5 = [str(tmp / f"{r:02d}_nw02.h5") for r in range(2)]
    zarr = str(tmp / "k")
    env = dict(os.environ, CUT_CONFIG="synthetic",
               CUT_RANGES=",".join(map(str, RANGES)), OMP_NUM_THREADS="1")
    with reserved_port() as p_h5, reserved_port() as p_zarr:
        outs = W.launch(_ranks("h5", tmp, lambda r: h5[r], "h5", p_h5)
                        + _ranks("zarr", tmp, lambda r: zarr, "zarr", p_zarr),
                        str(logs), env=env, limit_s=LIMIT_S)
    for i, out in enumerate(outs):
        assert f"torch.distributed: worker {i % 2}/2" in out, out[-1500:]
    return h5, zarr


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The cut synthetic dataset and its Grams from one process: the
    port's (the same tiles) and the JAX package's."""
    import configs as jconfigs
    from cnn_gp_tpu.parallel import gram_in_memory as jgram
    from cnn_gp_tpu_torch import configs
    from cnn_gp_tpu_torch.data import DatasetFromConfig
    from cnn_gp_tpu_torch.parallel import gram_in_memory
    cfg = configs.load("synthetic")
    for name, n in zip(("train_range", "validation_range", "test_range"),
                       RANGES):
        setattr(cfg, name, list(getattr(cfg, name))[:n])
    ds = DatasetFromConfig("", cfg)
    jm = jconfigs.load("synthetic").initial_model
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = {s: gram_in_memory(cfg.initial_model, getattr(ds, s).images,
                                  None if s == "train" else ds.train.images,
                                  device="cpu", batch_size=B, progress=False)
                for s in ("train", "validation", "test")}
    finally:
        torch.set_num_threads(n)
    jax_kxx = np.asarray(jgram(jm, ds.train.images, batch_size=B,
                               progress=False))
    return port, jax_kxx


def _check(store, one_process):
    port, jax_kxx = one_process
    store.assert_complete("Kxx", upper_triangle_only=True)
    for name in ("Kxvx", "Kxtx", "Kv_diag", "Kt_diag"):
        store.assert_complete(name)
    kxx = store.read("Kxx")
    iu = np.triu_indices(RANGES[0])
    np.testing.assert_array_equal(kxx[iu], port["train"][iu])
    np.testing.assert_array_equal(store.read("Kxvx"), port["validation"])
    np.testing.assert_array_equal(store.read("Kxtx"), port["test"])
    scale = np.abs(jax_kxx).max()
    assert np.abs(kxx[iu] - jax_kxx[iu]).max() / scale < 1e-5


def test_two_process_assembly_h5(runs, one_process):
    from cnn_gp_tpu_torch.data import GramStore, merge_stores
    paths = runs[0]
    with GramStore(paths[0], "r") as d:
        # each worker computed a strict subset: neither file is complete
        with pytest.raises(RuntimeError):
            d.assert_complete("Kxx", upper_triangle_only=True)
    merge_stores(paths[0], paths[1:])
    with GramStore(paths[0], "r") as d:
        _check(d, one_process)


def test_two_process_assembly_one_zarr_store(runs, one_process):
    from cnn_gp_tpu_torch.data import TensorStoreGramStore
    with TensorStoreGramStore(runs[1], "r") as d:
        assert d.done_mask("Kxx")[np.triu_indices(3)].all()
        _check(d, one_process)


JOIN_TIMEOUT_S = 5      # save_kernel.RANK_TIMEOUT_S, cut for the test
_ALONE = """
import sys, time
from cnn_gp_tpu_torch.exp_mnist_resnet import save_kernel
save_kernel.RANK_TIMEOUT_S = {timeout}
t0 = time.monotonic()
try:
    save_kernel.main(sys.argv[1:])
finally:
    print(f"main ended after {{time.monotonic() - t0:.2f}} s", flush=True)
"""


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_alone_ends_with_an_error(rank, tmp_path):
    """One rank of a group of two whose other rank never arrives (rank 0,
    which hosts the rendezvous, or rank 1, which joins it): ``save_kernel``
    ends with an error within its rendezvous timeout, not a hang."""
    code = _ALONE.format(timeout=JOIN_TIMEOUT_S)
    with reserved_port() as port:
        r = subprocess.run(
            [sys.executable, "-c", code, "--config=synthetic",
             f"--out_path={tmp_path / 'k.h5'}", "--device=cpu",
             f"--coordinator_address=127.0.0.1:{port}", "--num_processes=2",
             f"--process_id={rank}"],
            cwd=REPO, capture_output=True, text=True, timeout=W.JOIN_S,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
    out = r.stdout + r.stderr
    assert r.returncode != 0, out[-3000:]
    assert "torch.distributed: worker" not in out, out[-3000:]
    seconds = float(re.search(r"main ended after ([\d.]+) s", out).group(1))
    # the store's own clock: its error comes at the timeout, give or take
    # its retry backoff, where gloo's default would wait 30 minutes
    assert JOIN_TIMEOUT_S <= seconds < JOIN_TIMEOUT_S + 15, out[-3000:]
    assert "timed out" in out.lower(), out[-3000:]
    assert not os.path.exists(tmp_path / "k.h5")

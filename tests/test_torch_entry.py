"""The port's entry module (``cnn_gp_tpu_torch/entry.py``) against the JAX
package's ``__graft_entry__.py`` on the CPU.

``entry(device="cpu")``'s forward against JAX's ``entry()`` under
``jax.jit``: the same example arguments bit for bit, the same tile within
1e-5 of max|K| at the offsets (0, 8) and on the diagonal tile (0, 0),
which is exactly symmetric.  ``dryrun_multichip(2, device="cpu")`` runs
JAX's sequence and asserts on a gloo world of two ranks: its summary line
once, with finite values, and on both ranks the same accuracies as the
same sequence (the shapes of ``n = 2``) on a world of one, with the log
evidence and LPD within 1e-4 relative.  It is held against JAX's own
``dryrun_multichip(2)`` on a virtual two-device CPU mesh, run in a
subprocess: the Grams within 1e-5 of max|K|, the predictions and the
printed accuracies equal, the variances, evidences, LPD and the probed
fit's losses within 1e-4 relative.  The spawned route runs a world
of its own and raises when a rank fails.  Asking for CUDA here, where
there is none, raises: nothing moves to the CPU."""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from cnn_gp_tpu_torch import configs
from cnn_gp_tpu_torch import entry as E
from cnn_gp_tpu_torch.data import synthetic_arrays
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import compute_gram_sharded, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRYRUN = os.path.join(REPO, "tests", "_torch_jax_dryrun.py")
TOL = 1e-5          # max |delta| / max |K|, the repo's kernel parity rule
EVIDENCE_RTOL = 1e-4
SUMMARY = re.compile(
    r"^dryrun_multichip\((\d+)\): paper-config gram \((\d+), (\d+)\) "
    r"sharded over (\d+) devices; chol_dist rel=(\S+) in \d+ "
    r"refinements, acc=(\S+); CG rel=(\S+) in \d+ iters; device-resident "
    r"classify rel=(\S+), acc=(\S+), log_evidence=(\S+), lpd=(\S+)\+-(\S+);"
    r" incremental extend rel=(\S+), acc=(\S+); probed fit nmll (\S+) -> "
    r"(\S+)$", re.M)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_entry():
    """JAX's jitted forward and its example arguments."""
    import jax

    import __graft_entry__ as G
    fn, args = G.entry()
    return jax.jit(fn), args


@pytest.fixture(scope="module")
def port_entry():
    return E.entry(device="cpu")


def _scaled(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_example_args_are_jax_bits(jax_entry, port_entry):
    (_, jargs), (_, targs) = jax_entry, port_entry
    for j, t in zip(jargs[:2], targs[:2]):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), j)
    assert targs[2:] == (int(jargs[2]), int(jargs[3])) == (0, 8)


@pytest.mark.parametrize("offsets", [(0, 8), (0, 0)])
def test_forward_matches_jax(jax_entry, port_entry, offsets):
    """The cross tile at (0, 8), where no pair is masked, and the diagonal
    tile of x at (0, 0), where the mask is the identity."""
    (jfn, jargs), (tfn, targs) = jax_entry, port_entry
    x, z = jargs[:2]
    tx, tz = targs[:2]
    if offsets == (0, 0):
        z, tz = x, tx
    want = np.asarray(jfn(x, z, np.int32(offsets[0]), np.int32(offsets[1])))
    got = tfn(tx, tz, *offsets)
    assert got.shape == (8, 8) and got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all()
    assert _scaled(got, want) <= TOL, _scaled(got, want)
    if offsets == (0, 0):
        np.testing.assert_array_equal(got, got.T)


def test_entry_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.entry()


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_without_enough_cards_raises(n):
    """Never the JAX dry run's quiet move to a CPU mesh: too few cards is
    an error that names both counts and the CPU route."""
    have = torch.cuda.device_count()
    if have >= n:
        pytest.skip(f"this host has {have} CUDA devices")
    with pytest.raises(ValueError, match=(
            rf"needs {n} CUDA devices, this host has {have}; pass "
            rf"device=\"cpu\"")):
        E.dryrun_multichip(n)


def _summary(text):
    found = SUMMARY.findall(text)
    assert len(found) == 1, text[-3000:]
    nums = [float(v) for v in found[0]]
    assert np.isfinite(nums).all(), found
    return nums


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """The port's ``dryrun_multichip(2, device="cpu")`` on a gloo world of
    two ranks (each rank's results), and meanwhile, in a subprocess, JAX's
    ``dryrun_multichip(2)`` on a virtual two-device CPU mesh, its
    library calls' results kept at full precision
    (``tests/_torch_jax_dryrun.py``), with its printed line."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    jax_run = subprocess.Popen(
        [sys.executable, JAX_DRYRUN, "2", str(d / "jax.npz")], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = W.run_world(2, "dryrun", str(d))
    finally:
        out, err = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, err[-3000:]
    with np.load(d / "jax.npz") as f:
        jax = dict(f)
    return ranks, jax, out


def test_dryrun_two_ranks_match_one(dryruns):
    """Both ranks of a gloo world run the whole sequence through
    ``dryrun_multichip(2, device="cpu")`` (the initialised-group route) and
    compute the same numbers; rank 0 alone prints the summary.  The same
    sequence on a world of one gives the same accuracies, and the log
    evidence and LPD within 1e-4 relative."""
    ranks, _, _ = dryruns
    nums = _summary(str(ranks[0]["summary"]))
    assert str(ranks[1]["summary"]) == ""
    assert nums[:4] == [2, 128, 128, 2]
    for k in ranks[0]:
        if k != "summary":
            np.testing.assert_array_equal(ranks[1][k], ranks[0][k],
                                          err_msg=k)
    want = E._dryrun_rank(2, "cpu", mesh=make_mesh(device="cpu"))
    got = ranks[0]
    for k in ("acc", "large_acc", "incremental_acc"):
        assert float(got[k]) == want[k], k
    for k in ("log_evidence", "lpd"):
        assert abs(float(got[k]) - want[k]) <= EVIDENCE_RTOL * abs(want[k]), (
            k, float(got[k]), want[k])
    assert nums[5] == round(want["acc"], 2)


def test_dryrun_line_matches_jax(dryruns):
    """The port's summary line against the one JAX's dry run prints: the
    same Gram shape and rank count, and the same three accuracies."""
    ranks, _, jax_out = dryruns
    got, want = _summary(str(ranks[0]["summary"])), _summary(jax_out)
    assert got[:4] == want[:4] == [2, 128, 128, 2]
    for i in (5, 8, 13):        # chol_dist, device-resident, incremental
        assert got[i] == want[i], (i, got[i], want[i])


# what the two dry runs computed: (key, bound, how it is held)
JAX_CHECKS = [
    ("kxx", TOL, "scaled"), ("kzx", TOL, "scaled"),
    ("predictions", 0, "equal"), ("large_predictions", 0, "equal"),
    ("incremental_predictions", 0, "equal"),
    ("variances", EVIDENCE_RTOL, "scaled"),
    ("log_evidence", EVIDENCE_RTOL, "scaled"),
    ("logdet", EVIDENCE_RTOL, "scaled"), ("lpd", EVIDENCE_RTOL, "scaled"),
    ("incremental_log_evidence", EVIDENCE_RTOL, "scaled"),
    ("losses", EVIDENCE_RTOL, "scaled")]


@pytest.mark.parametrize("key,bound,how", JAX_CHECKS,
                         ids=[c[0] for c in JAX_CHECKS])
def test_dryrun_matches_jax(dryruns, key, bound, how):
    """Rank 0 of the port's two-rank dry run against JAX's two-device dry
    run on the same data: the sharded Grams within 1e-5 of max|K|; the
    Cholesky, device-resident and incremental predictions equal; the
    variances, log evidence, log determinant, LPD, the grown factor's
    evidence and both probed-fit losses (the step-0 NMLL and the next)
    within 1e-4 relative."""
    ranks, jax, _ = dryruns
    got = np.asarray(ranks[0][key], np.float64)
    want = np.asarray(jax[key], np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    if how == "equal":
        np.testing.assert_array_equal(got, want)
    else:
        err = _scaled(got, want)
        assert err <= bound, (key, err)


def test_dryrun_spawns_its_ranks(capfd):
    """With no group, ``dryrun_multichip`` spawns its ranks on a reserved
    localhost port and returns None; its one rank prints the line."""
    assert E.dryrun_multichip(1, device="cpu") is None
    nums = _summary(capfd.readouterr().out)
    assert nums[:4] == [1, 64, 64, 1]


def test_a_failed_rank_fails_the_call():
    """A rank that fails ends the others at once and the call raises."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"rank exit codes \[-9, 1\]"):
        E.spawn_ranks(2, W.failing_rank)
    assert time.perf_counter() - t0 < W.JOIN_S / 2


def test_module_runs_the_forward_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "cnn_gp_tpu_torch.entry", "--device=cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    m = re.fullmatch(r"entry forward: \(8, 8\) (\S+)\n", r.stdout)
    assert m and np.isfinite(float(m.group(1))), r.stdout


@pytest.fixture
def counted(monkeypatch):
    """Count launches on the CPU as the kernels count them on the card:
    one pair-kernel launch per pair_tile call, one pre-pass per
    diag_maps call."""
    pair, maps = megakernel.pair_tile, megakernel.diag_maps

    def pair_tile(*args):
        megakernel.launches += 1
        return pair(*args)

    def diag_maps(spec, x):
        megakernel.prepass_launches += 1
        return maps(spec, x)

    monkeypatch.setattr(megakernel, "pair_tile", pair_tile)
    monkeypatch.setattr(megakernel, "diag_maps", diag_maps)
    megakernel.launches = megakernel.prepass_launches = 0


def _dryrun_grams(calls):
    """The dry run's two sharded Grams at n = 1 through chip_smoke's
    recorder, on a world of one."""
    import chip_smoke
    model = configs.load("mnist_paper_convnet_gp").initial_model
    tr_x, _, te_x, _ = synthetic_arrays(n_train=64, n_test=8,
                                        shape=(1, 28, 28))
    mesh = make_mesh(device="cpu")
    with chip_smoke.recording_grams(calls):
        E.compute_gram_sharded(model, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
        E.compute_gram_sharded(model, te_x, tr_x, batch_size=32, mesh=mesh,
                               progress=False)
    assert E.compute_gram_sharded is compute_gram_sharded
    return tr_x


@pytest.mark.parametrize("fault", [None, "value", "count"])
def test_smoke_dryrun_gram_check(counted, fault):
    """chip_smoke.py's check of the dry run's Grams, on the CPU: with the
    counts the card would give (3 Kxx and 2 Kzx tiles of 32 rows, one
    pre-pass per image set) and the plain path's values it passes; a
    Gram off by 1e-4 relative, or one pair-kernel launch too many,
    stops it."""
    import chip_smoke
    calls = []
    tr_x = _dryrun_grams(calls)
    assert [c[3:] for c in calls] == [(3, 1), (2, 2)]
    if fault == "value":
        calls[1] = calls[1][:2] + (calls[1][2] * (1 + 1e-4),) + calls[1][3:]
    elif fault == "count":
        calls[0] = calls[0][:3] + (4, 1)
    if fault is None:
        assert chip_smoke.check_dryrun_grams(calls) is tr_x
    else:
        with pytest.raises(AssertionError, match="dry run K"):
            chip_smoke.check_dryrun_grams(calls)

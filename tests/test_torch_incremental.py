"""The port's IncrementalGP (cnn_gp_tpu_torch.parallel.incremental) against
the JAX package's on the same numpy inputs, on the CPU, in both modes:
the 8x8 model and data of tests/test_incremental.py, the float64 oracle,
posteriors served across the packages, the launch counts that
chip_smoke.py requires, and the two bench scripts at toy sizes."""

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
from cnn_gp_tpu.ops import solve as jsolve
from cnn_gp_tpu.parallel import IncrementalGP as JIncrementalGP
from cnn_gp_tpu.parallel import gram_in_memory as jgram
from cnn_gp_tpu.parallel import make_mesh
from cnn_gp_tpu.serving import GPPredictor as JPredictor
from cnn_gp_tpu.serving import load_posterior as jload
from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import IncrementalGP, gram_in_memory
from cnn_gp_tpu_torch.serving import GPPredictor, load_posterior
from tests.test_incremental import _data

CPU = torch.device("cpu")
KW = dict(batch_size=16, block=16)
MODES = {"retained": True, "regen": False}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small tiles, as
    tests/test_torch_fit.py: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_devices=1)


@pytest.fixture(scope="module")
def jmodel():
    return G.Sequential(G.Conv2d(3), G.ReLU(), G.Conv2d(3), G.ReLU(),
                        G.Conv2d(8, padding=0))


@pytest.fixture(scope="module")
def model():
    return Sequential(Conv2d(3), ReLU(), Conv2d(3), ReLU(),
                      Conv2d(8, padding=0))


def port_gp(model, capacity, jitter=1e-6, retain=True, **kw):
    return IncrementalGP(model, capacity=capacity, jitter=jitter,
                         retain_gram=retain, device=CPU, **KW, **kw)


def jax_gp(jmodel, mesh, capacity, jitter=1e-6, retain=True, **kw):
    return JIncrementalGP(jmodel, capacity=capacity, jitter=jitter,
                          retain_gram=retain, mesh=mesh, **KW, **kw)


def oracle(model, x, y, jitter_raw):
    """The float64 scipy posterior of K + jitter_raw I on (x, y), with K
    from the JAX model's Gram or the port model's."""
    if isinstance(model, G.NNGPKernel):
        kxx = np.asarray(jgram(model, x, batch_size=16), np.float64)
    else:
        kxx = gram_in_memory(model, x, device=CPU, batch_size=16,
                             progress=False).astype(np.float64)
    jsolve.diag_add(kxx, jitter_raw)
    t = jsolve.one_hot_targets(y)
    return (jsolve.solve_gp(kxx.copy(), t, method="scipy"),
            jsolve.log_marginal_likelihood(kxx, t), kxx)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_incremental_matches_jax_and_oracle(model, jmodel, mesh1, mode):
    """Three batches (48, 20, 33): after each, the port's posterior against
    JAX's IncrementalGP and the float64 oracle: equal predictions, alpha
    within 1e-5 (retained) or 1e-4 (regen) of solution scale, evidence
    within 1e-4 relative, variances within 1e-5 of the mean diagonal.

    Alpha is held against the oracle on the port's own Gram, as JAX's
    test holds JAX's: the two packages' Grams differ by ~2.5e-7 of value
    scale, which the system's condition number (~5e3 here) turns into up
    to 2.1e-5 of solution scale between the two exact solutions.  Against
    JAX's alpha the bound is that gap plus the same tolerance."""
    retain = MODES[mode]
    xs, ys = zip(*[_data(n, seed) for n, seed in ((48, 0), (20, 1),
                                                  (33, 2))])
    zx, _ = _data(16, 9)
    gp = port_gp(model, 128, retain=retain)
    jgp = jax_gp(jmodel, mesh1, 128, retain=retain)
    for step in range(3):
        info, jinfo = gp.add(xs[step], ys[step]), jgp.add(xs[step],
                                                         ys[step])
        x_all = np.concatenate(xs[:step + 1])
        y_all = np.concatenate(ys[:step + 1])
        assert info["n"] == gp.n == len(x_all)
        assert sorted(info["timings_s"]) == sorted(
            ["gram", "factor", "solve"] + (["write"] if step else []))
        assert gp._jitter_raw == pytest.approx(jgp._jitter_raw, rel=1e-6)
        assert info["rel_residual"] < (1e-10 if retain else 1e-4), info
        a_ref, ev_ref, kxx = oracle(model, x_all, y_all, gp._jitter_raw)
        a_jax, _, _ = oracle(jmodel, x_all, y_all, gp._jitter_raw)
        scale = np.max(np.abs(a_ref))
        tol = 1e-5 if retain else 1e-4
        assert np.max(np.abs(gp._alpha - a_ref)) < tol * scale
        gap = np.max(np.abs(a_ref - a_jax))
        assert np.max(np.abs(gp._alpha - jgp._alpha)) < gap + tol * scale
        assert abs(info["log_evidence"] - ev_ref) < 1e-4 * abs(ev_ref)
        assert abs(info["log_evidence"] - jinfo["log_evidence"]) < (
            1e-4 * abs(jinfo["log_evidence"]))
        kzx = np.asarray(jgram(jmodel, zx, x_all, batch_size=16),
                         np.float64)
        want = np.argmax(kzx @ a_jax, axis=1)
        np.testing.assert_array_equal(gp.classify(zx), want)
        np.testing.assert_array_equal(jgp.classify(zx), want)
    got_v, want_v = gp.variances(zx), jgp.variances(zx)
    assert np.max(np.abs(got_v - want_v)) < 1e-5 * np.mean(np.diagonal(kxx))
    assert (got_v >= 0).all()


def test_regen_matches_retained_and_keeps_no_host_gram(model):
    """The regen mode keeps nothing N^2 on the host, and its posterior
    agrees with the retained mode's to its float32 floor; its images and
    scalings sit in card buffers of capacity rows."""
    xs, ys = zip(*[_data(n, seed) for n, seed in ((48, 40), (20, 41))])
    z, _ = _data(12, 42)
    gp_r, gp_f = port_gp(model, 96), port_gp(model, 96, retain=False)
    assert gp_f._k32 is None and gp_r._k32.shape == (96, 96)
    for x, y in zip(xs, ys):
        info_r, info_f = gp_r.add(x, y), gp_f.add(x, y)
        err = (np.max(np.abs(gp_f._alpha - gp_r._alpha))
               / np.max(np.abs(gp_r._alpha)))
        assert err < 1e-4, err
        assert abs(info_f["log_evidence"] - info_r["log_evidence"]) < (
            1e-4 * abs(info_r["log_evidence"]))
    assert gp_f._x_dev.shape[0] == gp_f._s_dev.shape[0] == 96
    np.testing.assert_array_equal(gp_f._x_dev[:68].numpy(),
                                  np.concatenate(xs))
    np.testing.assert_array_equal(gp_f._s_dev[:68].numpy(),
                                  gp_f._s.astype(np.float32))
    np.testing.assert_array_equal(gp_f._s_dev[68:].numpy(), 1.0)
    np.testing.assert_array_equal(gp_f.classify(z), gp_r.classify(z))
    vr = gp_r.variances(z)
    np.testing.assert_allclose(gp_f.variances(z), vr,
                               atol=1e-5 * float(np.abs(vr).max()),
                               rtol=1e-4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_growth_to_exact_capacity(model, jmodel, mode):
    """Four add() batches up to exactly the capacity: every posterior
    predicts as the oracle, evidence within 1e-4; one more add is
    refused and changes nothing."""
    cap = 96
    sizes = [(48, 0), (32, 1), (8, 2), (8, 3)]
    xs, ys = zip(*[_data(n, seed) for n, seed in sizes])
    zx, _ = _data(12, 7)
    gp = port_gp(model, cap, retain=MODES[mode])
    for step in range(len(sizes)):
        info = gp.add(xs[step], ys[step])
        x_all = np.concatenate(xs[:step + 1])
        y_all = np.concatenate(ys[:step + 1])
        a_ref, _, _ = oracle(jmodel, x_all, y_all, gp._jitter_raw)
        _, ev_ref, _ = oracle(model, x_all, y_all, gp._jitter_raw)
        kzx = np.asarray(jgram(jmodel, zx, x_all, batch_size=16),
                         np.float64)
        np.testing.assert_array_equal(gp.classify(zx),
                                      np.argmax(kzx @ a_ref, axis=1))
        assert abs(info["log_evidence"] - ev_ref) < 1e-4 * abs(ev_ref)
    assert gp.n == cap and gp._factor.n == cap
    with pytest.raises(ValueError, match="capacity"):
        gp.add(*_data(1, 9))
    assert gp.n == cap


def test_capacity_enforced(model):
    x, y = _data(30, 3)
    with pytest.raises(ValueError, match="capacity"):
        port_gp(model, 20).add(x, y)
    gp = port_gp(model, 40)
    gp.add(x, y)
    with pytest.raises(ValueError, match="capacity"):
        gp.add(*_data(11, 4))    # 30 + 11 > the exact capacity
    gp.add(*_data(10, 4))        # 30 + 10 == capacity
    assert gp.n == 40
    with pytest.raises(ValueError):
        gp.add(x[:0], y[:0])


def test_predict_before_add_refused(model, tmp_path):
    gp = port_gp(model, 32)
    x, _ = _data(4, 8)
    for call in (gp.classify, gp.variances, gp.predict):
        with pytest.raises(RuntimeError, match="add"):
            call(x)
    with pytest.raises(RuntimeError, match="add"):
        gp.log_evidence()
    with pytest.raises(RuntimeError, match="add"):
        gp.save_posterior(tmp_path / "none")


def test_predict_shares_cross_sweep_and_empty_queries(model):
    """predict() == (scores(), variances()) from one sweep; chunked
    variances equal whole ones; empty query batches give empty shapes."""
    x1, y1 = _data(40, 33)
    gp = port_gp(model, 48)
    gp.add(x1, y1)
    z, _ = _data(13, 34)
    s, v = gp.predict(z)
    np.testing.assert_array_equal(s, gp.scores(z))
    np.testing.assert_array_equal(v, gp.variances(z))
    np.testing.assert_allclose(gp.variances(z, chunk=5), v, rtol=1e-6,
                               atol=1e-7 * float(np.abs(v).max()))
    s0, v0 = gp.predict(z[:0])
    assert s0.shape == (0, s.shape[1]) and v0.shape == (0,)
    assert gp.variances(z[:0]).shape == (0,)
    assert gp.scores(z[:0]).shape == (0, s.shape[1])


def test_n_classes_pinned(model):
    """A pinned class count keeps the score width when early batches lack
    classes; inferred, it widens as classes appear."""
    x1, _ = _data(40, 30)
    x2, _ = _data(24, 31)
    y1 = np.zeros(40, np.int64)
    y2 = np.full(24, 3, np.int64)
    z, _ = _data(6, 32)
    gp = port_gp(model, 64, n_classes=4)
    gp.add(x1, y1)
    assert gp.scores(z).shape == (6, 4)
    gp.add(x2, y2)
    assert gp.scores(z).shape == (6, 4)
    gp2 = port_gp(model, 64)
    gp2.add(x1, y1)
    assert gp2.scores(z).shape == (6, 1)
    gp2.add(x2, y2)
    assert gp2.scores(z).shape == (6, 4)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_non_pd_add_leaves_every_state_unchanged(model, mode, monkeypatch):
    """A non positive-definite batch: add() raises, and the factor (bit for
    bit), the Gram, the card buffers, the scalings, the labels and the
    posterior are as they were; the next batch still goes in.

    The batch's [m, m] block is negated on its way to the factor.  A batch
    that duplicates training points at jitter 0 is singular only in exact
    arithmetic: on this NNGP Gram (condition ~1e3) the float32 Schur
    complement of 16 duplicates comes out positive, ~3e-5, so the gate
    lets it in, as JAX's gate would (tests/test_torch_extend.py refuses
    duplicates of a well-conditioned matrix)."""
    x, y = _data(40, 50)
    gp = port_gp(model, 64, jitter=0.0, retain=MODES[mode])
    gp.add(x, y)
    name = "extend" if MODES[mode] else "extend_device"
    extend = getattr(gp._factor, name)
    monkeypatch.setattr(gp._factor, name, lambda b, c: extend(b, -c))
    before = {"l": gp._factor.l.clone(), "x": gp._x_dev.clone(),
              "s": gp._s.copy(), "labels": gp._labels.copy(),
              "alpha": gp._alpha.copy()}
    if gp._k32 is not None:
        before["k32"] = gp._k32.copy()
    else:
        before["s_dev"] = gp._s_dev.clone()
    with pytest.raises(ValueError, match="positive-definite"):
        gp.add(x[:16], y[:16])
    assert gp.n == gp._factor.n == 40
    assert torch.equal(gp._factor.l, before["l"])
    assert torch.equal(gp._x_dev, before["x"])
    np.testing.assert_array_equal(gp._s, before["s"])
    np.testing.assert_array_equal(gp._labels, before["labels"])
    np.testing.assert_array_equal(gp._alpha, before["alpha"])
    if gp._k32 is not None:
        np.testing.assert_array_equal(gp._k32, before["k32"])
    else:
        assert torch.equal(gp._s_dev, before["s_dev"])
    monkeypatch.undo()
    gp.add(*_data(8, 51))                   # and it still grows
    assert gp.n == 48


@pytest.mark.parametrize("mode", sorted(MODES))
def test_port_posterior_served_by_jax(model, jmodel, tmp_path, mode):
    """A posterior grown in the port, saved with the port's
    save_posterior, loads in JAX's serving.load_posterior and gives the
    port's predictions; the port's GPPredictor gives them too."""
    x1, y1 = _data(40, 20)
    x2, y2 = _data(24, 21)
    z, _ = _data(12, 22)
    gp = port_gp(model, 64, retain=MODES[mode])
    gp.add(x1, y1)
    gp.add(x2, y2)
    path = gp.save_posterior(tmp_path / "grown", config_name="incremental")
    p = jload(path)
    assert p.n == gp.n == 64 and p.jitter_raw == gp._jitter_raw
    np.testing.assert_array_equal(p.scalings, gp._s)
    want = gp.classify(z)
    np.testing.assert_array_equal(JPredictor(jmodel, p,
                                             batch_size=16).classify(z),
                                  want)
    pred = GPPredictor(model, load_posterior(path), batch_size=16,
                       device=CPU)
    np.testing.assert_array_equal(pred.classify(z), want)
    got, ref = pred.scores(z), gp.scores(z)
    assert np.max(np.abs(got - ref)) < 2e-5 * np.abs(ref).max()
    pred.prepare_variances(block=16)
    got_v, want_v = pred.variances(z), gp.variances(z)
    with torch.no_grad():
        scale = float(model(x1[:8], diag=True).mean())
    assert np.max(np.abs(got_v - want_v)) < 1e-5 * scale


def test_jax_posterior_served_by_port(model, jmodel, mesh1, tmp_path):
    """A posterior grown by JAX's IncrementalGP serves in the port's
    GPPredictor with JAX's predictions and variances."""
    x1, y1 = _data(40, 23)
    x2, y2 = _data(24, 24)
    z, _ = _data(12, 25)
    jgp = jax_gp(jmodel, mesh1, 64)
    jgp.add(x1, y1)
    jgp.add(x2, y2)
    path = jgp.save_posterior(tmp_path / "jax_grown")
    pred = GPPredictor(model, load_posterior(path), batch_size=16,
                       device=CPU)
    np.testing.assert_array_equal(pred.classify(z), jgp.classify(z))
    pred.prepare_variances(block=16)
    want_v = jgp.variances(z)
    assert np.max(np.abs(pred.variances(z) - want_v)) < 1e-5 * float(
        np.asarray(jmodel(x1[:8], diag=True)).mean())


@pytest.fixture()
def counted(monkeypatch):
    """Count launches on the CPU as the kernels count them on the card:
    one pair-kernel launch per gram_tile or pair_tile call, and one
    pre-pass per diag_maps call and per side of a gram_tile call (one
    when z is x)."""
    tile, pair, maps = (megakernel.gram_tile, megakernel.pair_tile,
                        megakernel.diag_maps)

    def gram_tile(spec, x, z, mask=None):
        megakernel.launches += 1
        megakernel.prepass_launches += (1 if megakernel._same_images(x, z)
                                        else 2)
        return tile(spec, x, z, mask)

    def pair_tile(*args):
        megakernel.launches += 1
        return pair(*args)

    def diag_maps(spec, x):
        megakernel.prepass_launches += 1
        return maps(spec, x)

    monkeypatch.setattr(megakernel, "gram_tile", gram_tile)
    monkeypatch.setattr(megakernel, "pair_tile", pair_tile)
    monkeypatch.setattr(megakernel, "diag_maps", diag_maps)

    def read(fn, *args, **kwargs):
        megakernel.launches = megakernel.prepass_launches = 0
        out = fn(*args, **kwargs)
        return out, (megakernel.launches, megakernel.prepass_launches)
    return read


@pytest.mark.parametrize("mode", sorted(MODES))
def test_launch_counts_follow_chip_smoke_formula(model, counted, mode):
    """chip_smoke.py's incremental phase requires these counts on the
    card: its formula holds for a first fit, two adds (one ragged) and
    the queries of both kinds, in both modes."""
    import chip_smoke
    retain = MODES[mode]
    gp = port_gp(model, 96, jitter=1e-4, retain=retain)
    n = 0
    for m, seed in ((40, 60), (16, 61), (9, 62)):
        info, got = counted(gp.add, *_data(m, seed))
        tiles, sets, batches = chip_smoke.incremental_launches(
            retain, n, m, 16, info["refinements"])
        assert got == (tiles, sets + batches), (m, info)
        n += m
    z, _ = _data(20, 63)
    _, got = counted(gp.predict, z)
    tiles, sets, batches = chip_smoke.query_launches(20, n, 16, True)
    assert got == (tiles, sets + batches)
    _, got = counted(gp.scores, z)
    tiles, sets, batches = chip_smoke.query_launches(20, n, 16, False)
    assert got == (tiles, sets + batches)


def test_extend_bench_script(capsys):
    """The extension benchmark at toy size on the CPU: its solve gates
    pass and it prints its line and JSON."""
    from cnn_gp_tpu_torch.scripts import extend_bench
    out = extend_bench.main(["--n=96", "--m=40", "--block=32",
                             "--device=cpu"])
    assert out["n"] == 96 and out["m"] == 40
    assert max(out["solve_agreement_rel"]) < 1e-3
    for key in ("refactor_s", "extend_host_s", "extend_device_s",
                "extend_device_warm_s"):
        assert out[key] > 0
    assert "speedup_device_warm=" in capsys.readouterr().out


def test_incremental_bench_script(capsys):
    """add(m) in two calls against the refit at toy size on the CPU: equal
    predictions, evidence within 1e-4, one JSON line with the phases."""
    import json
    from cnn_gp_tpu_torch.scripts import incremental_bench
    out = incremental_bench.main([
        "--config=synthetic", "--n=48", "--m=16", "--batches=2",
        "--n_test=16", "--batch_size=16", "--block=16", "--jitter=1e-4",
        "--device=cpu"])
    assert out["n"] == 48 and out["m"] == 16 and out["batches"] == 2
    assert out["pred_agreement"] == 1.0 and out["evidence_rel_diff"] < 1e-4
    assert len(out["add_s_per_batch"]) == 2 and out["refit_s"] > 0
    assert [sorted(p) for p in out["add_phases_s"]] == [
        ["factor", "gram", "solve", "write"]] * 2
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["speedup_vs_refit"] == out["speedup_vs_refit"]

"""Port Gram assembly and store (cnn_gp_tpu_torch.parallel.gram,
cnn_gp_tpu_torch.data.store) against the JAX package: the same Grams on
the same arrays, stores that either package opens, resume and merge."""

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import cnn_gp_tpu_torch as T
from cnn_gp_tpu.data import GramStore as JStore
from cnn_gp_tpu.data import merge_stores as jmerge
from cnn_gp_tpu.data import synthetic_arrays
from cnn_gp_tpu.parallel import compute_gram as jgram
from cnn_gp_tpu.parallel import compute_gram_diag as jgram_diag
from cnn_gp_tpu_torch.data import GramStore as TStore
from cnn_gp_tpu_torch.data import merge_stores as tmerge
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import gram as tgram_mod
from cnn_gp_tpu_torch.parallel import (compute_gram, compute_gram_diag,
                                       gram_in_memory, save_K)
from cnn_gp_tpu_torch.utils import timing

B = 10


def strided(M):
    """Not megakernel-shaped: goes through apply_kernel."""
    return M.Sequential(M.Conv2d(3), M.ReLU(), M.Conv2d(3, stride=2),
                        M.ReLU(), M.Conv2d(7, padding=0))


def convnet(M):
    """Megakernel-shaped: goes through megakernel.pair_tile."""
    return M.Sequential(M.Conv2d(3, var_weight=2.0, var_bias=0.5), M.ReLU(),
                        M.Conv2d(3, var_weight=1.5, var_bias=0.1), M.ReLU(),
                        M.Conv2d(14, padding=0))


MODELS = {"strided": strided, "convnet": convnet}


@pytest.fixture(scope="module")
def data():
    x, _, _, _ = synthetic_arrays(n_train=37, n_test=0, shape=(1, 14, 14))
    z, _, _, _ = synthetic_arrays(n_train=23, n_test=0, shape=(1, 14, 14),
                                  seed=5)
    return x, z


def check(got, want):
    assert got.shape == want.shape
    assert not np.isnan(got).any()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def jax_in_memory(model, x, z=None, **kw):
    n2 = len(x) if z is None else len(z)
    out = np.full((len(x), n2), np.nan, np.float32)
    jgram(model, x, z, out=out, progress=False, **kw)
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_symmetric_matches_jax(name, data):
    x, _ = data
    got = gram_in_memory(MODELS[name](T), x, device="cpu", batch_size=B,
                         progress=False)
    check(got, jax_in_memory(MODELS[name](G), x, batch_size=B))
    np.testing.assert_array_equal(got, got.T)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cross_matches_jax(name, data):
    x, z = data
    got = gram_in_memory(MODELS[name](T), x, z, device="cpu", batch_size=B,
                         progress=False)
    check(got, jax_in_memory(MODELS[name](G), x, z, batch_size=B))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_diag_matches_jax(name, data):
    x, z = data
    got = compute_gram_diag(MODELS[name](T), x, device="cpu", batch_size=B,
                            progress=False)
    check(got, jgram_diag(MODELS[name](G), x, batch_size=B, progress=False))
    got = compute_gram_diag(MODELS[name](T), x[:len(z)], z, device="cpu",
                            batch_size=B, progress=False)
    want = jgram_diag(MODELS[name](G), x[:len(z)], z, batch_size=B,
                      progress=False)
    check(got, want)


@pytest.mark.parametrize("learnable", [False, True])
def test_diag_of_matched_model_reads_the_prepass(data, monkeypatch,
                                                 learnable):
    """compute_gram_diag(Z=None) of a megakernel-matched model is the
    readout of the pre-pass maps (diag_maps, one call per batch) and runs
    no apply_kernel; it agrees with JAX's model(x, diag=True) within 1e-5
    of value scale.  With Z given it keeps apply_kernel."""
    x, z = data
    jm = G.Sequential(G.Conv2d(3, var_weight=2.0, var_bias=0.5,
                               learnable=learnable), G.ReLU(),
                      G.Conv2d(3, var_weight=1.5, var_bias=0.1), G.ReLU(),
                      G.Conv2d(14, padding=0, learnable=learnable))
    from cnn_gp_tpu_torch.convert import from_jax_model
    tm = from_jax_model(jm)
    calls = []
    real = megakernel.diag_maps
    monkeypatch.setattr(megakernel, "diag_maps",
                        lambda *a: calls.append(1) or real(*a))

    def refuse(*a, **k):
        raise AssertionError("apply_kernel ran for a matched model")

    monkeypatch.setattr(tgram_mod, "apply_kernel", refuse)
    got = compute_gram_diag(tm, x, device="cpu", batch_size=B,
                            progress=False)
    assert len(calls) == 4                     # 37 rows in batches of 10
    check(got, np.asarray(jm(x, diag=True)))
    monkeypatch.undo()
    got = compute_gram_diag(tm, x[:len(z)], z, device="cpu", batch_size=B,
                            progress=False)
    check(got, np.asarray(jm(x[:len(z)], z, diag=True)))


def test_tile_dispatch(data, monkeypatch):
    """Megakernel-shaped models send every full tile to pair_tile; the
    diagonal-only path and other models send none."""
    calls = []
    orig = megakernel.pair_tile
    monkeypatch.setattr(megakernel, "pair_tile",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    x, z = data
    got = gram_in_memory(convnet(T), x, z, device="cpu", batch_size=B,
                         progress=False)
    assert len(calls) == 4 * 3
    gram_in_memory(strided(T), x, device="cpu", batch_size=B,
                   progress=False)
    compute_gram_diag(convnet(T), x, device="cpu", batch_size=B,
                      progress=False)
    assert len(calls) == 4 * 3
    want = np.full_like(got, np.nan)
    tx, tz = torch.from_numpy(x), torch.from_numpy(z)
    with torch.no_grad():
        for i0 in range(0, len(x), B):
            for j0 in range(0, len(z), B):
                want[i0:i0 + B, j0:j0 + B] = T.apply_kernel(
                    convnet(T), tx[i0:i0 + B], tz[j0:j0 + B], False,
                    False).numpy()
    check(got, want)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_store_opens_in_the_other_package(writer, data, tmp_path):
    x, z = data
    path = str(tmp_path / f"{writer}.h5")
    if writer == "torch":
        with TStore(path, "w") as s:
            save_K(s, strided(T), "Kxx", x, None, diag=False, batch_size=B,
                   device="cpu")
            save_K(s, strided(T), "Kv_diag", z, None, diag=True,
                   batch_size=B, device="cpu")
        Reader = JStore
    else:
        from cnn_gp_tpu.parallel import save_K as jsave
        with JStore(path, "w") as s:
            jsave(s, strided(G), "Kxx", x, None, diag=False, batch_size=B)
            jsave(s, strided(G), "Kv_diag", z, None, diag=True,
                  batch_size=B)
        Reader = TStore
    with Reader(path, "r") as s:
        assert sorted(s.dataset_names()) == ["Kv_diag", "Kxx"]
        assert s.f["Kxx"].shape == (1, 37, 37)
        assert s.f["Kxx"].chunks == (1, B, B)
        assert np.isnan(s.f["Kxx"].fillvalue)
        assert s.batch_size("Kxx") == B
        done = s.done_mask("Kxx")
        np.testing.assert_array_equal(done, np.triu(np.ones((4, 4))))
        np.testing.assert_array_equal(s.done_mask("Kv_diag"), np.ones(3))
        kxx = s.read("Kxx")
        s.assert_complete("Kxx", upper_triangle_only=True)
        assert np.isnan(kxx[20:30, 0:10]).all()    # sub-diagonal tile
    iu = np.triu_indices(37)
    want = jax_in_memory(strided(G), x, batch_size=B)
    assert np.abs(kxx[iu] - want[iu]).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_mid_run(writer, data, tmp_path, monkeypatch):
    """A run that dies after some tiles leaves them marked done; a port
    rerun computes only the rest and ends with the complete Gram."""
    x, _ = data
    path = str(tmp_path / "resume.h5")
    Store = TStore if writer == "torch" else JStore
    real_write = Store.write_tile
    n_written = []

    def dying_write(self, name, i, j, block):
        if len(n_written) == 4:
            raise OSError("disk full")
        n_written.append((i, j))
        real_write(self, name, i, j, block)

    monkeypatch.setattr(Store, "write_tile", dying_write)
    with Store(path, "w") as s:
        with pytest.raises(OSError, match="disk full"):
            if writer == "torch":
                compute_gram(strided(T), x, device="cpu", batch_size=B,
                             store=s, name="Kxx", progress=False)
            else:
                jgram(strided(G), x, batch_size=B, store=s, name="Kxx",
                      progress=False, tiles_per_round=1)
    monkeypatch.setattr(Store, "write_tile", real_write)

    computed = []
    real_body = tgram_mod._tile_body

    def spy(model, spec, x_all, z_all, i0, j0, *rest):
        computed.append((i0, j0))
        return real_body(model, spec, x_all, z_all, i0, j0, *rest)

    monkeypatch.setattr(tgram_mod, "_tile_body", spy)
    with TStore(path, "a") as s:
        assert int(s.done_mask("Kxx").sum()) == 4
        compute_gram(strided(T), x, device="cpu", batch_size=B, store=s,
                     name="Kxx", progress=False)
        s.assert_complete("Kxx", upper_triangle_only=True)
        kxx = s.read("Kxx")
    assert len(computed) == 10 - 4
    assert not set(computed) & set(n_written)
    iu = np.triu_indices(37)
    want = jax_in_memory(strided(G), x, batch_size=B)
    assert np.abs(kxx[iu] - want[iu]).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("merger", ["torch", "jax"])
def test_merge_shards_across_packages(merger, data, tmp_path):
    """Worker 0 of 2 writes with the port, worker 1 with the JAX package;
    either package's merge_stores completes the Gram."""
    x, _ = data
    p0, p1 = str(tmp_path / "00.h5"), str(tmp_path / "01.h5")
    with TStore(p0, "w") as s:
        compute_gram(strided(T), x, device="cpu", batch_size=B, store=s,
                     name="Kxx", worker_rank=0, n_workers=2, progress=False)
    with JStore(p1, "w") as s:
        jgram(strided(G), x, batch_size=B, store=s, name="Kxx",
              worker_rank=1, n_workers=2, progress=False)
    (tmerge if merger == "torch" else jmerge)(p0, [p1])
    with TStore(p0, "r") as s:
        s.assert_complete("Kxx", upper_triangle_only=True)
        np.testing.assert_array_equal(s.done_mask("Kxx"),
                                      np.triu(np.ones((4, 4))))
        kxx = s.read("Kxx")
    iu = np.triu_indices(37)
    want = jax_in_memory(strided(G), x, batch_size=B)
    assert np.abs(kxx[iu] - want[iu]).max() / np.abs(want).max() < 1e-5


def test_non_finite_tile_refused_and_not_marked(data, tmp_path):
    x, _ = data
    bad = x.copy()
    bad[12] = np.nan
    path = str(tmp_path / "nan.h5")
    with TStore(path, "w") as s:
        with pytest.raises(FloatingPointError, match="non-finite"):
            compute_gram(strided(T), bad, device="cpu", batch_size=B,
                         store=s, name="Kxx", progress=False)
        assert not s.tile_done("Kxx", 10, 10)
        assert not s.tile_done("Kxx", 0, 10)
        assert s.tile_done("Kxx", 0, 0)


def test_write_queue_phases(data, tmp_path):
    """The write queue's legs are spans: per tile the consumer thread's
    gram.fetch, gram.scan and gram.write, under the call's gram.call, and
    the producer's gram.blocked waits, each with a non-negative wall."""
    x, _ = data
    with timing.recording() as found:
        with TStore(str(tmp_path / "p.h5"), "w") as s:
            compute_gram(strided(T), x, device="cpu", batch_size=B,
                         store=s, name="Kxx", progress=False)
    call, = [sp for sp in found if sp.name == "gram.call"]
    for leg in ("gram.fetch", "gram.scan", "gram.write"):
        legs = [sp for sp in found if sp.name == leg]
        assert len(legs) == call.attrs["tiles"]
        assert all(sp.parent == call.id and sp.thread != call.thread
                   for sp in legs)
    blocked = [sp for sp in found if sp.name == "gram.blocked"]
    assert blocked and all(sp.thread == call.thread for sp in blocked)
    assert all(sp.seconds >= 0.0 for sp in found)


def test_scheduler_matches_jax():
    from cnn_gp_tpu.parallel import scheduler as js
    from cnn_gp_tpu_torch.parallel import scheduler as ts
    for n1, n2, b, sym in ((37, 37, 10, True), (37, 23, 10, False),
                           (128, 512, 128, False)):
        for w in (1, 3):
            for r in range(w):
                np.testing.assert_array_equal(
                    ts.worker_manifest(n1, n2, b, sym, r, w),
                    js.worker_manifest(n1, n2, b, sym, r, w))

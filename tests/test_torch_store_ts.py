"""The port's TensorStore/Zarr Gram store (``data/store_ts.py``): one
counterpart of each case of tests/test_store_ts.py, and stores written by
either package read by the other (values, completion bitmap, batch_size,
array metadata)."""

import json

import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")

import cnn_gp_tpu as G  # noqa: E402
from cnn_gp_tpu.data import TensorStoreGramStore as JStore  # noqa: E402
from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential  # noqa: E402
from cnn_gp_tpu_torch.data import (GramStore, TensorStoreGramStore,  # noqa
                                   open_store, synthetic_arrays)
from cnn_gp_tpu_torch.parallel import compute_gram  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return Sequential(Conv2d(3), ReLU(), Conv2d(7, padding=0))


def test_create_write_read_roundtrip(tmp_path):
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kxx", 25, None, 10)
        blk = np.arange(100, dtype=np.float32).reshape(10, 10)
        store.write_tile("Kxx", 0, 10, blk)
        out = store.read("Kxx")
        np.testing.assert_array_equal(out[0:10, 10:20], blk)
        assert np.isnan(out[0:10, 0:10]).all()  # NaN fill
        assert store.tile_done("Kxx", 0, 10)
        assert not store.tile_done("Kxx", 0, 0)


def test_missing_tiles_and_assert(tmp_path):
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kxx", 20, None, 10)
        assert len(store.missing_tiles("Kxx", upper_triangle_only=True)) == 3
        with pytest.raises(RuntimeError):
            store.assert_complete("Kxx")


def test_diag_dataset(tmp_path):
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kv_diag", 25, None, 10, diag=True)
        store.write_tile("Kv_diag", 20, None, np.ones(5, np.float32))
        assert store.tile_done("Kv_diag", 20, None)
        out = store.read("Kv_diag")
        np.testing.assert_array_equal(out[20:], np.ones(5))


def test_gram_assembly_into_zarr(tmp_path):
    """The port's compute_gram writing to the zarr backend: the upper
    triangle bit for bit an in-memory assembly's, within 1e-5 of value
    scale of the JAX model's Gram."""
    x, _, _, _ = synthetic_arrays(n_train=27, n_test=0, shape=(1, 7, 7))
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        compute_gram(_model(), x, device=CPU, batch_size=10, store=store,
                     name="Kxx", progress=False)
        store.assert_complete("Kxx", upper_triangle_only=True)
        out = store.read("Kxx")
    mem = np.full((27, 27), np.nan, np.float32)
    compute_gram(_model(), x, device=CPU, batch_size=10, out=mem,
                 symmetrize_out=False, progress=False)
    iu = np.triu_indices(27)
    np.testing.assert_array_equal(out[iu], mem[iu])
    want = np.asarray(G.Sequential(G.Conv2d(3), G.ReLU(),
                                   G.Conv2d(7, padding=0))(x))
    assert np.abs(out[iu] - want[iu]).max() <= 1e-5 * np.abs(want).max()


def test_concurrent_workers_one_store(tmp_path):
    """Two workers write disjoint tile spans into the SAME zarr store: no
    merge step."""
    x, _, _, _ = synthetic_arrays(n_train=33, n_test=0, shape=(1, 7, 7))
    path = str(tmp_path / "g")
    for rank in range(2):
        with TensorStoreGramStore(path) as store:
            compute_gram(_model(), x, device=CPU, batch_size=10,
                         store=store, name="Kxx", worker_rank=rank,
                         n_workers=2, progress=False)
    with TensorStoreGramStore(path) as store:
        store.assert_complete("Kxx", upper_triangle_only=True)


def test_open_store_backend_selection(tmp_path):
    s1 = open_store(str(tmp_path / "a.h5"), "w")
    assert isinstance(s1, GramStore)
    s1.close()
    s2 = open_store(str(tmp_path / "b.zarr"))
    assert isinstance(s2, TensorStoreGramStore)
    s2.close()
    s3 = open_store(str(tmp_path / "c.h5"), "w", backend="zarr")
    assert isinstance(s3, TensorStoreGramStore)
    s3.close()
    with pytest.raises(ValueError, match="unknown store backend"):
        open_store(str(tmp_path / "d"), backend="n5")


def test_mode_w_truncates(tmp_path):
    path = str(tmp_path / "g")
    with TensorStoreGramStore(path, "w") as store:
        store.create("Kxx", 20, None, 10)
        store.write_tile("Kxx", 0, 0, np.ones((10, 10), np.float32))
    with TensorStoreGramStore(path, "w") as store:
        store.create("Kxx", 20, None, 10)
        assert not store.tile_done("Kxx", 0, 0)
        assert np.isnan(store.read("Kxx")).all()


def test_url_kvstore_form():
    with TensorStoreGramStore("memory://grams_test") as store:
        store.create("Kxx", 20, None, 10)
        store.write_tile("Kxx", 0, 10, np.ones((10, 10), np.float32))
        assert store.tile_done("Kxx", 0, 10)
        assert store.read("Kxx")[0, 10] == 1.0


def test_done_mask_bulk_read(tmp_path):
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kxx", 30, None, 10)
        store.write_tile("Kxx", 10, 20, np.ones((10, 10), np.float32))
        mask = store.done_mask("Kxx")
        assert mask.shape == (3, 3)
        assert mask[1, 2] == 1 and mask.sum() == 1


def test_mode_w_truncates_url_store(tmp_path):
    url = f"file://{tmp_path}/g"
    with TensorStoreGramStore(url, "w") as store:
        store.create("Kxx", 20, None, 10)
        store.write_tile("Kxx", 0, 0, np.ones((10, 10), np.float32))
    with TensorStoreGramStore(url, "w") as store:
        store.create("Kxx", 20, None, 10)
        assert not store.tile_done("Kxx", 0, 0)
        assert np.isnan(store.read("Kxx")).all()


def test_race_loser_does_not_clobber_attrs(tmp_path):
    path = str(tmp_path / "g")
    with TensorStoreGramStore(path) as store:
        store.create("Kxx", 40, None, 10)
    with TensorStoreGramStore(path) as store2:
        with pytest.raises(ValueError, match="batch_size=10"):
            store2.create("Kxx", 40, None, 20)
    with TensorStoreGramStore(path) as store3:
        assert store3.batch_size("Kxx") == 10   # attrs intact


def test_foreign_array_without_bitmap(tmp_path):
    path = str(tmp_path / "g")
    ts.open({"driver": "zarr",
             "kvstore": {"driver": "file", "path": f"{path}/Kxx"},
             "metadata": {"shape": [20, 20], "chunks": [10, 10],
                          "dtype": "<f4", "fill_value": float("nan")},
             "create": True}).result()
    with TensorStoreGramStore(path, "r") as ro:
        assert ro.done_mask("Kxx").sum() == 0
        assert not ro.tile_done("Kxx", 0, 0)
        with pytest.raises(PermissionError):
            ro.write_tile("Kxx", 0, 0, np.ones((10, 10), np.float32))
    with TensorStoreGramStore(path) as store:
        store.create("Kxx", 20, None, 10)     # resume onto foreign array
        assert store.done_mask("Kxx").sum() == 0
        store.write_tile("Kxx", 0, 10, np.ones((10, 10), np.float32))
        assert store.tile_done("Kxx", 0, 10)


def test_dataset_names_url_store(tmp_path):
    with TensorStoreGramStore(f"file://{tmp_path}/g", "w") as store:
        store.create("Kxx", 10, None, 5)
        store.create("Kv_diag", 10, None, 5, diag=True)
        assert sorted(store.dataset_names()) == ["Kv_diag", "Kxx"]
    with TensorStoreGramStore(str(tmp_path / "h"), "w") as store:
        store.create("Kxx", 10, None, 5)
        assert list(store.dataset_names()) == ["Kxx"]


def test_upper_triangle_scan_matches_full(tmp_path):
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kxx", 30, None, 10)
        store.write_tile("Kxx", 0, 0, np.ones((10, 10), np.float32))
        store.write_tile("Kxx", 10, 20, np.ones((10, 10), np.float32))
        full = {tuple(t) for t in store.missing_tiles("Kxx")}
        upper = {tuple(t) for t in
                 store.missing_tiles("Kxx", upper_triangle_only=True)}
        assert upper == {t for t in full if t[1] >= t[0]}
        assert (10, 0) in full and (10, 0) not in upper


def test_h5_readonly_foreign_file_bitmap(tmp_path):
    import h5py
    path = str(tmp_path / "ref.h5")
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("Kxx", shape=(1, 20, 20), dtype=np.float32,
                              fillvalue=np.nan, chunks=(1, 10, 10))
        ds.attrs["batch_size"] = 10
    with open_store(path, "r") as store:
        assert store.done_mask("Kxx").sum() == 0
        assert not store.tile_done("Kxx", 0, 10)
        assert len(store.missing_tiles("Kxx")) == 4


def test_read_rows_matches_read(tmp_path):
    """read_rows, the streamed classify path's producer, against read."""
    with TensorStoreGramStore(str(tmp_path / "g")) as store:
        store.create("Kxx", 25, None, 10)
        blk = np.arange(100, dtype=np.float32).reshape(10, 10)
        store.write_tile("Kxx", 10, 0, blk)
        full = store.read("Kxx")
        np.testing.assert_array_equal(store.read_rows("Kxx", 8, 21),
                                      full[8:21])
        out = np.empty((5, 25), np.float32)
        assert store.read_rows("Kxx", 10, 15, out) is out
        np.testing.assert_array_equal(out, full[10:15])
        assert store.shape("Kxx") == (25, 25)


# -- across the packages ----------------------------------------------------

def _fill(store_cls, path):
    rng = np.random.RandomState(5)
    blocks = {(0, 10): rng.rand(10, 10).astype(np.float32),
              (20, 20): rng.rand(5, 5).astype(np.float32)}
    diag = rng.rand(5).astype(np.float32)
    with store_cls(path, "w") as s:
        s.create("Kxx", 25, None, 10)
        for (i, j), blk in blocks.items():
            s.write_tile("Kxx", i, j, blk)
        s.create("Kxvx", 7, 25, 10)
        s.write_tile("Kxvx", 0, 20, blocks[20, 20][:5])
        s.create("Kv_diag", 25, None, 10, diag=True)
        s.write_tile("Kv_diag", 20, None, diag)
    return blocks, diag


@pytest.mark.parametrize("writer,reader", [(TensorStoreGramStore, JStore),
                                           (JStore, TensorStoreGramStore)],
                         ids=["port_to_jax", "jax_to_port"])
def test_store_cross_read(writer, reader, tmp_path):
    """A store written by one package reads in the other: values, NaN
    holes, done bitmaps, batch_size, shapes, names."""
    path = str(tmp_path / "g")
    blocks, diag = _fill(writer, path)
    with reader(path, "r") as s:
        assert sorted(s.dataset_names()) == ["Kv_diag", "Kxvx", "Kxx"]
        k = s.read("Kxx")
        for (i, j), blk in blocks.items():
            np.testing.assert_array_equal(k[i:i + len(blk), j:j + len(blk)],
                                          blk)
        assert np.isnan(k).sum() == 25 * 25 - 100 - 25
        mask = s.done_mask("Kxx")
        assert mask.shape == (3, 3) and mask.dtype == np.uint8
        assert {tuple(t) for t in np.argwhere(mask)} == {(0, 1), (2, 2)}
        assert s.batch_size("Kxx") == 10 and s.batch_size("Kxvx") == 10
        assert s.shape("Kxvx") == (7, 25)
        assert s.done_mask("Kxvx").tolist() == [[0, 0, 1]]
        np.testing.assert_array_equal(s.read("Kv_diag")[20:], diag)
        assert s.done_mask("Kv_diag").tolist() == [0, 0, 1]
        assert len(s.missing_tiles("Kxx", upper_triangle_only=True)) == 4


def test_store_metadata_equal_across_packages(tmp_path):
    """Both packages write the same .zarray (zarr v2, blosc-lz4, NaN
    fill, [bs, bs] chunks), the same .zattrs, and a |u1 bitmap with one
    chunk per bit."""
    for cls, name in ((TensorStoreGramStore, "port"), (JStore, "jax")):
        with cls(str(tmp_path / name), "w") as s:
            s.create("Kxx", 25, 13, 10)

    def meta(name, rel):
        with open(tmp_path / name / rel) as f:
            return json.load(f)

    for rel in ("Kxx/.zarray", "Kxx/.zattrs", "_done/Kxx/.zarray"):
        assert meta("port", rel) == meta("jax", rel), rel
    arr = meta("port", "Kxx/.zarray")
    assert arr["zarr_format"] == 2 and arr["chunks"] == [10, 10]
    assert arr["compressor"]["id"] == "blosc"
    assert arr["compressor"]["cname"] == "lz4"
    assert meta("port", "Kxx/.zattrs") == {"batch_size": 10}
    done = meta("port", "_done/Kxx/.zarray")
    assert done["dtype"] == "|u1" and done["chunks"] == [1, 1]
    assert done["shape"] == [3, 2]


def test_missing_tensorstore_raises(monkeypatch, tmp_path):
    """Without tensorstore the zarr backend raises ImportError; the
    module itself imports without it."""
    import sys
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore is required"):
        TensorStoreGramStore(str(tmp_path / "g"))
    with pytest.raises(ImportError, match="tensorstore is required"):
        open_store(str(tmp_path / "g.zarr"))

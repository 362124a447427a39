"""Workers that create one Zarr store at the same moment.

``save_kernel``'s ranks leave their rendezvous together and each creates
the store's datasets (``TensorStoreGramStore.create``): one wins each
array's creation and then writes its ``.zattrs`` (the batch size), the
other opens the winner's array and reads them.  The attributes used to
be written in place, so the loser could read the file opened and not yet
written: ``json.JSONDecodeError``, the rank dead, and the two-process
assembly of ``tests/test_torch_multihost.py`` red on a loaded machine
(under 1% of races on an idle one).  They are now written to a temporary
file and renamed into place, and a loser that finds no attributes yet
holds the array's chunk grid to the one it would create, without
caching their absence."""

import multiprocessing
import os

import pytest

pytest.importorskip("tensorstore")

import _torch_dist_worker as W  # noqa: E402
from cnn_gp_tpu_torch.data import TensorStoreGramStore  # noqa: E402

RACES = 200   # ~13 s; the old writer lost about 1% of them


class _Probe:
    """A file that records, at each write, whether ``target`` exists."""

    def __init__(self, f, target, seen):
        self.f, self.target, self.seen = f, target, seen

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self.f.__exit__(*exc)

    def write(self, data):
        self.seen.append(os.path.exists(self.target))
        return self.f.write(data)


def test_attrs_are_written_whole_or_not_at_all(tmp_path, monkeypatch):
    """While the payload is written the attributes' path does not exist;
    afterwards it holds the whole payload and no temporary file is
    left."""
    path = str(tmp_path / "g")
    target = os.path.join(path, "Kxx", ".zattrs")
    seen, fdopen = [], os.fdopen
    monkeypatch.setattr(os, "fdopen", lambda fd, *a, **k: _Probe(
        fdopen(fd, *a, **k), target, seen))
    with TensorStoreGramStore(path) as store:
        store.create("Kxx", 40, None, 10)
    assert seen == [False]
    with open(target) as f:
        assert f.read() == '{"batch_size": 10}'
    assert not [n for n in os.listdir(os.path.dirname(target))
                if n.startswith(".zattrs.")]


@pytest.mark.parametrize("n", [40, 8])
def test_loser_before_the_winners_attrs(tmp_path, n):
    """The loser opens the winner's array before its attributes exist:
    the same chunk grid passes (also when the dataset is narrower than a
    tile, where the old chunk-size fallback raised), a batch size that
    tiles it otherwise raises, and once the winner has written them the
    loser reads the real batch size (their absence was not cached)."""
    path = str(tmp_path / "g")
    winner, loser = TensorStoreGramStore(path), TensorStoreGramStore(path)
    write = winner._write_attrs
    order = []

    def late_write(name, attrs):
        order.append("loser")
        loser.create("Kxx", n, None, 10)    # the array, no attrs yet
        with pytest.raises(ValueError, match="batch_size"):
            TensorStoreGramStore(path).create("Kxx", n, None, 5)
        order.append("winner")
        write(name, attrs)

    winner._write_attrs = late_write
    winner.create("Kxx", n, None, 10)
    assert order == ["loser", "winner"]
    assert loser.batch_size("Kxx") == winner.batch_size("Kxx") == 10


def test_two_processes_create_one_store_at_once(tmp_path):
    """Two processes create save_kernel's three datasets in RACES fresh
    stores, each time released together by a barrier: no creation
    fails."""
    ctx = multiprocessing.get_context("spawn")
    barrier, errors = ctx.Barrier(2), ctx.Queue()
    procs = [ctx.Process(target=W.race_creates,
                         args=(r, str(tmp_path), RACES, barrier, errors))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = [errors.get(timeout=W.JOIN_S) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    failed = [e for rank in got for e in rank]
    assert not failed, f"{len(failed)} of {2 * RACES}: {failed[:5]}"

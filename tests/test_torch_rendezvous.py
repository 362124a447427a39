"""Local worlds meet on a port that nothing else can take.

The multi-rank tests and ``entry.spawn_ranks`` used to probe a free port
(bind to port 0, close) and hand it to rank 0, whose TCPStore bound it
seconds later, after a process start and ``import torch``.  In between,
any other socket of the machine could take it: rank 0 then failed with
EADDRINUSE while its peers waited, or they met another group's store.
``entry.reserved_port`` holds the port, bound with ``SO_REUSEADDR`` and
never listened on, until the group has ended: the kernel gives it to no
other socket, an explicit bind of it fails, and rank 0's TCPStore still
listens on it.  Two worlds spawned at once, and a command-line group
next to them, each meet their own ranks."""

import datetime
import errno
import os
import socket
import sys
import threading

import numpy as np
import pytest
import torch.distributed as dist

import _torch_dist_worker as W
from cnn_gp_tpu_torch.entry import reserved_port


def test_a_reserved_port_goes_to_no_other_socket():
    """While held, no bind to port 0 gets the port, an explicit bind of
    it fails with EADDRINUSE, and a TCPStore (what rank 0 runs) listens
    on it and serves a client."""
    with reserved_port() as port:
        others = []
        try:
            for _ in range(500):
                s = socket.socket()
                others.append(s)
                s.bind(("127.0.0.1", 0))
            assert port not in {s.getsockname()[1] for s in others}
        finally:
            for s in others:
                s.close()
        with socket.socket() as s, pytest.raises(OSError) as err:
            s.bind(("127.0.0.1", port))
        assert err.value.errno == errno.EADDRINUSE
        timeout = datetime.timedelta(seconds=W.TIMEOUT_S)
        server = dist.TCPStore("127.0.0.1", port, 2, is_master=True,
                               wait_for_workers=False, timeout=timeout)
        client = dist.TCPStore("127.0.0.1", port, 2, is_master=False,
                               timeout=timeout)
        client.set("k", "v")
        assert server.get("k") == b"v"
        del client, server


def test_a_released_port_is_free_again():
    """The port is held for the ``with`` block only."""
    with reserved_port() as port:
        pass
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


def test_worlds_spawned_at_once_meet_their_own_ranks(tmp_path):
    """Two worlds of two ranks spawned at the same moment through
    ``entry.spawn_ranks``, and a command-line group of two beside them:
    every rank joins its own group (the sums are each group's) and every
    process ends."""
    dirs = [tmp_path / f"world{i}" for i in range(2)]
    results, errors = [None, None], []

    def world(i):
        dirs[i].mkdir()
        try:
            results[i] = W.run_world(2, "ping", str(dirs[i]))
        except BaseException as err:   # noqa: BLE001  (re-raised below)
            errors.append(err)

    threads = [threading.Thread(target=world, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    code = ("import sys, torch, torch.distributed as dist\n"
            "from cnn_gp_tpu_torch.parallel import multihost\n"
            "multihost.initialize(sys.argv[1], 2, int(sys.argv[2]), "
            "device='cpu')\n"
            "t = torch.tensor([float(dist.get_rank() + 1)])\n"
            "dist.all_reduce(t)\n"
            "print('sum', float(t), flush=True)\n"
            "multihost.shutdown()\n")
    with reserved_port() as port:
        outs = W.launch([("cli", r, [sys.executable, "-c", code,
                                     f"127.0.0.1:{port}", str(r)])
                         for r in range(2)], str(tmp_path),
                        env=dict(os.environ, OMP_NUM_THREADS="1"))
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    assert all("sum 3.0" in out for out in outs), outs
    for res in results:
        assert [int(r["rank"]) for r in res] == [0, 1]
        for r in res:
            assert int(r["size"]) == 2
            np.testing.assert_array_equal(r["sum"], [3.0])

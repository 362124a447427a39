"""The port's spans (cnn_gp_tpu_torch.utils.timing) on the CPU: off by
default, on inside ``recording()`` and under ``torch.profiler``, on the
profiler's clock, and at the Gram and fit layers' boundaries: parents and
call ids across ``compute_gram``'s consumer thread, one ``gram.tile`` a
tile, the rounds of ``compute_gram_sharded``, and ``fit_large``'s steps
with their phases."""

import datetime
import os
import time
import tracemalloc
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import cnn_gp_tpu_torch as T
from cnn_gp_tpu_torch import fit_lib as tfit
from cnn_gp_tpu_torch.entry import reserved_port
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.parallel import (compute_gram, gram_in_memory,
                                       multihost, scheduler)
from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
from cnn_gp_tpu_torch.parallel.gram_sharded import compute_gram_sharded
from cnn_gp_tpu_torch.parallel.mesh import make_mesh
from cnn_gp_tpu_torch.utils import timing

CPU = torch.device("cpu")
B = 10
STEP_PHASES = ("fit.gram", "fit.host_f64", "fit.grad_vjp")
HOST_F64 = tuple(f"fit.host_f64.{n}" for n in
                 ("copy", "cho_factor", "cho_solve", "dpotri", "cotangent"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_store():
    timing.clear()
    yield
    timing.clear()


def strided():
    """Not megakernel-shaped: each tile through apply_kernel."""
    return T.Sequential(T.Conv2d(3), T.ReLU(), T.Conv2d(3, stride=2),
                        T.ReLU(), T.Conv2d(7, padding=0))


def convnet(learnable=False):
    """Megakernel-shaped: one pre-pass per image set, pair_tile a tile."""
    return T.Sequential(
        T.Conv2d(3, var_weight=2.0, var_bias=0.5, learnable=learnable),
        T.ReLU(),
        T.Conv2d(14, padding=0, var_weight=1.5, var_bias=0.1,
                 learnable=learnable))


def images(n, seed=0):
    return np.random.default_rng(seed).random((n, 1, 14, 14),
                                              dtype=np.float32)


def by_name(found, name):
    return [s for s in found if s.name == name]


def test_off_by_default():
    """Without a profiler or a recording block a span is the shared
    do-nothing context: no Span made, nothing stored, no record_function,
    no memory allocated."""
    assert not timing.on()
    first = next(timing._ids)
    with mock.patch.object(torch.autograd.profiler, "record_function",
                           side_effect=AssertionError("opened")):
        assert timing.span("gram.tile", i0=0, j0=0) is timing._OFF
        compute_gram(strided(), images(23), device=CPU, batch_size=B,
                     progress=False)
        gram_device(convnet(), images(23), batch_size=B, device=CPU)
        with timing.span("x") as s:
            s.set(accepted=True)
        tracemalloc.start()
        try:
            for _ in range(10_000):
                with timing.span("gram.tile"):
                    pass
            _, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
    assert peak < 1024
    assert timing.spans() == []
    assert next(timing._ids) == first + 1


def test_recording_block_keeps_its_own_spans():
    """A recording() block gets the spans finished inside it, nested
    with parents and the outermost span's id as their call; the store
    (the profiler's) stays empty, and a nested block sees its part."""
    with timing.recording() as outer:
        assert timing.on()
        with timing.span("a", k=1) as a:
            with timing.recording() as inner:
                with timing.span("b") as b:
                    b.set(done=True)
    assert not timing.on()
    assert [s.name for s in outer] == ["b", "a"]
    assert [s.name for s in inner] == ["b"]
    assert (a.parent, a.call, a.attrs) == (None, a.id, {"k": 1})
    assert (b.parent, b.call, b.attrs) == (a.id, a.id, {"done": True})
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert timing.spans() == []


def test_profiler_records_on_its_clock():
    """Under a CPU-activity profiler spans record into the store and open
    record_function: the name is in prof.events(), and the span's
    time_ns start lies within 1 ms of the Kineto event's start_ns()."""
    with timing.span("warm"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timing.span("trace.probe", n=3):
                torch.ones(64).sum()
    found = by_name(timing.spans(), "trace.probe")
    assert len(found) == 3 and all(s.attrs == {"n": 3} for s in found)
    assert sum(e.name == "trace.probe" for e in prof.events()) == 3
    kineto = sorted(e.start_ns() for e in
                    prof.profiler.kineto_results.events()
                    if e.name() == "trace.probe")
    assert len(kineto) == 3
    for s, k in zip(sorted(found, key=lambda s: s.start_ns), kineto):
        assert abs(s.start_ns - k) < 1_000_000, (s.start_ns, k)
    timing.clear()
    assert timing.spans() == []


def test_compute_gram_consumer_thread():
    """compute_gram's consumer-thread spans (fetch, scan, write a tile)
    have the producer's gram.call as parent and call; the producer's
    gram.prepass, gram.tile and gram.blocked spans hang under it too; the
    call's attrs give the entry, the sizes, the tiles and the launch
    counters' change; the progress line is read from the spans."""
    x, z = images(37), images(23, seed=5)
    for model in (strided(), convnet()):
        for zz in (None, z):
            with timing.recording() as found:
                compute_gram(model, x, zz, device=CPU, batch_size=B,
                             progress=False)
            call, = by_name(found, "gram.call")
            n2 = 37 if zz is None else 23
            tiles = len(list(scheduler.tile_offsets(37, n2, B, zz is None)))
            assert call.attrs["entry"] == "compute_gram"
            assert (call.attrs["n1"], call.attrs["n2"], call.attrs["b"],
                    call.attrs["tiles"]) == (37, n2, B, tiles)
            assert call.attrs["megakernel.launches"] == 0   # no card here
            for leg in ("gram.fetch", "gram.scan", "gram.write"):
                legs = by_name(found, leg)
                assert len(legs) == tiles
                for s in legs:
                    assert (s.parent, s.call) == (call.id, call.id)
                    assert s.thread != call.thread
                    assert call.start_ns <= s.start_ns <= s.end_ns \
                        <= call.end_ns
            for name in ("gram.tile", "gram.blocked", "gram.prepass"):
                for s in by_name(found, name):
                    assert (s.parent, s.call) == (call.id, call.id)
                    assert s.thread == call.thread
            assert len(by_name(found, "gram.prepass")) == (
                megakernel.match(model) is not None)


def test_compute_gram_progress_line(capsys):
    compute_gram(strided(), images(37), device=CPU, batch_size=B,
                 progress=True, desc="Kxx")
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[Kxx]")][-1]
    assert "M entries/s: total" in line and "dispatch" in line
    for leg in ("'fetch'", "'scan'", "'write'", "'blocked'"):
        assert leg in line
    assert timing.spans() == []


@pytest.mark.parametrize("entry", ["gram_device", "compute_gram"])
@pytest.mark.parametrize("cross", [False, True])
def test_one_tile_span_per_tile(entry, cross):
    """gram_device and compute_gram record one gram.tile per tile of
    scheduler.tile_offsets, in its order, with its (i0, j0)."""
    x, z = images(37), (images(23, seed=5) if cross else None)
    n2 = 23 if cross else 37
    want = list(scheduler.tile_offsets(37, n2, B, not cross))
    with timing.recording() as found:
        if entry == "gram_device":
            gram_device(convnet(), x, z, batch_size=B, device=CPU)
        else:
            compute_gram(convnet(), x, z, device=CPU, batch_size=B,
                         progress=False)
    tiles = by_name(found, "gram.tile")
    assert [(s.attrs["i0"], s.attrs["j0"]) for s in tiles] == want
    call, = by_name(found, "gram.call")
    assert call.attrs["entry"] == entry and call.attrs["tiles"] == len(want)
    assert all(s.parent == call.id for s in tiles)
    assert len(by_name(found, "gram.prepass")) == 1


def _one_rank_gloo():
    with reserved_port() as port:
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "RANK": "0", "WORLD_SIZE": "1"}
        with mock.patch.dict(os.environ, env):
            multihost.initialize("env", device="cpu",
                                 timeout=datetime.timedelta(seconds=60))


def test_sharded_rounds_on_one_gloo_rank(capsys):
    """compute_gram_sharded on a one-rank gloo group: a gram.round per
    round holding its tiles and its all_gather (the gathered bytes), the
    previous round's wait and write inside the next round, the last
    drain under the call; the same Gram as compute_gram; the progress
    line from the spans."""
    x = images(37)
    want = gram_in_memory(strided(), x, device=CPU, batch_size=B,
                          progress=False)
    _one_rank_gloo()
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None
        with timing.recording() as found:
            got = compute_gram_sharded(strided(), x, batch_size=B,
                                       mesh=mesh, progress=True,
                                       tiles_per_round_per_device=3,
                                       name="Kxx")
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want)
    call, = by_name(found, "gram.call")
    n_tiles = len(list(scheduler.tile_offsets(37, 37, B, True)))
    assert call.attrs["entry"] == "compute_gram_sharded"
    assert call.attrs["tiles"] == n_tiles
    rounds = by_name(found, "gram.round")
    assert [s.attrs["r0"] for s in rounds] == list(range(0, n_tiles, 3))
    assert all(s.parent == call.id for s in rounds)
    ids = [s.id for s in rounds]
    for k, rnd in enumerate(rounds):
        kids = [s for s in found if s.parent == rnd.id]
        tiles = [s for s in kids if s.name == "gram.tile"]
        assert len(tiles) == min(3, n_tiles - 3 * k)
        gather, = [s for s in kids if s.name == "gram.all_gather"]
        assert gather.attrs["bytes"] == len(tiles) * B * B * 4
        drains = sorted(s.name for s in kids
                        if s.name in ("gram.wait", "gram.write"))
        assert drains == ([] if k == 0 else ["gram.wait", "gram.write"])
    last = [s.name for s in found if s.parent == call.id
            and s.name in ("gram.wait", "gram.write")]
    assert sorted(last) == ["gram.wait", "gram.write"]
    assert len([s for s in found if s.name == "gram.wait"
                and s.parent in ids]) == len(rounds) - 1
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("[Kxx]") and "over 1 rank(s)" in line
    for part in ("dispatch", "wait", "write"):
        assert part in line


def _fit_problem(n=32, classes=3, seed=1):
    rng = np.random.default_rng(seed)
    x = images(n, seed)
    y = -np.ones((n, classes), np.float32)
    y[np.arange(n), rng.integers(0, classes, n)] = 1.0
    return x, y


def test_fit_large_steps_under_profiler():
    """A profiled CPU fit_large of two exact steps stores two fit.step
    spans (attrs step, accepted), each with fit.gram, fit.host_f64 and
    fit.grad_vjp in that order, the five host_f64 children in theirs,
    and the children's sum no more than the parent."""
    x, y = _fit_problem()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfit.fit_large(convnet(learnable=True), x, y, steps=2,
                       batch_size=16, device=CPU)
    found = timing.spans()
    steps = by_name(found, "fit.step")
    assert [(s.attrs["step"], s.attrs["accepted"]) for s in steps] == [
        (0, True), (1, True)]
    for step in steps:
        assert (step.parent, step.call) == (None, step.id)
        kids = sorted((s for s in found if s.parent == step.id),
                      key=lambda s: s.start_ns)
        assert tuple(s.name for s in kids) == STEP_PHASES
        assert sum(s.end_ns - s.start_ns for s in kids) <= \
            step.end_ns - step.start_ns
        host, = [s for s in kids if s.name == "fit.host_f64"]
        parts = sorted((s for s in found if s.parent == host.id),
                       key=lambda s: s.start_ns)
        assert tuple(s.name for s in parts) == HOST_F64
        assert sum(s.end_ns - s.start_ns for s in parts) <= \
            host.end_ns - host.start_ns
        assert all(s.call == step.id for s in kids + parts)
        gram_call, = [s for s in found if s.name == "gram.call"
                      and s.call == step.id]
        assert gram_call.parent == kids[0].id
    names = {e.name for e in prof.events()}
    assert set(STEP_PHASES + HOST_F64) | {"fit.step", "gram.call"} <= names


def test_fit_large_verbose_line_and_phases_view(capsys):
    """verbose prints each step's seconds and phases (the host_f64 split
    too) from the step's spans, and stores nothing; phases= is the three
    spans' seconds."""
    x, y = _fit_problem()
    t0 = time.perf_counter()
    tfit.fit_large(convnet(learnable=True), x, y, steps=2, batch_size=16,
                   verbose=True, device=CPU)
    wall = time.perf_counter() - t0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[fit_large] step")]
    assert len(lines) == 2
    for ln in lines:
        for key in ("'gram'", "'host_f64'", "'grad_vjp'",
                    "'host_f64.cho_factor'", "'host_f64.dpotri'"):
            assert key in ln
        assert 0.0 < float(ln.split("(")[1].split("s)")[0]) < wall
    assert timing.spans() == []
    phases = {}
    tfit.nmll_value_and_grad_tiled(convnet(learnable=True), x, y,
                                   batch_size=16, device=CPU, phases=phases)
    assert list(phases) == ["gram", "host_f64", "grad_vjp"]
    assert all(v >= 0.0 for v in phases.values())

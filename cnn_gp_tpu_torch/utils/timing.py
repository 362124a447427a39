"""Progress and timing: the printed progress line, and the program's
spans.

``print_timings`` wraps an iterator and prints `i/total it, it/s,
[elapsed<projected]` at most every ``print_interval`` seconds, one full
line per report so concurrent workers can interleave on one terminal (a
copy of ``cnn_gp_tpu/utils/timing.py``'s, which cannot be imported
without jax).  ``synced_clock`` is the host clock read after the
device's work, and ``FP32_PEAK`` the rate the scripts state their FP32
shares against.

Spans time the program's layers on the host, on the clock the profiler
stamps its events with (``time.time_ns()``, the realtime clock), so a
span can be laid on the same timeline as the card's kernels:

    with span("gram.tile", i0=i0, j0=j0):
        ...

A span records while a ``torch.profiler`` records (any activities:
``torch.autograd.profiler._is_profiler_enabled``) or while a
``recording()`` block is open in any thread.  Otherwise ``span`` returns
one shared do-nothing context after reading two flags: no allocation, no
torch call.  A span never synchronizes the card, so it times the host's
dispatch of the work, which is the work itself where the layer ends in a
copy to the host.  While a profiler records, a span also opens
``torch.profiler.record_function(name)``, so a trace with CPU activity
shows the program's spans above its operators; a CUDA-only trace gets no
event from it (the same kernels, and no span name among the device's
events, on the H100).

Each finished span is a :class:`Span`: its name, id, parent (the span
open on its thread when it began, or the span ``attached`` to that
thread), the id of the outermost span of its call (``call``, shared by
spans on other threads attached to it), its start and end in ns, its
attrs and its thread.  Spans finished under a profiler stay in memory
(``spans()`` returns a copy, ``clear()`` empties them); spans finished
inside a ``recording()`` block go to that block's list.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["print_timings", "hhmmss", "synced_clock", "FP32_PEAK", "Span",
           "span", "on", "recording", "spans", "clear", "current",
           "attached", "seconds"]

# One H100 SXM, dense FP32 outside the tensor cores, operations per second
# (the published peak, at its 700 W power limit).
FP32_PEAK = 67e12


def synced_clock(device) -> float:
    """``time.perf_counter()`` after a synchronisation of ``device`` when
    it is a CUDA device (CPU work is done when its call returns)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def hhmmss(s: float) -> str:
    m, s = divmod(int(s), 60)
    h, m = divmod(m, 60)
    if h == 0:
        return f"{m:02d}:{s:02d}"
    return f"{h:02d}:{m:02d}:{s:02d}"


def print_timings(iterator, desc: str = "time", print_interval: float = 2.0,
                  total: int = None):
    start_time = time.perf_counter()
    if total is None:
        total = len(iterator)
    last_printed = -print_interval
    for i, value in enumerate(iterator):
        yield value
        elapsed = time.perf_counter() - start_time
        it_s = (i + 1) / elapsed if elapsed > 0 else float("inf")
        total_s = total / it_s if it_s > 0 else 0.0
        if elapsed > last_printed + print_interval:
            print(f"{desc}: {i + 1}/{total} it, {it_s:.02f} it/s,"
                  f"[{hhmmss(elapsed)}<{hhmmss(total_s)}]", flush=True)
            last_printed = elapsed


# -- spans -------------------------------------------------------------

_ids = itertools.count(1)
_store: List["Span"] = []          # spans finished under a profiler
_sinks: List[List["Span"]] = []    # the open recording() blocks' lists
_local = threading.local()         # .stack: this thread's open spans


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One timed stretch of host work; the context manager that times it
    while it is open."""

    __slots__ = ("name", "id", "parent", "call", "start_ns", "end_ns",
                 "attrs", "thread", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = self.call = self.start_ns = self.end_ns = None
        self.thread = threading.get_ident()
        self._rf = None

    def set(self, **attrs) -> None:
        """Add attrs known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> "Span":
        stack = _stack()
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.call = self.id
        stack.append(self)
        # the span holds its record_function, whose start the profiler
        # stamps a few us later
        self.start_ns = time.time_ns()
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        for sink in list(_sinks):
            sink.append(self)
        if _profiler._is_profiler_enabled:
            _store.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, {self.seconds if self.end_ns else None}"
                f" s, {self.attrs})")


class _Off:
    """The span while nothing records: enters to itself, keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()


def on() -> bool:
    """Whether spans record now."""
    return bool(_sinks) or _profiler._is_profiler_enabled


def span(name: str, **attrs):
    """A context manager timing ``name`` (with ``attrs``) when spans
    record; the shared do-nothing one otherwise.  Either has ``set``."""
    if not (_sinks or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans in every thread while the block is open; yields the
    list that receives the spans finished meanwhile (the printouts and
    the ``phases`` views read it)."""
    sink: List[Span] = []
    _sinks.append(sink)
    try:
        yield sink
    finally:
        # by identity: two blocks' lists may be equal
        del _sinks[next(i for i, s in enumerate(_sinks) if s is sink)]


def spans() -> List[Span]:
    """A copy of the spans finished while a profiler recorded."""
    return list(_store)


def clear() -> None:
    """Forget the spans finished while a profiler recorded."""
    _store.clear()


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def attached(parent: Optional[Span]):
    """Make ``parent`` (a span open on another thread, or None) the parent
    and call of the spans this thread opens inside the block."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def seconds(found: Iterable[Span], *names: str,
            parents: Optional[Iterable[int]] = None) -> Dict[str, float]:
    """Seconds summed per name over ``found``'s spans of ``names`` (those
    whose parent is in ``parents``, when given)."""
    keep = None if parents is None else set(parents)
    out = dict.fromkeys(names, 0.0)
    for s in found:
        if s.name in out and (keep is None or s.parent in keep):
            out[s.name] += s.seconds
    return out

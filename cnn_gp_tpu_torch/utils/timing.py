"""Progress/timing reporting: a copy of ``cnn_gp_tpu/utils/timing.py``
(which cannot be imported without jax, because ``cnn_gp_tpu/__init__.py``
imports it).

``print_timings`` wraps an iterator and prints `i/total it, it/s,
[elapsed<projected]` at most every ``print_interval`` seconds, one full
line per report so concurrent workers can interleave on one terminal.
"""

from __future__ import annotations

import time

__all__ = ["print_timings", "hhmmss"]


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

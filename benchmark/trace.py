"""The card's trace of a stretch of whole calls, reduced to what the
per-layer metrics read.

``trace`` runs a stretch under ``torch.profiler`` (card activity only,
so the host pays little for it) with 50 ms of idle time at each edge and
``torch.cuda._sleep`` marker kernels just before and after the stretch's
launches: on an H100 a trace has been seen to lose its leading records,
never its last, so the markers take the edges (a frozen copy of
``chip_smoke.trace_card``).  ``summarize`` reduces the trace: the
seconds in which something ran on the card (the union of the kernels'
and copies' intervals, as ``chip_smoke.device_busy_seconds`` takes it),
the kernels counted and timed by name, the NCCL kernels' time, and the
longest idle gaps labelled by the kernels on either side.
"""

from __future__ import annotations

import collections
import time

import torch

MARGIN_S = 0.05
MARKER = "spin_kernel"     # torch.cuda._sleep's kernel
LEAD_MARKERS = (2_000_000, 100_000, 100_000, 100_000)   # cycles
TOP = 10


def trace(run):
    """(profile, host seconds of ``run()`` ending in a synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        for cycles in LEAD_MARKERS:
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    return prof, wall


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0][:96]


def summarize(prof, wall_s: float) -> dict:
    """Busy seconds, kernels by name, NCCL seconds and idle gaps of one
    traced stretch; the marker kernels left out."""
    events = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and MARKER not in e.name)
    by_name = collections.defaultdict(float)
    kernels = 0
    nccl_us = 0.0
    for s, e, name in events:
        by_name[_short(name)] += e - s
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
        if "nccl" in name.lower():
            nccl_us += e - s
    busy_us, gaps = 0.0, []
    if events:
        end, last = events[0][0], events[0][2]
        for s, e, name in events:
            if s > end:
                gaps.append((s - end, f"idle after {_short(last)} before "
                             f"{_short(name)}"))
            if e > end:
                busy_us += e - max(s, end)
                end, last = e, name
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"wall_s": wall_s, "busy_s": busy_us / 1e6, "kernels": kernels,
            "nccl_s": nccl_us / 1e6,
            "device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[label, us / 1e6] for us, label in gaps[:TOP]]}

"""One run of one cell: set-up, the measured window, an optional traced
stretch, the check against the plain reference, and the result line.

Everything that belongs to one cell is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic;
``workloads/<cell>.json`` holds the cell's sizes and the limits of its
check; ``traffic/<traffic>.json`` names the driver (``drivers/<driver>.py``)
and its parameters; ``configs/<config>.json`` the architecture, and
``recursions/<r>.py`` the covariance recursion it names (its parser,
counts, model builder and reference); each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a
configuration or a metric adds files; no file here changes.

A run of a cell on several cards is one process per card: this process
is rank 0, spawns the others, and prints the line.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import importlib
import importlib.util
import json
import math
import multiprocessing
import os
import socket
import subprocess
import sys
import time
from typing import Optional

import torch

from . import arch, peaks, trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded once the window has closed:
# JAX, and the JAX package with its root-level drivers and configs
FORBIDDEN = ("jax", "jaxlib", "flax", "cnn_gp_tpu", "configs", "scripts",
             "exp_mnist_resnet", "exp_random_nn", "bench", "__graft_entry__")
RANK_TIMEOUT_S = 120


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def load_cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell ``name``: its BENCHMARK.json entry, with its sizes and
    limits (``workloads/<name>.json``), its traffic
    (``traffic/<traffic>.json``) and its configuration
    (``configs/<config>.json``, its recursion's module and the model it
    parsed)."""
    spec = spec or benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(entry)
    cell["sizes"] = _json(HERE, "workloads", f"{name}.json")
    cell["mix"] = _json(HERE, "traffic", f"{entry['traffic']}.json")
    cell["cfg"] = arch.load_config(entry["config"])
    return cell


def reported(spec: dict, cell: str, section: str):
    """The metrics of ``section`` that the cell reports: those whose
    ``workloads`` list names it, or that have no list (an end-to-end
    metric), or whose ``moves`` metric the cell reports (a per-layer
    metric without a list)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load_file(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    return _load_file(os.path.join(HERE, "metrics", f"{metric}.py"),
                      f"benchmark_metric_{metric.replace('.', '_')}").read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux
    ``/proc``), so that ``setup_s`` includes the interpreter's start and
    the imports."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded():
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


# -- the rank group ---------------------------------------------------

@contextlib.contextmanager
def reserved_port():
    """A free 127.0.0.1 port held (bound with SO_REUSEADDR, never
    listened on) until the world's rendezvous is over, so that no other
    socket takes it before rank 0's store binds it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield s.getsockname()[1]


class Group:
    """This process's place in the cell's world: no collective for one
    rank."""

    def __init__(self, rank: int, size: int, device: torch.device):
        self.rank, self.size, self.device = rank, size, device

    def any(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.size == 1:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)], device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def gather(self, obj):
        """Every rank's ``obj`` on every rank, in rank order."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def join(rank: int, size: int, port: int, device: str) -> Group:
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    if size > 1:
        import torch.distributed as dist
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
            **({"device_id": dev} if dev.type == "cuda" else {}))
    return Group(rank, size, dev)


def leave(group: Group) -> None:
    if group.size > 1:
        import torch.distributed as dist
        dist.destroy_process_group()


def _rank_main(rank, size, port, device, name, seed, seconds, trace_on,
               overrides, faults, spec):
    """A spawned rank: the same run, its part handed to rank 0."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    group = join(rank, size, port, device)
    try:
        run_rank(group, name, seed, seconds, trace_on, overrides,
                 faults=faults, spec=spec)
    finally:
        leave(group)


# -- one run -------------------------------------------------------

def _apply(cell: dict, overrides: Optional[dict]) -> dict:
    """A cell with some sizes replaced (the tests' small runs)."""
    if overrides:
        cell = dict(cell, sizes=dict(cell["sizes"], **overrides))
    return cell


def run_rank(group: Group, name: str, seed: int, seconds: float,
             trace_on: bool, overrides=None, started: Optional[float] = None,
             faults=None, spec: Optional[dict] = None):
    """Set-up, window, traced stretch and check on this rank.  Every rank
    returns its part; rank 0 returns the whole run's."""
    started = process_start() if started is None else started
    cell = _apply(load_cell(name, spec), overrides)
    drv = driver(cell["mix"]["driver"]).Driver(cell, seed, group)
    if faults:
        faults(drv)
    on_card = group.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(group.device)

    drv.setup()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(group.device)
    setup_s = time.time() - started

    # the window: whole calls, the last one started before `seconds`
    spans = []
    t_open = time.perf_counter()
    k = 0
    while group.any(time.perf_counter() - t_open < seconds or k == 0):
        t0 = time.perf_counter()
        out = drv.call(k)
        sync()
        t1 = time.perf_counter()
        drv.keep(k, out)
        del out
        spans.append((t0, t1))
        k += 1
    sync()
    window_s = time.perf_counter() - t_open

    traced = None
    if trace_on and on_card:
        prof, wall = tracing.trace(lambda: drv.call(k))
        traced = tracing.summarize(prof, wall)
        del prof
    peak = torch.cuda.max_memory_allocated(group.device) if on_card else 0
    drv.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    part = {"rank": group.rank, "setup_s": setup_s, "window_s": window_s,
            "calls": k, "peak": peak, "traced": traced,
            "call_s": [t1 - t0 for t0, t1 in spans],
            "samples": drv.samples()}
    parts = group.gather(part)
    if group.rank != 0:
        return None
    checks, failed = drv.check([p["samples"] for p in parts])
    return {"cell": cell, "driver": drv, "parts": parts, "checks": checks,
            "failed": failed, "calls": k, "window_s": max(
                p["window_s"] for p in parts), "setup_s": parts[0]["setup_s"]}


def result_line(spec: dict, run: dict, trace_on: bool,
                device_kind: str) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    the metrics, ``device``, with ``--trace 1`` the ``breakdown``, and
    last the numbers compared beside their limits."""
    cell, drv, parts = run["cell"], run["driver"], run["parts"]
    chips = len(parts)
    work = drv.work_per_call()
    ctx = {"kind": cell["mix"]["driver"], "chips": chips,
           "calls": run["calls"], "window_s": run["window_s"],
           "work_per_call": work, "units_per_call": drv.units_per_call(),
           "tiles_per_call": drv.tiles_per_call(),
           "traced": [p["traced"] for p in parts if p["traced"]],
           "peaks": peaks}
    metrics = {}
    if trace_on:
        for m in reported(spec, cell["name"], "per_layer"):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(drv.end_to_end(run["calls"], run["window_s"]),
                      setup_s=run["setup_s"])
        for m in reported(spec, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": max(p["peak"] for p in parts),
              "power_limit": power_limit()}
    checks = {k: {"value": c["value"] if math.isfinite(c["value"]) else None,
                  "limit": c["limit"]} for k, c in run["checks"].items()}
    line = {"correct": all(c["value"] is not None
                           and c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": run["calls"], "failed": run["failed"],
            "metrics": metrics, "device": device}
    if ctx["traced"]:
        device["busy_s"] = sum(t["busy_s"] for t in ctx["traced"]) / chips
        device["window_s"] = max(t["wall_s"] for t in ctx["traced"])
        first = ctx["traced"][0]
        line["breakdown"] = {"device_ops": first["device_ops"],
                             "idle_gaps": first["idle_gaps"]}
    line["call_seconds"] = [max(c) for c in zip(*(p["call_s"]
                                                    for p in parts))]
    line["checks"] = checks    # last: each number beside its limit
    return line


def run_world(name: str, seed: int, seconds: float, trace_on: bool,
              device: str = "cuda", overrides=None, faults=None,
              started: Optional[float] = None, spec: Optional[dict] = None):
    """One run of the cell on its ``chips`` ranks: this process is rank 0
    and the others are spawned (NCCL on the card, gloo on the CPU).
    Returns rank 0's ``run_rank`` result; raises if a rank failed.
    ``spec`` stands in for BENCHMARK.json (the tests' cells)."""
    chips = int(load_cell(name, spec)["chips"])
    procs = []
    with reserved_port() as port:
        if chips > 1:
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_rank_main, args=(
                r, chips, port, device, name, seed, seconds, trace_on,
                overrides, faults, spec)) for r in range(1, chips)]
            for p in procs:
                p.start()
        group = join(0, chips, port, device)
    try:
        run = run_rank(group, name, seed, seconds, trace_on, overrides,
                       started, faults, spec)
    finally:
        leave(group)
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return run


def main(name: str, seed: int, seconds: float, trace_on: bool) -> int:
    started = process_start()
    spec = benchmark_spec()
    chips = int(load_cell(name, spec)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{name} needs {chips} CUDA card(s), this host has {have}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = run_world(name, seed, seconds, trace_on, started=started, spec=spec)
    line = result_line(spec, run, trace_on, torch.cuda.get_device_name(0))
    found = forbidden_loaded()
    if found:
        print(f"modules that may not be loaded: {found}", file=sys.stderr)
        return 3
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0

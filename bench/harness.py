"""One run of one cell: what the drivers share.

:class:`Run` carries a cell's pieces (found by name through
:mod:`bench.core`), the run's arguments and what the run measured;
:func:`window` is the measured window every driver runs; :func:`result`
assembles the contract's last line.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import torch

from bench import core
from bench.trace import Hooks, Trace, profiler


class Run:
    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device="cuda", *, cfg_cut=None,
                 traffic_cut=None, fault: str | None = None):
        self.bm = core.benchmark()
        self.cell = core.cell(self.bm, workload)
        self.name = workload
        sizes = core.config_file(self.cell["config"])
        cfg = core.arch_config(sizes)
        if cfg_cut is not None:            # a test's smaller copy
            cfg = cfg_cut(cfg)
            sizes = core.sizes_of(cfg, sizes)
        self.cfg, self.sizes = cfg, sizes
        self.traffic = core.traffic_file(self.cell["traffic"])
        if traffic_cut is not None:
            self.traffic = traffic_cut(self.traffic)
        self.checks = core.checks_file(workload)
        self.family = core.family(sizes)
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.fault = fault
        self.started = core.process_start()
        self.e2e = [m["name"] for m in core.end_to_end_of(self.bm, workload)]
        self.per_layer = [m["name"] for m in
                          core.per_layer_of(self.bm, workload)]
        self.metric_mods = {m: core.metric(m) for m in self.per_layer} \
            if trace else {}
        self.hook_targets = sorted({h for mod in self.metric_mods.values()
                                    for h in getattr(mod, "HOOKS", ())})
        # filled by the driver
        self.setup_s = None
        self.window_s = self.check_s = 0.0
        self.values: dict = {}          # end-to-end metrics
        self.info: dict = {}            # what per-layer readers read
        self.numbers: dict = {}         # compared numbers: (value, limit)
        self.attempted = self.failed = 0
        self.peak = 0
        self.trace_data: Trace | None = None
        self.hooks: Hooks | None = None

    # -- set-up and window ----------------------------------------------

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.time() - self.started
        self.values["setup_s"] = self.setup_s

    def read_peak(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.device)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the verdict ------------------------------------------------------

    def compare(self, values: dict) -> None:
        """Each number the cell compares beside its limit
        (``checks/<cell>.json``); a reading the cell does not compare is
        kept in ``info`` alone."""
        self.check_s = time.time() - self.started - self.setup_s \
            - self.window_s
        limits = self.checks["limits"]
        self.info["readings"] = {k: float(v) for k, v in values.items()}
        for k, v in values.items():
            if k in limits:
                self.numbers[k] = (float(v), float(limits[k]))

    def correct(self) -> bool:
        return bool(self.numbers) and all(
            v == v and v <= lim for v, lim in self.numbers.values())


def window(r: Run, unit, n_traced: int) -> float:
    """Call ``unit()`` until ``r.seconds`` have passed, ending at a unit's
    end; in a traced run the first ``n_traced`` units run under the
    profiler and the metrics' hooks.  Returns the window's wall seconds."""
    t0 = time.perf_counter()
    if r.trace:
        with profiler() as prof, Hooks(r.hook_targets) as hooks:
            with torch.profiler.record_function("bench.window"):
                for _ in range(n_traced):
                    unit()
                r.sync()
        r.sync()
        r.hooks = hooks
        r.trace_data = Trace.from_profiler(prof)
    while time.perf_counter() - t0 < r.seconds:
        unit()
    r.sync()
    r.window_s = time.perf_counter() - t0
    return r.window_s


def per_layer_values(r: Run) -> dict:
    out = {}
    for name, mod in r.metric_mods.items():
        v = mod.read(r)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def result(r: Run) -> dict:
    units = {m["name"]: m["unit"] for m in r.bm["end_to_end"]}
    if r.trace:
        metrics = per_layer_values(r)
    else:
        metrics = {k: {"value": r.values[k], "unit": units[k]}
                   for k in r.e2e if k in r.values}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(r.device)
              if r.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(r.peak)}
    out = {"correct": r.correct(), "attempted": r.attempted,
           "failed": r.failed, "metrics": metrics, "device": device}
    if r.trace and r.trace_data is not None and r.trace_data.window:
        device["busy_s"] = r.trace_data.busy_s()
        device["window_s"] = r.trace_data.window_s()
        out["breakdown"] = {"device_ops": r.trace_data.top_device_ops(),
                            "idle_gaps": r.trace_data.idle_gaps()}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in r.numbers.items()}
    return out


def report(r: Run, out: dict) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output."""
    sys.stdout.flush()
    for k, v in r.info.get("readings", {}).items():
        if k not in r.numbers:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in r.numbers.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)

"""The benchmark's specification, found by name: ``BENCHMARK.json`` at the
root of the checkout, and under ``bench/`` each configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``), output
check (``checks/<cell>.json``), per-layer metric (``metrics/<metric>.py``),
traffic driver (``drivers/<kind>.py``) and family reference
(``reference/<family>.py``).  Importing this module imports nothing of the
program."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bm: dict, name: str) -> dict:
    for w in bm["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def checks_file(name: str) -> dict:
    return load_json(BENCH / "checks" / f"{name}.json")


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def family(sizes: dict):
    return importlib.import_module(f"bench.reference.{sizes['reference']}")


def metric(name: str):
    """A per-layer metric's module, ``metrics/<name>.py`` (names hold dots,
    so it is loaded from its file)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_of(bm: dict, workload: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bm["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(bm: dict, workload: str) -> list[dict]:
    """The per-layer metrics a cell's traced run reports: those whose
    ``workloads`` list it."""
    return [m for m in bm["per_layer"] if workload in m["workloads"]]


def arch_config(sizes: dict):
    """The port's ``ArchConfig`` of a configuration file: the registry's
    architecture with the file's cuts, each of which the file lists under
    ``reduced``; every size the file states must then be the config's."""
    from repro_torch.configs import get
    base = get(sizes["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    want = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in sizes.items() if k in fields}
    changed = {k: v for k, v in want.items() if getattr(base, k) != v}
    unlisted = sorted(set(changed) - set(sizes.get("reduced", {})))
    if unlisted:
        raise ValueError(f"{sizes['arch']}: the file changes {unlisted} from "
                         "the port's config without listing them in reduced")
    cfg = dataclasses.replace(base, **changed)
    if cfg.padded_vocab != sizes["padded_vocab"]:
        raise ValueError(f"padded vocab {cfg.padded_vocab} is not the file's "
                         f"{sizes['padded_vocab']}")
    return cfg


def sizes_of(cfg, sizes: dict) -> dict:
    """``sizes`` with every key the port's config has taken from ``cfg`` (a
    test's smoke cut of the same architecture)."""
    out = dict(sizes)
    for k in sizes:
        if hasattr(cfg, k) and k not in ("name",):
            v = getattr(cfg, k)
            out[k] = list(v) if isinstance(v, tuple) else v
    out["padded_vocab"] = cfg.padded_vocab
    return out


def process_start() -> float:
    """The epoch second this process started (``/proc/self/stat``, clock
    ticks since boot), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_loaded(modules) -> list[str]:
    """Top-level module names of ``modules`` that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN_MODULES))

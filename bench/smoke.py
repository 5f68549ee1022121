"""A cell at a size a CPU test run can hold: the port's smoke cut of the
cell's architecture (``repro_torch.configs.smoke``), a few short sequences,
the whole run on the CPU past the harness's look for a card."""
from __future__ import annotations

import dataclasses

from bench import core
from bench.harness import Run, result

SEED = 2 ** 31 + 4242


def traffic_cut(tr: dict) -> dict:
    tr = dict(tr)
    if tr["kind"] == "train":
        tr.update(batch=2, seq_len=64)
    else:
        tr.update(token_budget=256, round={"64": 2, "128": 1})
    return tr


def run(workload: str, *, fault=None, trace=False, seed=SEED, **cut):
    """One run of ``workload`` on the CPU at smoke size; ``cut`` replaces
    fields of the smoke config (``capacity_factor=1.0``).  Returns the
    run and its result line."""
    from repro_torch.configs import smoke

    def cfg_cut(cfg):
        return dataclasses.replace(smoke(cfg), **cut)

    r = Run(workload, seed, 0.2, trace, "cpu", cfg_cut=cfg_cut,
            traffic_cut=traffic_cut, fault=fault)
    if r.traffic["kind"] == "prefill":
        r.checks = dict(r.checks, check_batches={"64": 2, "128": 1})
    core.driver(r.traffic["kind"]).run(r)
    return r, result(r)

"""Traffic kind ``train``: one training step after another through the
port's ``train/loop.py::make_train_step``, on batches of Zipf tokens from
the benchmark's copy of ``TokenDataset`` (batch i a function of the seed and
i).  The mix's file gives the batch, the sequence length, the Zipf exponent,
AdamW's settings, the steps set-up runs and the check reads, and the steps
a traced run traces.

Set-up builds the one step object with its parameters (the benchmark's
seeded weights) and AdamW state, and drives it through the checked steps,
which warm every shape the window uses; the window then runs the same
object on, each step's loss read on the host as ``Trainer.run`` does, and
ends at the first step boundary after ``--seconds``.
``train_tokens_per_s`` is every token of every step of the window over the
window's wall time.  Once the window has closed and the program's state is
freed, the plain reference runs the checked steps again from the same
weights and batches.
"""
from __future__ import annotations

import math
import time

import torch

from bench import verdict, weights
from bench.data import TokenDataset
from bench.harness import Run, window
from bench.reference import common


def _faulty(step, fault):
    """The step with a planted fault (the tests'), or as it is."""
    if fault == "half_batch":
        return lambda p, o, b: step(p, o, {k: v[:v.shape[0] // 2]
                                           for k, v in b.items()})
    if fault == "unchanged":
        def unchanged(p, o, b):
            keep = weights.tree_map(lambda t: t.clone(), (p, o))
            p2, o2, m = step(p, o, b)
            weights.tree_map(lambda t, k: t.copy_(k), (p2, o2), keep)
            return p2, o2, m
        return unchanged
    if fault is not None:
        raise ValueError(f"no fault {fault!r} for a training cell")
    return step


def _start_of(specs, seed, device):
    """``path`` (a leaf's path in the tree, ``unit.1.attn.wq`` or
    ``embed``, as the reference's walk names it) -> the leaf's seeded
    starting value, drawn again alone."""
    index = {p: (i, s) for i, (p, s) in enumerate(weights.tree_items(specs))}

    def start(path):
        i, s = index[path]
        return weights.make_leaf(s, seed, i, device)

    return start


def program_readings(r: Run, step, params, opt, ds, n: int, b1: float):
    """Run the first ``n`` steps; the readings the check compares."""
    out = {"loss": [], "grad_norm": []}
    for i in range(n):
        params, opt, m = step(params, opt, ds.batch_at(i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["grad1"] = common.slice_norms(opt["mu"], 1.0 / (1.0 - b1))
    out["change"] = common.change_norms(
        params, _start_of(r.family.param_specs(r.sizes), r.seed, r.device))
    return params, opt, out


def reference_readings(r: Run, ds, n: int, num=common.F32) -> dict:
    specs = r.family.param_specs(r.sizes)
    tree = weights.make(specs, r.seed, r.device)
    batches = []
    for i in range(n):
        b = ds.batch_at(i)
        batches.append((torch.as_tensor(b["tokens"], device=r.device),
                        torch.as_tensor(b["labels"], device=r.device)))
    out = common.train_steps(r.family, r.sizes, tree, batches,
                             r.traffic["optimizer"],
                             _start_of(specs, r.seed, r.device), num)
    del tree
    r.free()
    return out


def build(r: Run):
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    tr = r.traffic
    params = weights.make(r.family.param_specs(r.sizes), r.seed, r.device)
    opt = adamw_init(params)
    step = make_train_step(r.cfg, opt_cfg=AdamWConfig(**tr["optimizer"]),
                           device=r.device)
    ds = TokenDataset(r.sizes["vocab"], tr["seq_len"], tr["batch"], r.seed,
                      tr["zipf_a"])
    return _faulty(step, r.fault), params, opt, ds


def run(r: Run) -> None:
    tr = r.traffic
    n_check = tr["check_steps"]
    step, params, opt, ds = build(r)
    params, opt, prog = program_readings(r, step, params, opt, ds, n_check,
                                         tr["optimizer"]["b1"])
    r.setup_done()

    state = {"params": params, "opt": opt, "i": n_check}
    step_s, losses = [], []

    def unit():
        t = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            state["params"], state["opt"], m = step(
                state["params"], state["opt"], ds.batch_at(state["i"]))
            losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t)
        state["i"] += 1

    wall = window(r, unit, tr["trace_steps"])
    tokens = len(step_s) * tr["batch"] * tr["seq_len"]
    r.values["train_tokens_per_s"] = tokens / wall
    r.attempted = len(losses)
    r.failed = sum(not math.isfinite(x) for x in losses)
    r.info.update(step_s=step_s, batch=tr["batch"], seq=tr["seq_len"])
    r.read_peak()
    del state, params, opt, step
    r.free()
    ref = reference_readings(r, ds, n_check)
    r.compare(verdict.train_numbers(prog, ref))

"""``repro_torch/spans.py`` and its sites on the CPU: with no profiler
recording the recorder enters no ``record_function`` and keeps nothing, and
the outputs are bit for bit those of a profiled run; under a CPU profiler
the spans of the train step, the serve engine, MoE routing and the SSM
mixer appear where they are placed, nested as placed; the MoE's slot
counters equal a count made from ``route`` itself."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get, smoke
from repro_torch.models import moe as M
from repro_torch.models.model import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import adamw_init
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MOE = "deepseek-moe-16b"
SSM = "mamba2-2.7b"


@pytest.fixture(autouse=True)
def empty_recorder():
    """Each test starts and ends with nothing recorded."""
    spans.take()
    yield
    spans.take()


def _cfg(arch, **kw):
    return dataclasses.replace(smoke(get(arch)), **kw)


def _prompts(cfg, rows=2, length=64, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, cfg.vocab, (rows, length)).astype(np.int32)


def _batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, cfg.vocab, (2, 64)).astype(np.int32)
            for k in ("tokens", "labels")}


def _train_step(cfg):
    """One step from the seeded weights: (loss, grad norm, new params)."""
    params = init_params(cfg, 0, "cpu")
    step = make_train_step(cfg, device="cpu")
    params, _, m = step(params, adamw_init(params), _batch(cfg))
    return m["loss"], m["grad_norm"], params


def _generate(cfg, n_new=4):
    eng = ServeEngine(cfg, init_params(cfg, 0, "cpu"), device="cpu",
                      max_len=64 + n_new)
    return eng.generate(_prompts(cfg), n_new).tokens


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _profiled(fn):
    with torch.profiler.profile() as prof:
        out = fn()
    return out, prof


@pytest.mark.parametrize("what", ["train", "generate"])
def test_off_enters_nothing_and_outputs_are_the_profiled_ones(
        what, monkeypatch):
    cfg = _cfg(MOE)
    run = (lambda: _train_step(cfg)) if what == "train" else \
        (lambda: _generate(cfg))

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        off = run()
    assert spans.take() == {"spans": {}, "counts": {}, "dropped": 0}
    on, _ = _profiled(run)
    assert spans.take()["spans"]
    if what == "generate":
        assert np.array_equal(off, on)
        return
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    for a, b in zip(_leaves(off[2]), _leaves(on[2]), strict=True):
        assert torch.equal(a, b)


def _ranges(prof):
    """The ``repro.`` ranges of a profile: (name, thread, start, end)."""
    return [(e.name[len(spans.PREFIX):], e.thread, e.time_range.start,
             e.time_range.end) for e in prof.events()
            if e.name.startswith(spans.PREFIX)]


def _within(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and \
        inner[3] <= outer[3]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _only_inside(ranges, inner, outer):
    """Every ``inner`` range lies in some ``outer`` one; how many do."""
    got = _named(ranges, inner)
    assert all(any(_within(r, o) for o in _named(ranges, outer))
               for r in got), (inner, outer)
    return len(got)


def test_train_step_spans_nest_as_placed():
    cfg = _cfg(MOE, remat=True)
    _, prof = _profiled(lambda: _train_step(cfg))
    rs = _ranges(prof)
    (fwd,) = _named(rs, "train.forward")
    (bwd,) = _named(rs, "train.backward")
    assert fwd[3] <= bwd[2]
    route = _named(rs, "moe.route")
    # remat routes each layer again inside backward
    assert sum(_within(r, fwd) for r in route) == cfg.n_layers
    assert sum(_within(r, bwd) for r in route) == cfg.n_layers
    assert len(route) == 2 * cfg.n_layers
    assert spans.take()["spans"]["train.forward"]["calls"] == 1


@pytest.mark.parametrize("arch", [MOE, SSM])
def test_generate_spans_nest_as_placed(arch):
    cfg = _cfg(arch)
    n_new = 4
    _, prof = _profiled(lambda: _generate(cfg, n_new))
    rs = _ranges(prof)
    (gen,) = _named(rs, "serve.generate")
    (pre,) = _named(rs, "serve.prefill")
    (home,) = _named(rs, "serve.rehome")
    assert _within(pre, gen) and _within(home, gen) and pre[3] <= home[2]
    if arch == MOE:
        route = _named(rs, "moe.route")
        # each layer routes in prefill and in every decode step
        assert sum(_within(r, pre) for r in route) == cfg.n_layers
        assert len(route) == n_new * cfg.n_layers
        assert _only_inside(rs, "moe.route", "serve.generate") == \
            len(route)
    else:
        # the decode step has no mixer span: prefill's alone
        assert _only_inside(rs, "ssm.mixer", "serve.prefill") == \
            cfg.n_layers
        assert _only_inside(rs, "ssm.ssd_diag", "ssm.mixer") == \
            cfg.n_layers
    got = spans.take()["spans"]
    assert {k: v["calls"] for k, v in got.items()} == \
        {name: len(_named(rs, name)) for name in {r[0] for r in rs}}
    assert all(v["device_ms"] is None for v in got.values())


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_slot_counters_are_routes_own_count(cf):
    torch.manual_seed(0)
    b, s, d, e, f, k = 2, 32, 16, 8, 12, 2
    p = {"router": torch.randn(d, e),
         "wi": torch.randn(e, d, f) / 4, "wg": torch.randn(e, d, f) / 4,
         "wo": torch.randn(e, f, d) / 4}
    x = torch.randn(b, s, d)
    with torch.profiler.profile():
        M.moe_apply(p, x, k, cf)
        M.moe_apply(p, x[:1], k, cf)
    got = spans.take()["counts"]
    kept = slots = 0
    for xs in (x, x[:1]):
        r = M.route(p, xs.reshape(1, -1, d), k, cf)
        kept += int(r["ok"].sum())
        slots += e * r["cap"]
    assert got == {"moe.slots_kept": kept, "moe.slots": slots}
    assert 0 < kept < slots


def test_recorder_caps_what_it_keeps():
    rec = spans.Recorder(cap=2)
    with torch.profiler.profile():
        for v in (1, 2, 3):
            rec.count("n", torch.tensor(v))
        rec.count("n", 10)
        with rec.span("a"):
            pass
    got = rec.take()
    assert got == {"spans": {"a": {"calls": 1, "device_ms": None}},
                   "counts": {"n": 13}, "dropped": 1}
    assert rec.take() == {"spans": {}, "counts": {}, "dropped": 0}

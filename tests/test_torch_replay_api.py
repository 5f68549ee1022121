"""The rest of the port's single-device replay API against the reference.

``time_local``, the O(grammar) program size (``group_program_sizes``, the
port's measure in place of the reference's ``group_eqn_counts``),
``noise.calibrate_trace``, ``SynthesisResult.rank_traces``,
``proxy_search.fit_many`` and ``blocks.run_combo_dyn``.  The reference's
``blocks``, ``noise``, ``tracer``, ``trace_ir`` and ``proxy_search`` import
in-process; every check here is bit for bit unless it says otherwise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jax_blocks
from repro.core import noise as jax_noise
from repro.core import proxy_search as jax_fit
from repro.core import tracer as jax_tracer
from repro.core.events import CommEvent as JCommEvent
from repro.core.events import ComputeEvent as JComputeEvent
from repro.core.trace_ir import TraceStore as JTraceStore
from repro.core.tracer import compute_cost as jax_compute_cost
from repro_torch.core import blocks, noise, proxy_search, tracer
from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.synthesize import synthesize
from repro_torch.workloads import synthetic_rank_traces
from test_torch_cuda import MXU_RTOL
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _mk_traces(ev, n_ranks=4, reps=24, irregular=False):
    """The reference's ``tests/test_progtable.py:_mk_traces``, with the
    event classes of either package (``ev`` = (CommEvent, ComputeEvent))."""
    comm_cls, comp_cls = ev
    comm = comm_cls("psum", (16,), "float32", ("x",))
    perm = comm_cls("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    comps = [comp_cls(tuple(
        np.array([2.1e6, 3.3e4, 1.1e6, 8.2e2, 0., 0.]) * 1.5 ** i))
        for i in range(5)]
    sched = ([(7 * i * i + 3 * i) % 5 for i in range(reps)] if irregular
             else [i % 2 for i in range(reps)])
    traces = []
    for r in range(n_ranks):
        tr = []
        for s in sched:
            tr.extend([comps[s], comm if s % 2 == 0 else perm])
        if r == 0:
            tr = tr + [comm]
        traces.append(tr)
    return traces


PORT_EV = (CommEvent, ComputeEvent)
JAX_EV = (JCommEvent, JComputeEvent)


def _synth(tmp_path, name, codegen="table", **kw):
    return synthesize(rank_traces=_mk_traces(PORT_EV, **kw),
                      axis_sizes={"x": 4}, name=name, device="cpu",
                      out_dir=tmp_path / name, codegen=codegen)


def test_time_local_is_a_warm_rank_replay(tmp_path):
    res = _synth(tmp_path, "tl")
    p = res.proxy
    assert p.time_local(0) > 0
    assert p.time_local(3, iters=2, seed=5) > 0
    assert p.cache_stats()["compiled_per_rank"] == 2   # ranks 0 and 3
    with pytest.raises(ValueError, match="out of range"):
        p.time_local(4)


@pytest.mark.parametrize("irregular", [False, True])
def test_program_size_stays_grammar_sized(tmp_path, irregular):
    """The reference's ``test_compiled_executable_stays_grammar_sized``:
    10x the events, at most 2x the size, and never above the unrolled
    flavor's."""
    small = _synth(tmp_path, "g1", reps=24, irregular=irregular)
    big = _synth(tmp_path, "g2", reps=240, irregular=irregular)
    big_ref = _synth(tmp_path, "g2u", "unrolled", reps=240,
                     irregular=irregular)
    assert big.stats["n_events"] >= 10 * small.stats["n_events"] * 0.9
    e_small = max(small.proxy.group_program_sizes().values())
    e_big = max(big.proxy.group_program_sizes().values())
    assert e_big <= 2 * e_small, (e_small, e_big)
    ref_sizes = big_ref.proxy.group_program_sizes()
    for sig, n in big.proxy.group_program_sizes().items():
        assert n <= ref_sizes[sig]
    # the unrolled trace itself is far larger: the size is the grammar's
    assert e_big < big.stats["n_events"] / 4


def test_program_size_counts_the_walked_entries(tmp_path):
    res = _synth(tmp_path, "cnt")
    mod = res.proxy.module
    lines = res.source.count("\n") + 1
    sizes = res.proxy.group_program_sizes()
    assert set(sizes) == {g[0] for g in mod.SIGNATURE_GROUPS}
    for gi, g in enumerate(mod.SIGNATURE_GROUPS):
        prog = mod.GROUP_PROGRAMS[gi]
        rules = {r for k, r, _ in prog if k == "r"}
        todo = list(rules)
        while todo:
            for k, r, _ in mod.RULES[todo.pop()]:
                if k == "r" and r not in rules:
                    rules.add(r)
                    todo.append(r)
        terms = set(mod.expand_rank_ids(g[1][0]))
        want = (len(prog) + sum(len(mod.RULES[r]) for r in rules)
                + len(terms) + lines)
        assert sizes[g[0]] == want


def test_calibrate_trace_equals_the_reference():
    evs = synthetic_rank_traces(2, reps=40)[0]
    jevs = [JComputeEvent(e.vector) if isinstance(e, ComputeEvent) else
            JCommEvent(e.kind, e.shape, e.dtype, e.axes, e.detail)
            for e in evs]
    got = noise.calibrate_trace(tracer.Trace(evs, {"x": 2}))
    want = jax_noise.calibrate_trace(jax_tracer.Trace(jevs, {"x": 2}))
    assert got.to_json() == want.to_json()
    assert len(got.compute_sigmas) == 1 and set(got.comm_params) == \
        {"psum", "ppermute"}
    tight = noise.calibrate_trace(tracer.Trace(evs, {"x": 2}), rel_tol=1e-4)
    assert tight.to_json() == jax_noise.calibrate_trace(
        jax_tracer.Trace(jevs, {"x": 2}), rel_tol=1e-4).to_json()
    assert len(tight.compute_sigmas) == 8


def _enc(ev) -> tuple:
    if hasattr(ev, "kind"):
        return ("comm", ev.kind, tuple(ev.shape), ev.dtype, tuple(ev.axes),
                ev.detail)
    return ("compute",) + tuple(np.asarray(ev.vector, np.float64).tolist())


def test_rank_traces_equal_the_reference(tmp_path):
    res = _synth(tmp_path, "rt", irregular=True)
    want = JTraceStore.from_rank_traces(
        _mk_traces(JAX_EV, irregular=True), {"x": 4}).to_rank_traces()
    got = res.rank_traces
    assert res.rank_traces is got                     # built once
    assert [[_enc(e) for e in tr] for tr in got] == \
        [[_enc(e) for e in tr] for tr in want]
    assert [[_enc(e) for e in tr] for tr in got] == \
        [[_enc(e) for e in tr] for tr in _mk_traces(PORT_EV, irregular=True)]


def _fit_targets() -> np.ndarray:
    rng = np.random.RandomState(4)
    base = np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.])
    rows = [base * (1 + 0.004 * i) for i in range(3)]
    rows += [np.abs(rng.randn(6)) * 10.0 ** rng.randint(3, 9, 6)
             for _ in range(4)]
    return np.stack(rows)


def test_fit_many_equals_the_reference():
    t = _fit_targets()
    got = proxy_search.fit_many(t)
    want = jax_fit.fit_many(t)
    assert len(got) == len(want) == len(t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        assert g.unroll == w.unroll and g.residual == w.residual
        np.testing.assert_array_equal(g.predicted, w.predicted)
        np.testing.assert_array_equal(g.per_metric_rel_err,
                                      w.per_metric_rel_err)
    one = proxy_search.fit_many(t[0])               # a single row
    np.testing.assert_array_equal(one[0].x, got[0].x)


def test_fit_batch_is_one_batch_equal_to_rows_alone():
    """One ``fit_batch`` over many targets gives each row the same bits as
    fitting it alone (the PGD folds each row's sums in a fixed order)."""
    t = _fit_targets()
    batch = proxy_search.fit_batch(t, device="cpu")
    assert len(batch) == len(t)
    for row, fr in zip(t, batch):
        alone = proxy_search.fit_batch(row[None], device="cpu")[0]
        for f in dataclasses.fields(fr):
            a, b = getattr(fr, f.name), getattr(alone, f.name)
            assert np.array_equal(a, b), f.name


def _reference_dyn(x, unroll):
    """The reference's ``run_combo_dyn`` on ``x`` from ``init_state(1)``,
    run eagerly: its final state, and the walker cost of the loops it ran.
    The reference walker costs a loop whose trip count is a traced value as
    one turn, so the cost is taken over the trip counts its
    ``repeat_block``/``empty_turns`` calls received (recorded here), each
    walked as a static loop."""
    calls = []
    rep, empty = jax_blocks.repeat_block, jax_blocks.empty_turns

    def rec_rep(name, n, st, unroll=1):
        calls.append((name, int(n), unroll))
        return rep(name, n, st, unroll)

    def rec_empty(n, st):
        calls.append((None, int(n), 1))
        return empty(n, st)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_blocks, "repeat_block", rec_rep)
        m.setattr(jax_blocks, "empty_turns", rec_empty)
        state = jax_blocks.run_combo_dyn(
            jax_blocks.init_state(1), jnp.asarray(x, jnp.int32), unroll)

    def loops(st):
        for name, n, u in calls:
            st = empty(n, st) if name is None else rep(name, n, st, u)
        return st

    return state, jax_compute_cost(loops, jax.eval_shape(
        jax_blocks.init_state))


@pytest.mark.parametrize("x", [
    (1, 0, 2, 0, 0, 0, 0, 0, 0, 3, 6),       # padding turns and block 10
    (0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 2),       # x11 below the body: clamped
])
def test_run_combo_dyn_reads_counts_once_and_equals_run_combo(x):
    """Against the reference's ``run_combo_dyn`` on the same counts: the
    states as ``test_run_combo_matches_reference_numerics`` holds them
    (integer leaves exactly, f32 leaves to 1e-5 relative and 1e-6
    absolute, bf16 ``a`` within one bf16 ulp of its largest value), and the
    walker cost exactly; then against the port's ``run_combo`` at the
    counts the reference ran, bit for bit."""
    want, want_cost = _reference_dyn(x, 2)
    got = blocks.run_combo_dyn(blocks.init_state(1, "cpu"),
                               torch.tensor(x, dtype=torch.int32), unroll=2)
    for k, v in blocks.state_to_numpy(got).items():
        w = (np.asarray(want[k], np.float32) if k in ("a", "b")
             else np.asarray(want[k]))
        if v.dtype.kind in "iu":
            np.testing.assert_array_equal(v, w, err_msg=k)
        elif k == "a":
            np.testing.assert_allclose(
                v, w, rtol=0, atol=MXU_RTOL * float(np.abs(w).max()))
        else:
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(
        tracer.compute_cost(lambda s: blocks.run_combo_dyn(s, np.array(x), 2),
                            blocks._meta_state()), want_cost)
    body = sum(x[:9])
    st = blocks.init_state(1, "cpu")
    static = blocks.run_combo(st, x[:10] + (max(x[10], body),), unroll=2)
    for k in st:
        assert torch.equal(got[k], static[k]), k
    with pytest.raises(ValueError, match="11 counts"):
        blocks.run_combo_dyn(st, torch.zeros(10, dtype=torch.int32))

"""The paper's baselines (``core/baselines.py``) in the port against the
JAX reference's, and the rows of the paper's comparisons.

The reference's ``baselines`` imports in-process.  Its roofline constants
are a TPU's; the port's are an H100's (``repro_torch.core.metrics``), so
the numbers are held equal with the port's module constants monkeypatched
to the values read, by name, from ``repro.core.metrics``: ``minime_fit``'s
block counts exactly, the times within 1e-12 relative.  Under the port's
own constants the tests hold the paper's qualitative claims
(``tests/test_serve_baselines.py``).  The Figs. 5-6 and Table 3 rows
(``benchmarks/minime_compare.py``, ``compression_table.py``: the port's
``fig56_rows``/``table3_row``) on the paper's three programs, which the
port traces into the reference's own TraceStores, equal the reference's
(times left out; the reference's trace and synthesis run in a
subprocess, see test_torch_harness.py).
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from repro.core import baselines as JB
from repro.core import events as JE
from repro.core import metrics as JM
from repro_torch.core import baselines as TB
from repro_torch.core import blocks as B
from repro_torch.core import metrics as TM
from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.proxy_search import fit_combination
from repro_torch.core.synthesize import synthesize
from repro_torch.core.tracer import trace_fn
from repro_torch.workloads import PROGRAMS, pipeline_traces
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

CONSTANTS = ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW", "VPU_RATE", "TRANS_RATE",
             "GATHER_RATE", "SCAN_OVERHEAD")
TIME_RTOL = 1e-12


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline constants set to the reference's, by name."""
    for name in CONSTANTS:
        monkeypatch.setattr(TM, name, getattr(JM, name))


def _targets(n: int = 12, seed: int = 0) -> list[np.ndarray]:
    b = B.calibration_matrix()
    rng = np.random.RandomState(seed)
    return [b @ rng.randint(10, 300, 11).astype(float) for _ in range(n)] + [
        np.array([5e9, 6e7, 1.5e9, 1e6, 2e5, 1e3]),
        np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.])]


def _trace(seed: int = 0, events=None) -> list:
    """A mixed trace: compute events of several sizes and collectives of
    several kinds and payloads (some sharing a log2 bucket), as the port's
    events or as ``events``' (a package's events module)."""
    comp_cls = ComputeEvent if events is None else events.ComputeEvent
    comm_cls = CommEvent if events is None else events.CommEvent
    rng = np.random.RandomState(seed)
    out = []
    for i in range(24):
        out.append(comp_cls(tuple(rng.uniform(0.5, 2.0, 6)
                                  * [5e9, 6e7, 1.5e9, 1e6, 2e5, 1e3])))
        kind = ("psum", "all_gather", "ppermute")[i % 3]
        n = int(rng.choice([100, 120, 260, 4096, 1 << 20]))
        out.append(comm_cls(kind, (n,), "float32", ("x",)))
    return out


_LITERAL = re.compile(r"(?<![\w.])(\d[\d_]*\.?\d*(?:[eE][+-]?\d+)?)(?![\w.])")


def _literals(path: Path) -> list[tuple[int, float]]:
    out = []
    for i, line in enumerate(path.read_text().splitlines(), 1):
        for m in _LITERAL.finditer(line.split("#")[0]):
            try:
                out.append((i, float(m.group(1).replace("_", ""))))
            except ValueError:
                pass
    return out


def test_the_port_states_no_tpu_constant():
    """Every roofline constant of the port differs from the reference's,
    and no number in the port's sources equals one of the reference's
    constants (the metrics and baselines modules: any of them; elsewhere
    all but SCAN_OVERHEAD's 1e-7, which the scan block's body also
    writes, as in the reference)."""
    ref = {getattr(JM, n) for n in CONSTANTS}
    for name in CONSTANTS:
        assert getattr(TM, name) not in ref, name
    root = Path(TM.__file__).resolve().parents[1]
    own = {Path(TM.__file__).resolve(), Path(TB.__file__).resolve()}
    for path in root.rglob("*.py"):
        banned = ref if path.resolve() in own else ref - {JM.SCAN_OVERHEAD}
        hits = [(i, v) for i, v in _literals(path) if v in banned]
        assert not hits, (path, hits)


def test_roofline_and_comm_seconds_under_the_references_constants(
        reference_constants):
    for t in _targets():
        assert TM.roofline_seconds(t) == pytest.approx(
            JM.roofline_seconds(t), rel=TIME_RTOL)
    for nbytes in (0, 64, 4096, 1 << 22):
        for n in (1, 2, 8, 64):
            assert TM.comm_seconds(nbytes, n) == pytest.approx(
                JM.comm_seconds(nbytes, n), rel=TIME_RTOL)


@pytest.mark.parametrize("i", range(14))
def test_minime_fit_gives_the_references_counts(i):
    """Counts exactly, predictions and errors to rounding (the same B,
    bit for bit, and the same greedy); constant-free."""
    t = _targets()[i]
    got, want = TB.minime_fit(t), JB.minime_fit(t)
    np.testing.assert_array_equal(got.x, np.asarray(want.x))
    assert got.iters == want.iters
    np.testing.assert_allclose(got.predicted, want.predicted, rtol=TIME_RTOL)
    np.testing.assert_allclose(got.per_metric_rel_err,
                               want.per_metric_rel_err, rtol=TIME_RTOL,
                               atol=1e-15)
    np.testing.assert_allclose(TB.minime_ratios(t), JB.minime_ratios(t),
                               rtol=TIME_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_scalabench_and_times_equal_the_references(seed,
                                                   reference_constants):
    """The histogram proxy, its predicted times and the Siesta and original
    times on two platforms and device counts, under the reference's
    constants."""
    tr, jtr = _trace(seed), _trace(seed, JE)
    got, want = TB.scalabench_compress(tr, 4), JB.scalabench_compress(jtr, 4)
    assert got.op_sequence == want.op_sequence
    assert got.bucket_means == want.bucket_means
    np.testing.assert_allclose(got.sleep_seconds, want.sleep_seconds,
                               rtol=TIME_RTOL)
    assert got.replayed_comm_bytes() == want.replayed_comm_bytes()
    comp = [e for e in tr if isinstance(e, ComputeEvent)]
    comm = [e for e in tr if isinstance(e, CommEvent)]
    jcomm = [e for e in jtr if isinstance(e, JE.CommEvent)]
    combos = [(f.x, f.unroll) for f in map(fit_combination,
                                           (e.vector for e in comp))]
    for scale in (1.0, 0.5):
        for n in (2, 8):
            pairs = [(got.predicted_time(scale, n),
                      want.predicted_time(scale, n)),
                     (TB.siesta_predicted_time(combos, comm, scale, n),
                      JB.siesta_predicted_time(combos, jcomm, scale, n)),
                     (TB.original_time(tr, scale, n),
                      JB.original_time(jtr, scale, n))]
            for g, w in pairs:
                assert g == pytest.approx(w, rel=TIME_RTOL)


# -- the paper's claims under the H100's constants (test_serve_baselines.py)


def test_minime_single_block_ok_but_worse_than_qp():
    """Paper Fig. 5/6: greedy is usable on one aggregate event but the QP
    dominates on the full 6-metric objective."""
    b = B.calibration_matrix()
    rng = np.random.RandomState(0)
    worse = 0
    for _ in range(10):
        t = b @ rng.randint(10, 300, 11).astype(float)
        g, q = TB.minime_fit(t), fit_combination(t)
        g_err = float(np.mean(g.per_metric_rel_err[t > 0]))
        q_err = float(np.mean(q.per_metric_rel_err[t > 0]))
        worse += g_err >= q_err - 1e-9
    assert worse >= 8


def test_minime_size_matched_but_ratios_drift():
    b = B.calibration_matrix()
    t = b @ np.array([50, 10, 40, 5, 3, 8, 2, 1, 6, 9, 140], float)
    g = TB.minime_fit(t)
    ops_t, ops_g = t[0] + t[1], g.predicted[0] + g.predicted[1]
    assert abs(ops_g - ops_t) / ops_t < 0.3
    q = fit_combination(t)
    rt = TB.minime_ratios(t)

    def drift(pred):
        return float(np.mean(np.abs(np.log(
            (TB.minime_ratios(pred) + 1e-9) / (rt + 1e-9)))))
    assert drift(q.predicted) < drift(g.predicted)


def test_scalabench_portability_failure_vs_siesta():
    """Paper §3.5.4 / Figs. 10-11 under the H100's constants: on a platform
    2x slower the sleep proxy's time does not move; Siesta's tracks it."""
    comp = ComputeEvent((5e9, 6e7, 1.5e9, 1e6, 2e5, 1e3))
    comm = CommEvent("psum", (1024, 1024), "float32", ("x",))
    trace = [comp, comm] * 20
    sb = TB.scalabench_compress(trace)
    combos = [(f.x, f.unroll) for f in (fit_combination(ev.vector)
                                        for ev in trace
                                        if isinstance(ev, ComputeEvent))]
    comms = [e for e in trace if isinstance(e, CommEvent)]

    def err(pred, ref):
        return abs(pred - ref) / ref
    t_a, t_b = TB.original_time(trace, 1.0), TB.original_time(trace, 0.5)
    assert err(TB.siesta_predicted_time(combos, comms, 1.0), t_a) < 0.15
    assert err(TB.siesta_predicted_time(combos, comms, 0.5), t_b) < 0.15
    assert err(sb.predicted_time(0.5), t_b) > 0.25
    assert sb.predicted_time(1.0) == pytest.approx(sb.predicted_time(0.5),
                                                   rel=0.35)


def test_scalabench_histogram_is_lossy():
    tr = [CommEvent("psum", (n,), "float32", ("x",)) for n in (100, 120, 260)]
    sb = TB.scalabench_compress(tr)
    assert sb.bucket_means[sb.op_sequence[0]] != tr[0].payload_bytes


# -- the paper's rows against the reference's -------------------------------

REFERENCE_ROWS = """
import json
import time
import numpy as np
from benchmarks.common import PROGRAMS, pipeline_traces
from repro.core.baselines import minime_fit
from repro.core.proxy_search import fit_combination, rel_error
from repro.core.synthesize import synthesize
from repro.core.tracer import trace_fn

def err(rel, t):
    return float(np.mean(rel[t > 0]))

def fig56(name, vecs):
    agg = np.sum(vecs, axis=0)
    q, g = fit_combination(agg), minime_fit(agg)
    tq, tg = np.zeros(6), np.zeros(6)
    for v in vecs:
        tq += fit_combination(v).predicted
        tg += minime_fit(v).predicted
    return [[name, "single_block", err(q.per_metric_rel_err, agg),
             err(g.per_metric_rel_err, agg)],
            [name, "per_event_sum", err(rel_error(agg, tq), agg),
             err(rel_error(agg, tg), agg)]]

def table3(name, n, res):
    fid = res.fidelity()
    return [name, n, res.stats["n_events"], res.stats["trace_bytes"],
            res.stats["grammar_bytes"], res.stats["compression_ratio"],
            fid.mean, bool(fid.comm_lossless)]

fig, tab = [], []
for name, builder in PROGRAMS.items():
    fn, args, axes = builder(8)
    tr = trace_fn(fn, *args, axis_sizes=axes)
    fig += fig56(name, [e.vector for e in tr.compute_events()])
    for n in (4, 8):
        fn, args, axes = builder(n)
        tab.append(table3(name, n, synthesize(fn, *args, axis_sizes=axes,
                                              out_dir=str(OUT))))
streams = pipeline_traces(8)
fig += fig56("pipeline", [e.vector for e in streams[0]
                          if not hasattr(e, "kind")])
for n in (4, 8):
    tab.append(table3("pipeline", n, synthesize(
        rank_traces=pipeline_traces(n), axis_sizes={"stage": n},
        out_dir=str(OUT))))
(OUT / "rows.json").write_text(json.dumps({"fig56": fig, "table3": tab}))
"""


@pytest.fixture(scope="module")
def reference_rows(tmp_path_factory):
    out = run_reference(REFERENCE_ROWS, tmp_path_factory.mktemp("rows"),
                        timeout=600)
    return out["rows"]


def _port_fig56() -> list[list]:
    rows = []
    for name, make in PROGRAMS.items():
        fn, args, axes = make(8)
        tr = trace_fn(fn, *args, axis_sizes=axes)
        rows += TB.fig56_rows(name, [e.vector for e in tr.compute_events()])
    rows += TB.fig56_rows("pipeline", [e.vector for e in pipeline_traces(8)[0]
                                       if isinstance(e, ComputeEvent)])
    return [[r["program"], r["mode"], r["siesta_err"], r["minime_err"]]
            for r in rows]


def test_fig56_rows_equal_the_references(reference_rows):
    """Figs. 5-6: both programs and the pipeline at 8 ranks, each error
    equal to the reference's (the same compute events and B); and the
    paper's finding: the QP fits better than the greedy, by a factor of
    ten or more, in both modes (on these programs the greedy is off by
    47-178 times the target, the QP by 0.8-14%)."""
    got, want = _port_fig56(), reference_rows["fig56"]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2:], w[2:], rtol=TIME_RTOL, atol=1e-15)
        assert 10 * g[2] < g[3]


@pytest.mark.parametrize("program", ["stencil2d", "dp_train", "pipeline"])
def test_table3_rows_equal_the_references(program, reference_rows, tmp_path):
    """Table 3 at 4 and 8 ranks: events, trace and grammar bytes, ratio, δ̄
    and losslessness equal the reference's (the port traces the programs
    into the reference's own TraceStores); synthesize's seconds are the
    host's and left out."""
    want = [r for r in reference_rows["table3"] if r[0] == program]
    assert [r[1] for r in want] == [4, 8]
    for w in want:
        n = w[1]
        if program == "pipeline":
            res = synthesize(rank_traces=pipeline_traces(n),
                             axis_sizes={"stage": n}, device="cpu",
                             out_dir=tmp_path)
        else:
            fn, args, axes = PROGRAMS[program](n)
            res = synthesize(fn, *args, axis_sizes=axes, device="cpu",
                             out_dir=tmp_path)
        row = TB.table3_row(program, n, res, 0.0)
        got = [row[k] for k in ("program", "ranks", "events", "trace_bytes",
                                "grammar_bytes")]
        assert got == w[:5]
        assert row["ratio"] == pytest.approx(w[5], rel=TIME_RTOL)
        assert abs(row["rel_err"] - w[6]) <= 1e-12
        assert row["lossless_comm"] and w[7]

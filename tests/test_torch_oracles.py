"""The port's frozen parity oracles against the reference's.

:mod:`repro_torch.core.sequitur_reference` and
:mod:`repro_torch.core.frontend_reference` are copies of the reference's
object-graph Sequitur and per-event front end.  The reference's copies
import no JAX, so they run in this process; only the reference's
``synthesize`` (for δ̄) runs in a subprocess (one for the file, see
test_torch_harness.py), on the port's TraceStore files.

Parity levels, as each test states: grammars (by ``to_json`` and rule
order), terminal keys, merged programs, cluster ids, representatives and
the compression ratio bit-identical, the same NumPy code on both sides;
δ̄ within 1e-12 of the reference's synthesize on the same store (the
corpus tests' level; the replay runs in torch on one side and XLA on the
other).  Within the port, the columnar front half (``compress_store``,
``synthesize``) and the flat Sequitur equal the port's oracles, as
``tests/test_trace_ir.py`` and ``tests/test_sequitur_kernel.py`` pin on
the reference side.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from repro.core import frontend_reference as ref_frontend
from repro.core import sequitur_reference as ref_sequitur
from repro.core.events import CommEvent as RefComm
from repro.core.events import ComputeEvent as RefCompute
from repro.core.grammar import Grammar as RefGrammar
from repro.core.grammar import TerminalTable as RefTable
from repro.core.trace_ir import TraceStore as RefStore
from repro_torch.configs.registry import SCENARIO_IDS, build_scenario
from repro_torch.core import frontend_reference, sequitur, sequitur_reference
from repro_torch.core import trace_ir
from repro_torch.core.events import CommEvent, ComputeEvent
from repro_torch.core.grammar import Grammar, TerminalTable
from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore, compress_store
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

#: the zoo's streams at 4 ranks x 2 steps (the port's build), then seeded
#: random streams
RANDOM_SEEDS = (0, 1, 2, 3, 7, 11, 23, 42)
STORES = tuple(SCENARIO_IDS) + tuple(f"random-{s}" for s in RANDOM_SEEDS)
#: δ̄, port against the reference's synthesize on the same store
DELTA_ATOL = 1e-12

REFERENCE_CODE = """
import json
from repro.core.synthesize import synthesize
from repro.core.trace_ir import TraceStore

names = json.loads((OUT.parent / "names.json").read_text())
out = {}
for n in names:
    st = TraceStore.load(OUT.parent / "npz" / f"{n}.npz")
    res = synthesize(store=st, name=n.replace("-", "_"))
    out[n] = {"delta": float(res.fidelity(sample_ranks=None).mean),
              "ratio": float(res.stats["compression_ratio"])}
(OUT / "synth.json").write_text(json.dumps(out))
"""


def _random_traces(seed: int, n_ranks: int = 5):
    """Seeded fuzz traces (the generator of ``tests/test_trace_ir.py``):
    lognormal metric spreads with zero columns and near-duplicates, every
    comm kind and detail shape, per-rank stream heterogeneity."""
    rng = np.random.RandomState(seed)
    kinds = [("psum", ()), ("all_gather", (0,)), ("reduce_scatter", (0,)),
             ("all_to_all", (0, 0)), ("pmax", ()), ("pmin", ()),
             ("broadcast", (0,)),
             ("ppermute", ("shift", 1)),
             ("ppermute", ("shift", 2, (0, 1, 2))),
             ("ppermute", ("perm", ((0, 1), (1, 0))))]
    comms = []
    for _ in range(rng.randint(2, 7)):
        kind, detail = kinds[rng.randint(len(kinds))]
        shape = tuple(int(s) for s in rng.randint(1, 9, rng.randint(1, 4)))
        dtype = ["float32", "bfloat16", "int32"][rng.randint(3)]
        comms.append(CommEvent(kind, shape, dtype, ("x",), detail))

    def compute():
        v = np.abs(rng.lognormal(8, 4, 6))
        v[rng.rand(6) < 0.35] = 0.0
        if rng.rand() < 0.3:
            v = v * (1 + 0.01 * rng.randn(6))
        return ComputeEvent(tuple(np.abs(v)))

    traces = []
    for _ in range(n_ranks):
        tr = []
        for _ in range(rng.randint(3, 40)):
            tr.append(comms[rng.randint(len(comms))] if rng.rand() < 0.45
                      else compute())
        if rng.rand() < 0.5:
            traces.append(list(tr))
        traces.append(tr)
    return traces[:n_ranks]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """name -> (the store's path, the port's store), and the reference's
    synthesize of each (one subprocess)."""
    base = tmp_path_factory.mktemp("oracles")
    (base / "npz").mkdir()
    out = {}
    for name in STORES:
        if name.startswith("random-"):
            traces = _random_traces(int(name.split("-")[1]))
            st = TraceStore.from_rank_traces(traces, {"x": len(traces)})
        else:
            st = build_scenario(name, n_ranks=4, steps=2)
        path = base / "npz" / f"{name}.npz"
        st.save(path)
        out[name] = (path, TraceStore.load(path))
    (base / "names.json").write_text(json.dumps(list(STORES)))
    ref = run_reference(REFERENCE_CODE, base / "ref", timeout=600)
    return out, ref["synth"]


def _grammar_state(grammars, merged, ids, reps):
    """Everything the front half produces, as plain data."""
    return {
        "grammars": [g.to_json() for g in grammars],
        "rule_order": [list(g.rules) for g in grammars],
        "keys": [[e.key() for e in g.table.events] for g in grammars],
        "merged_rules": merged.rules, "mains": merged.mains,
        "cluster_ranks": merged.cluster_ranks,
        "merged_keys": [e.key() for e in merged.table.events],
        "merged_size": merged.encoded_size_bytes(),
        "ids": ids,
        "reps": {int(k): np.asarray(v).tolist() for k, v in reps.items()},
    }


@pytest.mark.parametrize("name", STORES)
def test_frontend_oracle_bit_identical_to_the_references(stores, name):
    """Grammars by ``to_json``, terminal keys, merged program, ids,
    representatives and compression ratio bit-identical: the port's
    per-event oracle against the reference's on the same streams."""
    path, st = stores[0][name]
    traces = st.to_rank_traces()
    mine = frontend_reference.compress_rank_traces_reference(traces)
    theirs = ref_frontend.compress_rank_traces_reference(
        RefStore.load(path).to_rank_traces())
    a, b = _grammar_state(*mine), _grammar_state(*theirs)
    assert a == b
    raw = st.raw_trace_bytes()
    assert raw == RefStore.load(path).raw_trace_bytes()
    assert raw / mine[1].encoded_size_bytes() == \
        raw / theirs[1].encoded_size_bytes()


@pytest.mark.parametrize("name", STORES)
def test_columnar_front_half_equals_the_ports_oracle(stores, name):
    """``trace_ir.compress_store`` equals the port's per-event oracle
    (``tests/test_trace_ir.py:158-212,269`` on the reference side)."""
    _, st = stores[0][name]
    g1, m1, ids1, reps1 = compress_store(st)
    g2, m2, ids2, reps2 = frontend_reference.compress_rank_traces_reference(
        st.to_rank_traces())
    assert _grammar_state(g1, m1, ids1, reps1) == \
        _grammar_state(g2, m2, ids2, reps2)


@pytest.mark.parametrize("name", STORES)
def test_synthesize_matches_the_oracle_and_the_references_delta(stores,
                                                                name):
    """The port's columnar ``synthesize`` builds the oracle's merged program
    and compression ratio (bit-identical), and its δ̄ is the reference's
    synthesize's on the same store within 1e-12: on every store, the random
    ones whose fit overflows its integer polish too (seeds 1, 2, 3, 7, 11
    and 23: both packages cast the same non-finite PGD rows to int64)."""
    _, st = stores[0][name]
    res = synthesize(store=st, name=name.replace("-", "_"), device="cpu")
    _, merged, ids, _ = frontend_reference.compress_rank_traces_reference(
        st.to_rank_traces())
    assert res.rank_ids == ids
    assert res.merged.rules == merged.rules
    assert res.merged.mains == merged.mains
    ratio = st.raw_trace_bytes() / merged.encoded_size_bytes()
    want = stores[1][name]
    assert res.stats["compression_ratio"] == ratio == want["ratio"]
    got = res.fidelity(sample_ranks=None).mean
    assert abs(got - want["delta"]) <= DELTA_ATOL, (got, want["delta"])


def _id_streams():
    """Seeded id streams across alphabet sizes with injected runs, the
    RLE-adversarial shapes and periodic inline chains (the reference's
    ``tests/test_sequitur_kernel.py`` corpus)."""
    out = []
    for seed in range(10):
        rng = np.random.RandomState(seed)
        for _ in range(30):
            n = rng.randint(0, 220)
            alpha = int(rng.choice([1, 2, 3, 4, 5, 10, 30]))
            s = rng.randint(0, alpha, n).tolist()
            if n and rng.rand() < 0.6:
                for _ in range(rng.randint(1, 4)):
                    pos = rng.randint(0, len(s))
                    s = s[:pos] + [s[pos]] * rng.randint(2, 12) + s[pos:]
            out.append(s)
    out += [[3, 1, 2, 3, 1, 1], [0, 1, 0, 1, 1, 0, 1],
            [2, 2, 2, 1, 2, 2, 2, 1, 2, 2, 2], [0, 0, 1, 0, 0, 1, 0, 0],
            [1, 2, 1, 2, 2, 2, 1, 2, 1],
            [0] * 50 + [1] + [0] * 50 + [1] + [0] * 50]
    for period, reps in (([1, 2, 1, 3], 50), ([1, 2, 3, 4, 1, 2], 30),
                         ([0, 1, 2, 0, 1, 3], 40)):
        out += [period * reps, period * reps + period[:2]]
    inner = [1, 2] * 5 + [3]
    out.append((inner * 8 + [4]) * 6)
    return out


def test_sequitur_oracle_bit_identical_to_the_references():
    """The port's object-graph Sequitur emits the reference's rules (and
    rule-id order) and ``to_json`` on every stream, pushed one by one and
    as runs; the port's flat kernel equals the port's oracle."""
    assert sequitur_reference.Sequitur.KERNEL == "reference"
    assert sequitur.Sequitur.KERNEL == "flat"
    assert trace_ir.Sequitur is sequitur.Sequitur
    for s in _id_streams():
        mine, theirs = sequitur_reference.Sequitur(), ref_sequitur.Sequitur()
        mine.push_many(s)
        theirs.push_many(s)
        rules = mine.grammar_rules()
        assert rules == theirs.grammar_rules()
        assert list(rules) == list(theirs.grammar_rules())
        assert Grammar(rules=rules, table=TerminalTable()).to_json() == \
            RefGrammar(rules=theirs.grammar_rules(),
                       table=RefTable()).to_json()
        assert mine.expand() == s and mine.size() == theirs.size()
        flat = sequitur.Sequitur()
        flat.push_ids(np.asarray(s, dtype=np.int64))
        assert flat.grammar_rules() == rules
        assert list(flat.grammar_rules()) == list(rules)
    rng = np.random.RandomState(3)
    for _ in range(50):
        n = rng.randint(0, 40)
        runs = list(zip(rng.randint(0, 3, n).tolist(),
                        rng.randint(1, 9, n).tolist()))
        mine, theirs = sequitur_reference.Sequitur(), ref_sequitur.Sequitur()
        flat = sequitur.Sequitur()
        for sym, count in runs:
            mine.push_run(sym, count)
            theirs.push_run(sym, count)
            flat.push_run(sym, count)
        assert mine.grammar_rules() == theirs.grammar_rules() == \
            flat.grammar_rules()


def test_cluster_oracle_bit_identical_to_the_references():
    """The per-event clustering loop: the same cluster ids and
    representatives in both packages, on near-duplicates and zeros."""
    rng = np.random.RandomState(0)
    rows = [tuple(v) for v in np.abs(rng.lognormal(10, 3, (300, 6)))]
    rows += [(1e9, 1e6, 1e8, 0., 0., 0.), (1.02e9, 1.01e6, 1.01e8, 0., 0.,
                                             0.)] * 5
    mine, reps = frontend_reference.cluster_compute_events_reference(
        [ComputeEvent(r) for r in rows])
    theirs, ref_reps = ref_frontend.cluster_compute_events_reference(
        [RefCompute(r) for r in rows])
    assert [e.cluster_id for e in mine] == [e.cluster_id for e in theirs]
    assert sorted(reps) == sorted(ref_reps)
    for k in reps:
        np.testing.assert_array_equal(reps[k], ref_reps[k])
    assert RefComm is not CommEvent      # two packages, no shared objects

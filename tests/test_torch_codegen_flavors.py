"""The two codegen flavors of the port: the program table
(``core/codegen.py``) and the unrolled per-symbol oracle
(``core/codegen_reference.py``, ``synthesize(codegen="unrolled")``).

On the paper's three programs (stencil2d and dp_train traced from their
per-rank torch programs, the pipeline from its TraceSession) and on a
synthetic trace with two signature groups, both flavors give bit-identical
δ̄, identical per-rank comm sequences as executed (every ``comm.do`` call
of every rank, in order, against the original trace's keys) and
bit-identical final replay states.  The unrolled module's source equals the
reference's unrolled emitter's, but for its imports (the reference in a
subprocess, see test_torch_harness.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.synthesize import synthesize
from repro_torch.core.trace_ir import TraceStore
from repro_torch.sharding.collectives import LocalSim
from repro_torch.workloads import PROGRAMS, pipeline_traces, \
    synthetic_rank_traces
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

TARGETS = ("stencil2d", "dp_train", "pipeline", "synthetic16")


def _synth(name: str, codegen: str, out_dir):
    kw = dict(device="cpu", codegen=codegen, name=f"{name}_{codegen}",
              out_dir=out_dir)
    if name in PROGRAMS:
        fn, args, axes = PROGRAMS[name]()
        return synthesize(fn, *args, axis_sizes=axes, **kw)
    if name == "pipeline":
        return synthesize(rank_traces=pipeline_traces(), **kw)
    store = TraceStore.from_rank_traces(synthetic_rank_traces(16, reps=20),
                                        {"x": 16})
    return synthesize(store=store, **kw)


class _Recorder(LocalSim):
    """LocalSim that records every collective a replay issues."""

    def __init__(self):
        super().__init__()
        self.calls: list[tuple] = []

    def do(self, st, buf, *, kind, axes, detail, shape, dtype):
        self.calls.append((kind, tuple(axes), tuple(detail), tuple(shape),
                           dtype, buf))
        return super().do(st, buf, kind=kind, axes=axes, detail=detail,
                          shape=shape, dtype=dtype)


def _executed_comms(res, rank: int) -> list[tuple]:
    rec = _Recorder()
    res.proxy.module.run_rank(res.proxy.init_state(0), rec, rank)
    return rec.calls


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for name in TARGETS:
        d = tmp_path_factory.mktemp(name)
        out[name] = {cg: _synth(name, cg, d / cg)
                     for cg in ("table", "unrolled")}
    return out


@pytest.mark.parametrize("name", TARGETS)
def test_delta_bit_identical_across_flavors(name, pairs):
    t, u = pairs[name]["table"], pairs[name]["unrolled"]
    assert t.stats["codegen"] == "table" and u.stats["codegen"] == "unrolled"
    assert u.proxy.module.CODEGEN == "unrolled"
    ft, fu = t.fidelity(sample_ranks=None), u.fidelity(sample_ranks=None)
    assert ft.comm_lossless and fu.comm_lossless
    np.testing.assert_array_equal(ft.delta, fu.delta)
    assert ft.mean == fu.mean
    for key in ("SIGNATURE_GROUPS", "CLUSTER_RANKS", "_GUARDS",
                "NOISE_MODELS", "COMM_BUFFERS"):
        assert getattr(t.proxy.module, key) == getattr(u.proxy.module, key)
    if name == "synthetic16":
        assert len(u.proxy.module.SIGNATURE_GROUPS) == 2


@pytest.mark.parametrize("name", TARGETS)
def test_executed_comm_sequences_identical(name, pairs):
    """Every rank issues the same collectives in the same order under both
    flavors, and they are the original trace's comm events."""
    t, u = pairs[name]["table"], pairs[name]["unrolled"]
    for r in range(t.store.n_ranks):
        got_t, got_u = _executed_comms(t, r), _executed_comms(u, r)
        assert got_t == got_u, r
        want = [t.merged.table[i] for i in t.proxy.expand_rank_ids(r)]
        want = [(e.kind, tuple(e.axes), tuple(e.detail), tuple(e.shape),
                 e.dtype) for e in want if hasattr(e, "kind")]
        assert [c[:5] for c in got_u] == want, r


@pytest.mark.parametrize("name", TARGETS)
def test_replay_states_bit_identical(name, pairs):
    t, u = pairs[name]["table"], pairs[name]["unrolled"]
    st, su = t.proxy.run_all(), u.proxy.run_all()
    assert sorted(st) == sorted(su) == list(range(t.store.n_ranks))
    for r in st:
        for k in st[r]:
            assert torch.equal(st[r][k], su[r][k]), (name, r, k)


def test_unknown_flavor_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown codegen flavor"):
        _synth("pipeline", "rolled", tmp_path)


REFERENCE = """
import json
from repro.core.synthesize import synthesize
from repro.core.trace_ir import TraceStore
from benchmarks.synthesize_time import _synthetic_traces
from benchmarks.common import pipeline_traces
out = {}
store = TraceStore.from_rank_traces(_synthetic_traces(16, reps=20), {"x": 16})
res = synthesize(store=store, codegen="unrolled", name="synthetic16_unrolled",
                 out_dir=str(OUT / "a"))
out["synthetic16"] = [res.source, res.fidelity(sample_ranks=None).mean]
res = synthesize(rank_traces=pipeline_traces(), codegen="unrolled",
                 name="pipeline_unrolled", out_dir=str(OUT / "b"))
out["pipeline"] = [res.source, res.fidelity(sample_ranks=None).mean]
(OUT / "ref.json").write_text(json.dumps(out))
"""


def _body(source: str) -> list[str]:
    """Emitted source without its docstring and imports, with the package
    name normalised."""
    end = source.index('"""', 3) + 3
    lines = source[end:].replace("repro_torch.", "repro.").splitlines()
    return [ln for ln in lines if not ln.startswith(("from ", "import "))]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE,
                         tmp_path_factory.mktemp("unrolled_ref"))["ref"]


@pytest.mark.parametrize("name", ["synthetic16", "pipeline"])
def test_unrolled_source_and_delta_are_the_references(name, pairs, ref):
    src, delta = ref[name]
    u = pairs[name]["unrolled"]
    assert _body(u.source) == _body(src)
    assert abs(u.fidelity(sample_ranks=None).mean - delta) <= 1e-12

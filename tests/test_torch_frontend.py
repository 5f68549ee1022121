"""The port's copies of the front half (events, Sequitur, grammars, merge,
trace IR, codegen) against the reference's, which import without JAX and so
run in-process: same inputs, bit-identical outputs, and one ``.npz``
TraceStore format read and written by both packages."""
from __future__ import annotations

import numpy as np
import pytest

from benchmarks.synthesize_time import _synthetic_traces
from repro.core import codegen as jax_codegen
from repro.core import noise as jax_noise
from repro.core import trace_ir as jax_ir
from repro.core.events import METRIC_NAMES as JAX_METRIC_NAMES
from repro.core.events import dtype_bytes as jax_dtype_bytes
from repro_torch.core import codegen, noise, trace_ir
from repro_torch.core.events import METRIC_NAMES, dtype_bytes, is_comm
from repro_torch.workloads import synthetic_rank_traces
from test_torch_harness import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_metric_schema_is_the_reference_s():
    assert METRIC_NAMES == JAX_METRIC_NAMES
    for name in ("float32", "bfloat16", "int8", "bool", "int32", "float16"):
        assert dtype_bytes(name) == jax_dtype_bytes(name)


@pytest.mark.parametrize("n", [4, 16])
def test_workload_equals_the_benchmark_s(n):
    mine = synthetic_rank_traces(n)
    ref = _synthetic_traces(n)
    assert [[e.key() for e in tr] for tr in mine] == \
        [[e.key() for e in tr] for tr in ref]


@pytest.mark.parametrize("n", [4, 16])
def test_compress_store_bit_identical(n):
    mine = trace_ir.TraceStore.from_rank_traces(synthetic_rank_traces(n),
                                                {"x": n})
    ref = jax_ir.TraceStore.from_rank_traces(_synthetic_traces(n), {"x": n})
    np.testing.assert_array_equal(mine.metrics, ref.metrics)
    g1, m1, ids1, reps1 = trace_ir.compress_store(mine, 0.05, 0.5)
    g2, m2, ids2, reps2 = jax_ir.compress_store(ref, 0.05, 0.5)
    assert repr(m1.rules) == repr(m2.rules)
    assert repr(m1.mains) == repr(m2.mains)
    assert ids1 == ids2
    assert sorted(reps1) == sorted(reps2)
    for k in reps1:
        np.testing.assert_array_equal(reps1[k], reps2[k])
    assert m1.encoded_size_bytes() == m2.encoded_size_bytes()


def test_trace_store_npz_is_shared(tmp_path):
    """A store saved by either package loads in the other unchanged."""
    ref = jax_ir.TraceStore.from_rank_traces(_synthetic_traces(8), {"x": 8})
    ref.save(tmp_path / "ref.npz")
    mine = trace_ir.TraceStore.load(tmp_path / "ref.npz")
    assert mine.axis_sizes == {"x": 8} and mine.n_events == ref.n_events
    mine.save(tmp_path / "mine.npz")
    back = jax_ir.TraceStore.load(tmp_path / "mine.npz")
    np.testing.assert_array_equal(back.metrics, ref.metrics)
    assert [[e.key() for e in tr] for tr in back.to_rank_traces()] == \
        [[e.key() for e in tr] for tr in ref.to_rank_traces()]


def test_codegen_tables_match_and_import_the_port():
    mine = trace_ir.TraceStore.from_rank_traces(synthetic_rank_traces(16),
                                                {"x": 16})
    ref = jax_ir.TraceStore.from_rank_traces(_synthetic_traces(16), {"x": 16})
    _, m1, _, _ = trace_ir.compress_store(mine, 0.05, 0.5)
    _, m2, _, _ = jax_ir.compress_store(ref, 0.05, 0.5)
    combos = {gid: ((1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1), 1)
              for gid, ev in enumerate(m1.table.events) if not is_comm(ev)}
    nm1 = noise.calibrate(mine).terminal_params(m1.table.events)
    nm2 = jax_noise.calibrate(ref).terminal_params(m2.table.events)
    assert nm1 == nm2
    s1 = codegen.generate_source(m1, combos, "p", {"x": 16}, noise_models=nm1)
    s2 = jax_codegen.generate_source(m2, combos, "p", {"x": 16}, noise_models=nm2)
    assert "from repro_torch.core.progtable import" in s1
    body = lambda s: s[s.index('"""', 3):].replace("repro_torch.", "repro.")
    assert body(s1) == body(s2)

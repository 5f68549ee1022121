"""The port's corpus synthesis against the live JAX reference.

The port builds the zoo's five scenarios at 4 ranks x 2 steps and a
16-rank synthetic trace, and saves each TraceStore as ``.npz``; the
reference (one subprocess for the whole file, see test_torch_harness.py)
and the port both run ``synthesize_corpus`` over the same files.  The port
walker's costs differ from the reference's (ROADMAP §3, D1-D6), so each
side's own build of the zoo would differ: both read the port's files.

Parity levels, as each test states: joint clusters, representatives, the
corpus table and the non-timing stats bit-identical (the same NumPy code
on both sides); the fits' integer counts and unrolls equal (the PGD
solutions agree to float32 rounding, and the integer polish lands on the
same point); per-scenario δ̄ within 1e-12.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import (SCENARIO_IDS, build_scenario,
                                          ingest_scenarios)
from repro_torch.core import blocks, proxy_search
from repro_torch.core.corpus_store import CorpusStore
from repro_torch.core.events import cluster_corpus
from repro_torch.core.interproc import table_fingerprint
from repro_torch.core.synthesize import _fit_cache_key, synthesize_corpus
from repro_torch.core.trace_ir import TraceStore
from repro_torch.workloads import synthetic_rank_traces
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

NAMES = tuple(SCENARIO_IDS) + ("halo-16",)
#: per-scenario δ̄, port against reference on the same TraceStore
DELTA_ATOL = 1e-12
#: stats that time something (none in the batch path's stats today)
TIMING_STATS = ("grammar_ms",)

REFERENCE_CODE = """
import json
import numpy as np
from repro.core.events import cluster_corpus
from repro.core.interproc import table_fingerprint
from repro.core.synthesize import _fit_cache_key, synthesize_corpus
from repro.core.trace_ir import TraceStore

names = json.loads((OUT.parent / "names.json").read_text())
stores = [(n, TraceStore.load(OUT.parent / "npz" / f"{n}.npz")) for n in names]
cids, reps = cluster_corpus([s.metrics for _, s in stores], 0.05)
corp = synthesize_corpus(stores)
rep = corp.report()
fits = {str(g): {"x": [int(v) for v in f.x], "unroll": int(f.unroll),
                 "target": [float(v) for v in f.target],
                 "key": _fit_cache_key(f.target)}
        for g, f in corp.fits.items()}
arrays = {f"cids_{n}": c for n, c in zip(names, cids)}
arrays.update({f"rep_{k}": v for k, v in reps.items()})
arrays.update({f"corp_rep_{k}": v for k, v in corp.reps.items()})
np.savez(OUT / "clusters.npz", **arrays)
(OUT / "corpus.json").write_text(json.dumps({
    "fingerprint": table_fingerprint(corp.table),
    "n_terminals": len(corp.table),
    "fits": fits,
    "stats": corp.stats,
    "report": {n: r for n, r in rep["scenarios"].items()},
    "mean_delta": rep["mean_delta"],
    "all_comm_lossless": rep["all_comm_lossless"],
}, default=str))
"""


def _inputs() -> dict[str, TraceStore]:
    stores = {n: build_scenario(n, n_ranks=4, steps=2) for n in SCENARIO_IDS}
    stores["halo-16"] = TraceStore.from_rank_traces(
        synthetic_rank_traces(16), {"x": 16})
    return stores


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Both sides' corpus synthesis over the same saved TraceStores."""
    import json
    root = tmp_path_factory.mktemp("corpus")
    (root / "npz").mkdir()
    for n, st in _inputs().items():
        st.save(root / "npz" / f"{n}.npz")
    (root / "names.json").write_text(json.dumps(list(NAMES)))
    stores = [(n, TraceStore.load(root / "npz" / f"{n}.npz")) for n in NAMES]
    port = synthesize_corpus(stores, device="cpu", out_dir=root / "port")
    ref = run_reference(REFERENCE_CODE, root / "ref", timeout=600)
    return {"stores": dict(stores), "port": port, "port_report": port.report(),
            "ref": ref["corpus"], "ref_clusters": ref["clusters"]}


def test_joint_clusters_and_reps_are_bit_identical(corpus):
    stores = corpus["stores"]
    cids, reps = cluster_corpus([stores[n].metrics for n in NAMES], 0.05)
    want = corpus["ref_clusters"]
    for n, c in zip(NAMES, cids):
        np.testing.assert_array_equal(c, want[f"cids_{n}"])
    for prefix, got in (("rep_", reps), ("corp_rep_", corpus["port"].reps)):
        assert sorted(f"{prefix}{k}" for k in got) == sorted(
            k for k in want if k.startswith(prefix))
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[f"{prefix}{k}"])


def test_corpus_table_is_the_references(corpus):
    """Bit-identical: the fingerprint hashes every terminal's key in order."""
    port, ref = corpus["port"], corpus["ref"]
    assert table_fingerprint(port.table) == ref["fingerprint"]
    assert len(port.table) == ref["n_terminals"]


def test_fit_counts_and_unrolls_equal_the_references(corpus):
    """Exact: integer counts, unroll, and the target the fit was given."""
    port, ref = corpus["port"], corpus["ref"]["fits"]
    assert sorted(str(g) for g in port.fits) == sorted(ref)
    for g, fr in port.fits.items():
        want = ref[str(g)]
        assert [int(v) for v in fr.x] == want["x"], g
        assert fr.unroll == want["unroll"], g
        assert [float(v) for v in fr.target] == want["target"], g


def test_fit_cache_keys_equal_the_references(corpus):
    """The content address of a fit: the same key in both packages, so a
    fit_cache.npz written by either serves the other."""
    for g, fr in corpus["port"].fits.items():
        assert _fit_cache_key(fr.target) == corpus["ref"]["fits"][str(g)]["key"]


@pytest.mark.parametrize("name", NAMES)
def test_per_scenario_delta_within_1e_12(corpus, name):
    got = corpus["port_report"]["scenarios"][name]
    want = corpus["ref"]["report"][name]
    assert abs(got["mean_delta"] - want["mean_delta"]) <= DELTA_ATOL
    assert got["comm_lossless"] and want["comm_lossless"]
    for k in ("compression_ratio", "n_events", "n_ranks"):
        assert got[k] == want[k], k


def test_report_totals_equal_the_references(corpus):
    got, want = corpus["port_report"], corpus["ref"]
    assert got["all_comm_lossless"] and want["all_comm_lossless"]
    assert abs(got["mean_delta"] - want["mean_delta"]) <= DELTA_ATOL


def test_non_timing_stats_equal_the_references(corpus):
    got = {k: v for k, v in corpus["port"].stats.items()
           if k not in TIMING_STATS}
    want = {k: v for k, v in corpus["ref"]["stats"].items()
            if k not in TIMING_STATS}
    assert got == want
    assert got["n_solver_calls"] == 1


def test_one_fit_batch_call_for_the_whole_corpus(corpus, monkeypatch):
    calls = []
    real = proxy_search.fit_batch

    def counting(targets, *a, **kw):
        calls.append(len(targets))
        return real(targets, *a, **kw)

    monkeypatch.setattr(proxy_search, "fit_batch", counting)
    stores = list(corpus["stores"].items())[:3]
    synthesize_corpus(stores, device="cpu")
    assert len(calls) == 1


def test_pgd_rows_do_not_depend_on_their_batch(corpus):
    """A target's fit alone equals its fit inside a batch of 64 (the
    corpus targets, repeated): bit for bit in the real-valued solution."""
    reps = corpus["port"].reps
    base = np.stack([reps[c] for c in sorted(reps)])
    batch = np.concatenate([base] * (64 // len(base) + 1))[:64]
    b = proxy_search.substituted_matrix(blocks.calibration_matrix())
    bss = np.broadcast_to(b, (64,) + b.shape)
    full = proxy_search._pgd_grid(batch, bss, device="cpu")
    for i in range(len(base)):
        one = proxy_search._pgd_grid(batch[i:i + 1], bss[:1], device="cpu")
        np.testing.assert_array_equal(one[0], full[i])
    fits = proxy_search.fit_batch(batch, device="cpu")
    for i in range(len(base)):
        one = proxy_search.fit_batch(batch[i:i + 1], device="cpu")[0]
        np.testing.assert_array_equal(one.x, fits[i].x)
        assert one.unroll == fits[i].unroll


@pytest.mark.cuda
def test_pgd_on_the_card_equals_the_cpu_and_ignores_its_batch(corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check there)")
    reps = corpus["port"].reps
    base = np.stack([reps[c] for c in sorted(reps)])
    batch = np.concatenate([base] * (64 // len(base) + 1))[:64]
    gpu = proxy_search.fit_batch(batch, device="cuda")
    cpu = proxy_search.fit_batch(batch, device="cpu")
    for i in range(len(base)):
        one = proxy_search.fit_batch(batch[i:i + 1], device="cuda")[0]
        np.testing.assert_array_equal(one.x, gpu[i].x)
        np.testing.assert_array_equal(gpu[i].x, cpu[i].x)
        assert one.unroll == gpu[i].unroll == cpu[i].unroll


def test_synthesize_corpus_defaults_to_cuda_and_raises_without_it(
        corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stores = list(corpus["stores"].items())[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize_corpus(stores)


def test_registry_names_build_and_synthesize():
    """Registry names with builder keywords, as the reference takes them."""
    corp = synthesize_corpus(["ssm-decode", "transformer-dp"], n_ranks=2,
                             steps=1, device="cpu")
    assert list(corp.results) == ["ssm-decode", "transformer-dp"]
    rep = corp.report()
    assert rep["all_comm_lossless"]
    assert rep["scenarios"]["ssm-decode"]["n_ranks"] == 2


def test_ingest_scenarios_streams_and_is_idempotent(tmp_path):
    cs = CorpusStore(tmp_path / "c")
    added = ingest_scenarios(cs, ["ssm-decode", "moe-ep"], n_ranks=2,
                             steps=1)
    assert added == ["ssm-decode", "moe-ep"]
    assert ingest_scenarios(cs, ["ssm-decode", "moe-ep"], n_ranks=2,
                            steps=1) == []
    assert sorted(cs.names) == ["moe-ep", "ssm-decode"]
    assert cs.content_hash("moe-ep") == build_scenario(
        "moe-ep", n_ranks=2, steps=1).content_hash()

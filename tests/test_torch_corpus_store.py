"""The port's CorpusStore, fsck and fault layer, against the JAX reference.

The reference's ``corpus_store``, ``fsck`` and ``faults`` import no JAX, so
they run in this process beside the port's; its ``synthesize_corpus`` runs
in one subprocess for the whole file (test_torch_harness.py).  Inputs are
the port's zoo at 2 ranks x 1 step and the reference tests' three small
scenarios, the same TraceStores on both sides.

Parity levels, as each test states: store state (names, content hashes,
cluster assignments, representatives, manifest fingerprint) bit-identical
across packages and across serial and parallel ingest; incremental δ̄
bit-identical to batch δ̄; the port's δ̄ within 1e-12 of the reference's
on the same store; chaos outcomes (crashed, repaired, survivors) equal.
"""
from __future__ import annotations

import json
import shutil

import numpy as np
import pytest

from benchmarks import chaos as ref_chaos
from repro.core import corpus_store as ref_cs
from repro.core import faults as ref_faults
from repro_torch.configs.registry import SCENARIO_IDS, build_scenario
from repro_torch.core import chaos, faults, proxy_search
from repro_torch.core.corpus_store import (
    CorpusStore, FitCache, GrammarCache, IngestBatchError, LockTimeoutError,
    ScenarioCorruptError, ShardCorruptError, ToleranceMismatchError,
)
from repro_torch.core.synthesize import synthesize_corpus
from repro_torch.core.trace_ir import TraceStore
from test_torch_harness import one_thread, run_reference

pytestmark = pytest.mark.usefixtures("one_thread")

#: per-scenario δ̄, port against reference on the same store
DELTA_ATOL = 1e-12

_V1 = (2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.)
_V2 = (4.4e6, 1.2e4, 2.2e6, 0., 7.0, 1.0)
_V3 = (9.9e8, 5.5e5, 3.3e7, 1.1e3, 0., 2.0)
_VECS = [_V1, _V2, _V3, (1.3e7, 2.2e4, 5.1e6, 3.3e2, 1.0, 0.)]


def _store(vectors, n_ranks=4, pkg="repro_torch"):
    """A small trace of ``pkg``'s own classes (each package's store takes
    only its own TraceStore)."""
    ev = __import__(f"{pkg}.core.events", fromlist=["x"])
    ti = __import__(f"{pkg}.core.trace_ir", fromlist=["x"])
    comm = ev.CommEvent("psum", (8,), "float32", ("x",))
    tr = []
    for v in vectors:
        tr += [ev.ComputeEvent(tuple(v)), comm]
    return ti.TraceStore.from_rank_traces([list(tr) for _ in range(n_ranks)],
                                          {"x": n_ranks})



def _zoo() -> dict[str, TraceStore]:
    """The port's five scenarios at 2 ranks x 1 step and the reference
    tests' three small ones."""
    zoo = {n: build_scenario(n, n_ranks=2, steps=1) for n in SCENARIO_IDS}
    zoo.update(a=_store([_V1, _V2]), b=_store([_V1, _V3]),
               c=_store([_V2, _V3]))
    return zoo


def _deltas(corp) -> dict[str, float]:
    return {n: float(r.fidelity(sample_ranks=None).mean)
            for n, r in corp.results.items()}


def _state(cs) -> dict:
    """A store's state, comparable across packages."""
    ids, reps = cs.cluster_assignments()
    return {"names": list(cs.names),
            "hashes": {n: cs.content_hash(n) for n in cs.names},
            "ids": {n: ids[n].tolist() for n in cs.names},
            "reps": {int(k): v.tolist() for k, v in reps.items()},
            "fingerprint": cs.manifest_fingerprint()}


REFERENCE_CODE = """
import json, shutil
from repro.core.corpus_store import CorpusStore
from repro.core.synthesize import synthesize_corpus
from repro.core.trace_ir import TraceStore

def deltas(corp):
    return {n: float(r.fidelity(sample_ranks=None).mean)
            for n, r in corp.results.items()}

def state(cs):
    ids, reps = cs.cluster_assignments()
    return {"names": list(cs.names),
            "hashes": {n: cs.content_hash(n) for n in cs.names},
            "ids": {n: ids[n].tolist() for n in cs.names},
            "reps": {int(k): v.tolist() for k, v in reps.items()},
            "fingerprint": cs.manifest_fingerprint()}

root = OUT.parent
# (a) the port-written store, synthesized by the reference (on a copy)
shutil.copytree(root / "port_store", OUT / "port_store")
cs = CorpusStore(OUT / "port_store")
before = state(cs)
corp = synthesize_corpus(store=cs)
# (b) the reference writes its own store from the same files, synthesizes
# it (writing its fit cache), and the port opens it afterwards
names = json.loads((root / "names.json").read_text())
own = CorpusStore(root / "ref_store")
for n in names:
    own.add_scenario(n, TraceStore.load(root / "npz" / f"{n}.npz"))
own_corp = synthesize_corpus(store=own)
(OUT / "ref.json").write_text(json.dumps({
    "port_store_state": before, "port_store_stats": corp.stats,
    "port_store_deltas": deltas(corp),
    "ref_store_state": state(CorpusStore(root / "ref_store")),
    "ref_store_deltas": deltas(own_corp), "ref_store_stats": own_corp.stats,
}, default=str))
"""


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One store written by each package from the same files, each
    synthesized by the other (the reference's side in one subprocess)."""
    root = tmp_path_factory.mktemp("shared")
    zoo = _zoo()
    (root / "npz").mkdir()
    for n, st in zoo.items():
        st.save(root / "npz" / f"{n}.npz")
    (root / "names.json").write_text(json.dumps(sorted(zoo)))
    cs = CorpusStore(root / "port_store")
    for n in sorted(zoo):
        cs.add_scenario(n, TraceStore.load(root / "npz" / f"{n}.npz"))
    port_corp = synthesize_corpus(store=cs, device="cpu")
    ref = run_reference(REFERENCE_CODE, root / "ref", timeout=600)["ref"]
    return {"root": root, "zoo": zoo, "port_store": cs,
            "port_corp": port_corp, "port_deltas": _deltas(port_corp),
            "ref": ref}


# ---------------------------------------------------------------------------
# synthesis from the store (port only)
# ---------------------------------------------------------------------------


def test_incremental_equals_batch_bit_for_bit(tmp_path):
    zoo = _zoo()
    cs = CorpusStore(tmp_path / "c")
    names = sorted(zoo)
    for n in names[:4]:
        cs.add_scenario(n, zoo[n])
    synthesize_corpus(store=cs, device="cpu")          # warm over four
    for n in names[4:]:
        cs.add_scenario(n, zoo[n])
    inc = synthesize_corpus(store=cs, device="cpu")
    bat = synthesize_corpus([(n, zoo[n]) for n in cs.names], device="cpu")
    assert inc.stats["incremental"] and inc.stats["n_solver_calls"] == 1
    assert 0 < inc.stats["n_refit_terminals"] < len(inc.fits)
    got, want = _deltas(inc), _deltas(bat)
    assert got == want                                 # bit-identical
    for n in cs.names:
        assert inc.results[n].source == bat.results[n].source


def test_removal_equals_from_scratch_of_the_survivors(tmp_path):
    zoo = _zoo()
    cs = CorpusStore(tmp_path / "c")
    cs.add_scenarios(sorted(zoo.items()))
    synthesize_corpus(store=cs, device="cpu")
    cs.remove_scenario("transformer-dp")
    inc = synthesize_corpus(store=cs, device="cpu")
    bat = synthesize_corpus([(n, zoo[n]) for n in cs.names], device="cpu")
    assert "transformer-dp" not in inc.results
    assert _deltas(inc) == _deltas(bat)                # bit-identical
    # appended back under another name: bit-identical to batch again
    cs.add_scenario("transformer-dp-replay", zoo["transformer-dp"])
    inc = synthesize_corpus(store=cs, device="cpu")
    pairs = [(n, zoo["transformer-dp" if n.endswith("-replay") else n])
             for n in cs.names]
    assert _deltas(inc) == _deltas(synthesize_corpus(pairs, device="cpu"))


def test_unchanged_resynthesis_calls_no_solver(tmp_path, monkeypatch):
    zoo = _zoo()
    cs = CorpusStore(tmp_path / "c")
    cs.add_scenarios(sorted(zoo.items()))
    first = synthesize_corpus(store=cs, device="cpu")
    calls = []
    monkeypatch.setattr(proxy_search, "fit_batch",
                        lambda *a, **k: calls.append(1))
    again = synthesize_corpus(store=cs, device="cpu")
    assert not calls
    assert again.stats["n_solver_calls"] == 0
    assert again.stats["n_refit_terminals"] == 0
    assert again.stats["n_result_reused"] == len(zoo)
    reopened = synthesize_corpus(store=CorpusStore(tmp_path / "c"),
                                 device="cpu")
    assert reopened.stats["n_solver_calls"] == 0
    assert _deltas(reopened) == _deltas(first)


def test_parallel_ingest_equals_serial(tmp_path):
    """Bit-identical store state from a forked pool of 2 and from serial
    ingest."""
    zoo = _zoo()
    par = CorpusStore(tmp_path / "par")
    par.add_scenarios(sorted(zoo.items()), n_workers=2)
    ser = CorpusStore(tmp_path / "ser")
    ser.add_scenarios(sorted(zoo.items()))
    assert _state(par) == _state(ser)


# ---------------------------------------------------------------------------
# typed errors, where the reference raises them
# ---------------------------------------------------------------------------


def test_mismatched_rel_tol_raises_in_both(tmp_path):
    """As in the reference: the manifest pins rel_tol (ValueError on a
    reopen at another), and a readable index built at another tolerance
    is refused with ToleranceMismatchError, not silently re-clustered."""
    from repro_torch.core import corpus_store as port_cs
    for pkg, pkg_cs in (("repro", ref_cs), ("repro_torch", port_cs)):
        root = tmp_path / pkg
        cs = pkg_cs.CorpusStore(root)
        cs.add_scenario("a", _store([_V1], pkg=pkg))
        with pytest.raises(ValueError, match="rel_tol"):
            pkg_cs.CorpusStore(root, rel_tol=0.2)
        rogue = pkg_cs.ClusterIndex.empty(0.1)
        rogue.ingest("a", _store([_V1], pkg=pkg).metrics)
        rogue.save(root / "cluster_index.npz")
        with pytest.raises(pkg_cs.ToleranceMismatchError, match="rel_tol"):
            pkg_cs.CorpusStore(root)
        with pytest.raises(pkg_cs.ToleranceMismatchError, match="rel_tol"):
            pkg_cs.ClusterIndex.load(root / "cluster_index.npz",
                                     expected_rel_tol=0.05)
    cs = CorpusStore(tmp_path / "fresh")
    cs.add_scenario("a", _store([_V1]))
    with pytest.raises(ValueError, match="rel_tol"):
        synthesize_corpus(store=cs, rel_tol=0.2, device="cpu")
    with pytest.raises(ValueError, match="add_scenario"):
        synthesize_corpus(["a"], store=cs, device="cpu")


def _damage(pkg, pkg_cs, pkg_faults, case: str, root):
    """Drive one damage case through one package; returns the name of the
    exception class it raised (or a summary of the recorded error)."""
    def mk(vectors):
        return _store(vectors, pkg=pkg)

    cs = pkg_cs.CorpusStore(root / "corpus")
    cs.add_scenario("a", mk([_V1, _V2]))
    cs.add_scenario("b", mk([_V1, _V3]))
    try:
        if case == "truncated_npz":
            p = cs.scenario_path("a")
            p.write_bytes(p.read_bytes()[:48])
            cs._stores.clear()
            cs.load_scenario("a")
        elif case == "read_eio":
            cs._stores.clear()
            plan = pkg_faults.FaultPlan([pkg_faults.FaultSpec(
                "read.scenario_npz", "io_error")])
            with pkg_faults.active_plan(plan):
                cs._metrics_of("a")
        elif case == "torn_shard":
            shard = next(s for s in (root / "corpus" / "shards").iterdir()
                         if len(json.loads(s.read_text())["entries"]))
            shard.write_bytes(shard.read_bytes()[:20])
            cs2 = pkg_cs.CorpusStore(root / "corpus")
            errs = [type(e).__name__ for e in cs2.shard_errors.values()]
            cs2.repair()
            return f"recorded {errs}, repaired to {sorted(cs2.names)}"
        elif case == "lock_timeout":
            plan = pkg_faults.FaultPlan([pkg_faults.FaultSpec(
                "lock.acquire", "slow_lock", count=10_000)])
            with pkg_faults.active_plan(plan):
                with pkg_cs._file_lock(root / "x.lock", timeout=0.05):
                    pass
        elif case == "bad_item":
            bad = root / "nope.npz"
            bad.write_bytes(b"not an npz")
            cs.add_scenarios([("c", mk([_V2])), ("bad", str(bad))])
        elif case == "duplicate":
            cs.add_scenario("a", mk([_V3]))
        elif case == "bad_name":
            cs.add_scenario("../up", mk([_V3]))
    except Exception as e:                          # noqa: BLE001
        return type(e).__name__
    return "no error"


@pytest.mark.parametrize("case", ["truncated_npz", "read_eio", "torn_shard",
                                  "lock_timeout", "bad_item", "duplicate",
                                  "bad_name"])
def test_typed_errors_where_the_reference_raises_them(tmp_path, case):
    from repro_torch.core import corpus_store as port_cs
    want = _damage("repro", ref_cs, ref_faults, case, tmp_path / "ref")
    got = _damage("repro_torch", port_cs, faults, case, tmp_path / "port")
    assert got == want
    assert got != "no error"
    assert {"truncated_npz": "ScenarioCorruptError",
            "read_eio": "ScenarioCorruptError",
            "lock_timeout": "LockTimeoutError",
            "bad_item": "IngestBatchError"}.get(case, got) == got


def test_error_classes_keep_the_references_bases():
    for cls in (ToleranceMismatchError, ScenarioCorruptError,
                ShardCorruptError, LockTimeoutError, IngestBatchError):
        ref = getattr(ref_cs, cls.__name__)
        assert [b.__name__ for b in cls.__mro__] == [
            b.__name__ for b in ref.__mro__]


# ---------------------------------------------------------------------------
# stores across packages
# ---------------------------------------------------------------------------


def test_port_written_store_opens_in_the_reference(shared):
    """Bit-identical state: names, content hashes, cluster assignments,
    representatives and the manifest fingerprint."""
    root = shared["root"]
    ref_view = ref_cs.CorpusStore(root / "port_store")
    assert _state(ref_view) == _state(shared["port_store"])
    assert shared["ref"]["port_store_state"] == json.loads(
        json.dumps(_state(shared["port_store"])))


def test_port_written_fit_cache_loads_in_the_reference(shared):
    path = shared["root"] / "port_store" / "fit_cache.npz"
    port, ref = FitCache.load(path), ref_cs.FitCache.load(path)
    assert len(port) == len(ref) == len(shared["port_corp"].fits)
    for k, fr in port._fits.items():
        want = ref.get(k)
        np.testing.assert_array_equal(fr.x, want.x)
        assert fr.unroll == want.unroll
        np.testing.assert_array_equal(fr.target, want.target)


def test_reference_synthesizes_the_port_store_from_its_caches(shared):
    """The reference finds every fit in the port's cache (the keys agree)
    and gives the port's δ̄ to 1e-12."""
    ref = shared["ref"]
    assert ref["port_store_stats"]["n_refit_terminals"] == 0
    assert ref["port_store_stats"]["n_solver_calls"] == 0
    for n, d in shared["port_deltas"].items():
        assert abs(ref["port_store_deltas"][n] - d) <= DELTA_ATOL, n


def test_reference_written_store_opens_in_the_port(shared):
    root = shared["root"]
    port_view = CorpusStore(root / "ref_store")
    assert json.loads(json.dumps(_state(port_view))) == \
        shared["ref"]["ref_store_state"]
    # the same scenario set written by either package is the same store
    assert _state(port_view) == _state(shared["port_store"])


def test_port_synthesizes_the_reference_store_from_its_caches(shared,
                                                               tmp_path):
    shutil.copytree(shared["root"] / "ref_store", tmp_path / "s")
    corp = synthesize_corpus(store=CorpusStore(tmp_path / "s"),
                             device="cpu")
    assert corp.stats["n_refit_terminals"] == 0
    assert corp.stats["n_solver_calls"] == 0
    assert corp.stats["n_grammar_cache_misses"] == 0
    for n, d in _deltas(corp).items():
        assert abs(shared["ref"]["ref_store_deltas"][n] - d) <= DELTA_ATOL, n


def test_content_addresses_agree_across_packages(shared):
    from repro.core.trace_ir import TraceStore as RefTraceStore
    root = shared["root"]
    for n in shared["zoo"]:
        path = root / "npz" / f"{n}.npz"
        assert TraceStore.load(path).content_hash() == \
            RefTraceStore.load(path).content_hash()
    rng = np.random.RandomState(0)
    for _ in range(4):
        ids = rng.randint(0, 9, size=rng.randint(1, 40))
        for thr in (0.5, 0.25):
            assert GrammarCache.key(ids, thr) == ref_cs.GrammarCache.key(
                ids, thr)


# ---------------------------------------------------------------------------
# faults: the chaos sweep, and the pinned torn-manifest schedule
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.clear_plan()
    ref_faults.clear_plan()


def test_fault_points_and_kinds_are_the_references():
    assert faults.FAULT_POINTS == ref_faults.FAULT_POINTS
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS


@pytest.mark.parametrize("point", list(faults.FAULT_POINTS))
def test_chaos_sweep_point_recovers_like_the_reference(point, tmp_path):
    """The most damaging kind at this point: after reopen, verify and
    repair the store is clean and equal, at cluster level, to a
    from-scratch store of the survivors (hard-asserted inside); crashed,
    repaired and the survivor count equal the reference's sweep."""
    kind = chaos.smoke_kind(point)
    assert kind == ref_chaos._smoke_kind(point)
    got = chaos.one_case(point, kind, chaos.tiny_zoo(), tmp_path / "port")
    want = ref_chaos._one_case(point, kind, deep=False)
    for k in ("crashed", "repaired", "n_survivors"):
        assert got[k] == want[k], k


def test_chaos_coverage_slow_lock_and_worker_death(tmp_path):
    zoo = chaos.tiny_zoo()
    cov = chaos.coverage_row(zoo, tmp_path)
    assert cov["n_consulted"] == cov["n_points"] == len(faults.FAULT_POINTS)
    assert chaos.slow_lock_row(zoo, tmp_path)["n_contended_attempts"] == 3
    death = chaos.worker_death_row(zoo, 2, tmp_path)
    assert death["n_pool_breaks"] >= 1 and death["n_serial_retries"] >= 1


def _schedule(pkg, root, seed, ops):
    """tests/test_faults_prop.py::_check_schedule's drive, for one package:
    a seeded plan of three faults over an add/remove sequence, each crash
    followed by a reopen and repair.  Returns what was raised."""
    f = __import__(f"{pkg}.core.faults", fromlist=["x"])
    csm = __import__(f"{pkg}.core.corpus_store", fromlist=["x"])
    ev = __import__(f"{pkg}.core.events", fromlist=["x"])
    ti = __import__(f"{pkg}.core.trace_ir", fromlist=["x"])

    def scenario(i):
        comm = ev.CommEvent("psum", (8,), "float32", ("x",))
        tr = []
        for v in (_VECS[i % 4], _VECS[(i + 1) % 4]):
            tr += [ev.ComputeEvent(tuple(float(x) + i for x in v)), comm]
        return ti.TraceStore.from_rank_traces([list(tr) for _ in range(4)],
                                              {"x": 4})

    def reopen():
        while True:
            try:
                cs = csm.CorpusStore(root)
                if not cs.verify().clean:
                    cs.repair()
                return cs
            except (f.InjectedCrash, OSError):
                continue

    plan = f.FaultPlan.random(seed, n_faults=3, kinds=(
        "crash_before", "crash_after", "torn_write", "io_error"))
    try:
        with f.active_plan(plan):
            cs = reopen()
            for op, i in ops:
                try:
                    if op == "add" and f"s{i}" not in cs:
                        cs.add_scenario(f"s{i}", scenario(i))
                    elif op == "remove" and f"s{i}" in cs:
                        cs.remove_scenario(f"s{i}")
                except (f.InjectedCrash, OSError, csm.IngestBatchError):
                    cs = reopen()
    except ValueError as e:
        return "ValueError", str(e).replace(str(root), "<root>")
    return "survived", sorted(cs.names)


def test_pinned_torn_manifest_schedule_raises_as_the_reference(tmp_path):
    """seed=5134, ops=[add s0, add s0]: a torn write of manifest.json lands
    before its store.meta.json twin exists, and reopening raises the same
    ValueError in both packages (a reference-side problem the port copies:
    ROADMAP §3)."""
    ops = [("add", 0), ("add", 0)]
    want = _schedule("repro", tmp_path / "ref" / "corpus", 5134, ops)
    got = _schedule("repro_torch", tmp_path / "port" / "corpus", 5134, ops)
    assert got == want
    assert got[0] == "ValueError"
    assert "no store.meta.json recovery twin" in got[1]

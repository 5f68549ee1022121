"""Chaos sweep of the corpus store: a fault at every registered touchpoint,
then recovery and survivor-set parity, each hard-asserted.

Port of the reference's ``benchmarks/chaos.py --smoke`` (its rows 1, 2 at
cluster level, 3 and 4), as a library the tests and ``chip_smoke.py``
call; ``repro_torch`` imports nothing from ``repro``.

* :func:`coverage_row`: a full store lifecycle under an empty
  :class:`~repro_torch.core.faults.FaultPlan` consults every point of
  :data:`~repro_torch.core.faults.FAULT_POINTS`.
* :func:`point_row`: seed a two-scenario store, install
  ``FaultPlan.crash_at(point, kind)``, drive the lifecycle until the fault
  fires, then do what a restarted appender does: reopen, ``verify()``,
  ``repair()`` if dirty.  The repaired store must be clean and equal to a
  from-scratch store over the survivors: names, content hashes, cluster
  assignments and representatives.
* :func:`slow_lock_row`: bounded lock contention retries through and
  commits; an unbounded hold raises
  :class:`~repro_torch.core.corpus_store.LockTimeoutError`.
* :func:`worker_death_row`: a pool worker that dies (``os._exit``) breaks
  the pool; the serial retry still commits every scenario, equal to a
  serial ingest.

:func:`smoke` sweeps every point with its most damaging kind
(``torn_write`` where the point supports it, else ``crash_before``).  The
zoo is three named scenarios ``a``, ``b``, ``c`` (:func:`tiny_zoo` unless
the caller passes its own).  Pure NumPy and file I/O: nothing runs on a
device.
"""
from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.core import faults
from repro_torch.core.corpus_store import (
    CorpusStore, IngestBatchError, LockTimeoutError, ScenarioCorruptError,
    _file_lock,
)

_V = [(2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.),
      (4.4e6, 1.2e4, 2.2e6, 0., 7.0, 1.0),
      (9.9e8, 5.5e5, 3.3e7, 1.1e3, 0., 2.0)]


def tiny_zoo() -> dict:
    """The reference sweep's three 4-rank scenarios."""
    from repro_torch.core.events import CommEvent, ComputeEvent
    from repro_torch.core.trace_ir import TraceStore

    def mk(vs):
        comm = CommEvent("psum", (8,), "float32", ("x",))
        tr = []
        for v in vs:
            tr += [ComputeEvent(tuple(v)), comm]
        return TraceStore.from_rank_traces([list(tr) for _ in range(4)],
                                           {"x": 4})

    return {"a": mk([_V[0], _V[1]]), "b": mk([_V[0], _V[2]]),
            "c": mk([_V[1], _V[2]])}


def _fake_fit():
    from types import SimpleNamespace
    return SimpleNamespace(x=np.arange(11), predicted=np.zeros(6),
                           target=np.zeros(6), residual=0.0,
                           per_metric_rel_err=np.zeros(6), unroll=1)


@contextlib.contextmanager
def _workdir(base):
    if base is None:
        with tempfile.TemporaryDirectory() as td:
            yield Path(td)
    else:
        Path(base).mkdir(parents=True, exist_ok=True)
        yield Path(tempfile.mkdtemp(dir=base))


def _seed(root: Path, zoo: dict) -> CorpusStore:
    """A healthy two-scenario store, committed before any plan installs."""
    cs = CorpusStore(root)
    cs.add_scenario("a", zoo["a"])
    cs.add_scenario("b", zoo["b"])
    return cs


def lifecycle(root: Path, zoo: dict) -> None:
    """One pass over every registered fault point: open (shard + index
    reads), ingest (lock, worker front half, scenario/sidecar/shard/index
    writes), cache saves (fit/grammar/manifest writes), an evicted
    scenario reload, and an index rebuild from sidecars."""
    cs = CorpusStore(root)                         # read.shard, read.index
    cs.add_scenario("c", zoo["c"])                 # lock + worker + writes
    cs.save_fits(table_fingerprint="chaos")        # write.manifest
    cs.fits.put("k", _fake_fit())
    cs.save_fits()                                 # write.fit_cache
    cs.grammars.put("k", {0: [("t", 1, 2)]})
    cs.save_grammars()                             # write.grammar_cache
    cs._stores.clear()
    cs.load_scenario("a")                          # read.scenario_npz
    (root / "cluster_index.npz").unlink(missing_ok=True)
    CorpusStore(root)                              # read.sidecar rebuild


def recover(root: Path) -> tuple[CorpusStore, bool]:
    """The restarted appender's protocol: reopen from disk, fsck, repair
    if dirty, and hard-assert the result is clean."""
    cs = CorpusStore(root)
    repaired = not cs.verify().clean
    if repaired:
        cs.repair()
    rep = cs.verify()
    assert rep.clean, rep.summary()
    return cs, repaired


def assert_survivor_parity(cs: CorpusStore, zoo: dict,
                           fresh_root: Path) -> int:
    """The repaired store must equal a from-scratch store over the same
    surviving set: names, hashes, cluster assignments, representatives."""
    fresh = CorpusStore(fresh_root)
    for n in cs.names:
        fresh.add_scenario(n, zoo[n])
    assert fresh.names == cs.names, (fresh.names, cs.names)
    for n in cs.names:
        assert fresh.content_hash(n) == cs.content_hash(n), n
    ids_a, reps_a = cs.cluster_assignments()
    ids_b, reps_b = fresh.cluster_assignments()
    for n in cs.names:
        np.testing.assert_array_equal(ids_a[n], ids_b[n])
    assert set(reps_a) == set(reps_b)
    for cid in reps_a:
        np.testing.assert_array_equal(reps_a[cid], reps_b[cid])
    return len(cs.names)


def one_case(point: str, kind: str, zoo: dict, base=None) -> dict:
    """Seed → inject one fault → crash → recover → parity."""
    with _workdir(base) as td:
        root = td / "corpus"
        _seed(root, zoo)
        plan = faults.FaultPlan.crash_at(point, kind)
        crashed = False
        with faults.active_plan(plan):
            try:
                lifecycle(root, zoo)
            except (faults.InjectedCrash, OSError, IngestBatchError,
                    ScenarioCorruptError):
                # ScenarioCorruptError is the typed wrapper an injected
                # read EIO surfaces as: still a crash outcome here
                crashed = True
        assert plan.fired, f"fault {kind} at {point} never fired"
        t0 = time.perf_counter()
        cs, repaired = recover(root)
        t_recover = time.perf_counter() - t0
        n_survivors = assert_survivor_parity(cs, zoo, td / "fresh")
        return {"kind": kind, "crashed": crashed, "repaired": repaired,
                "n_survivors": n_survivors, "survivors": cs.names,
                "recover_ms": t_recover * 1e3}


def point_row(point: str, kinds, zoo: dict, base=None) -> dict:
    cases = [one_case(point, k, zoo, base) for k in kinds]
    return {
        "program": f"chaos_{point}",
        "kinds": [c["kind"] for c in cases],
        "crashed": [c["crashed"] for c in cases],
        "repaired": [c["repaired"] for c in cases],
        "survivors": [c["survivors"] for c in cases],
        "recover_ms_max": max(c["recover_ms"] for c in cases),
        "survivor_parity": True,            # hard-asserted per case
    }


def coverage_row(zoo: dict, base=None) -> dict:
    """Every registered point must be consulted by the lifecycle: an
    empty plan records hits without firing anything."""
    with _workdir(base) as td:
        root = td / "corpus"
        _seed(root, zoo)
        plan = faults.FaultPlan([])
        with faults.active_plan(plan):
            lifecycle(root, zoo)
        hit = {p for p, _ in plan.hits}
        missing = set(faults.registered_points()) - hit
        assert not missing, f"points never consulted: {sorted(missing)}"
        assert not plan.fired
        return {"program": "chaos_coverage",
                "n_points": len(faults.registered_points()),
                "n_consulted": len(hit & set(faults.registered_points()))}


def slow_lock_row(zoo: dict, base=None) -> dict:
    with _workdir(base) as td:
        root = td / "corpus"
        # bounded contention: three failed attempts, then the lock wins
        # and the ingest commits
        plan = faults.FaultPlan([faults.FaultSpec("lock.acquire",
                                                  "slow_lock", count=3)])
        t0 = time.perf_counter()
        with faults.active_plan(plan):
            cs = CorpusStore(root)
            cs.add_scenario("a", zoo["a"])
        t_through = time.perf_counter() - t0
        assert cs.names == ["a"]
        n_retries = len(plan.fired)
        # unbounded hold: the timeout diagnostic, not a hang
        plan = faults.FaultPlan([faults.FaultSpec("lock.acquire",
                                                  "slow_lock",
                                                  count=10_000)])
        diagnosed = False
        with faults.active_plan(plan):
            try:
                with _file_lock(td / "x.lock", timeout=0.05):
                    pass
            except LockTimeoutError as e:
                diagnosed = e.attempts > 1
        assert diagnosed
        return {"program": "chaos_slow_lock",
                "n_contended_attempts": n_retries,
                "retried_through_ms": t_through * 1e3}


def worker_death_row(zoo: dict, n_workers: int = 2, base=None) -> dict:
    """One forked ingest worker dies on scenario ``b``: the pool breaks,
    the serial retry commits everything, equal to a serial ingest."""
    with _workdir(base) as td:
        items = sorted(zoo.items())
        plan = faults.FaultPlan([faults.FaultSpec("worker.ingest",
                                                  "worker_death",
                                                  match="b")])
        t0 = time.perf_counter()
        with faults.active_plan(plan):
            cs = CorpusStore(td / "corpus")
            cs.add_scenarios(items, n_workers=n_workers)
        t_ingest = time.perf_counter() - t0
        ser = CorpusStore(td / "serial")
        ser.add_scenarios(items, n_workers=0)
        assert cs.names == ser.names
        for n in cs.names:
            assert cs.content_hash(n) == ser.content_hash(n), n
        assert cs.stats["n_pool_breaks"] >= 1, cs.stats
        return {"program": "chaos_worker_death",
                "n_workers": n_workers,
                "n_pool_breaks": cs.stats["n_pool_breaks"],
                "n_serial_retries": cs.stats["n_serial_retries"],
                "ingest_ms": t_ingest * 1e3}


def smoke_kind(point: str) -> str:
    """The most damaging kind each point supports: a torn on-disk write
    where possible, else a pre-op crash."""
    return ("torn_write" if "torn_write" in faults.FAULT_POINTS[point]
            else "crash_before")


def smoke(zoo: dict | None = None, n_workers: int = 2, base=None,
          ) -> list[dict]:
    """Every registered point with its most damaging kind, recovery and
    cluster-level survivor parity hard-asserted; then the slow-lock and
    worker-death rows.  Returns the rows."""
    zoo = tiny_zoo() if zoo is None else zoo
    rows = [coverage_row(zoo, base)]
    for point in faults.registered_points():
        rows.append(point_row(point, [smoke_kind(point)], zoo, base))
    rows.append(slow_lock_row(zoo, base))
    rows.append(worker_death_row(zoo, n_workers, base))
    return rows

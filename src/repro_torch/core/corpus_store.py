"""Streaming corpus store: sharded directory-of-npz + incremental joint
clustering with per-scenario partial sums.

Port copy of :mod:`repro.core.corpus_store`; ``repro_torch`` imports nothing from
``repro``.

ROADMAP's "fleet-scale corpus" item: the scenario zoo grows continuously
and from several appender processes at once, so the trace corpus must be
an on-disk artifact whose appends are **commutative** — not a single
serial manifest re-clustered from scratch per added workload.  A
:class:`CorpusStore` is a directory::

    corpus/
      manifest.json              # header: version, rel_tol, n_shards, ...
      shards/shard-NN.json       # scenario entries, keyed by content hash
      scenarios/<name>.npz       # one TraceStore artifact per scenario
      scenarios/<name>.buckets.npz   # its pass-1 bucket table (sidecar)
      cluster_index.npz          # merged index cache (rebuildable)
      fit_cache.npz              # content-addressed block-combination fits
      grammar_cache.json         # content-addressed Sequitur rules
      locks/*.lock               # per-shard flock files

**Sharded manifests.**  Scenario entries live in per-shard manifests —
the shard is picked by content hash — and every shard write is a
file-locked read-modify-write followed by an atomic rename, so two
appender processes never corrupt a shard and never lose each other's
entries.  *Manifest order* is canonical: shards in index order, entries
within a shard sorted by ``(content_hash, name)``.  The store's state is
therefore a pure function of its scenario **set** — append order,
appender count, and worker scheduling all wash out, which is what makes
parallel ingest bit-identical to serial ingest by construction.

**Joint clustering with per-scenario partial sums.**  The corpus-level
clustering (see :func:`repro_torch.core.events.combine_bucket_tables`) keeps
one pass-1 bucket table *per scenario*: distinct quantization keys,
float64 partial sums accumulated in the scenario's own event order, and
per-row bucket ids.  Deriving the joint clusters renumbers buckets by
first appearance in manifest order and folds the partial sums
left-to-right in that order — O(total distinct keys), never re-touching
event data.  Consequences:

* **append** is exactly incremental (a new scenario's partials fold in
  at its manifest position);
* **removal** is O(remaining events): drop the scenario's table,
  renumber, refold — no metrics reload, no full rebuild
  (:meth:`CorpusStore.remove_scenario`);
* the same fold implements the batch path
  (:func:`repro_torch.core.events.cluster_corpus`), so incremental and
  from-scratch synthesis stay bit-identical by construction.

This replaced the v1 event-order global accumulation — a deliberate,
documented invariant change (float association differs at scenario
boundaries, at most one ulp per fold).  v1 stores migrate on first open:
the manifest is resharded and the index npz (now versioned) rebuilds
once from the scenario artifacts.

The load-bearing invariant (pinned by tests and the CI incremental job):
``synthesize_corpus(store=...)`` after any sequence of appends/removals
yields per-scenario δ̄ **bit-identical** to a from-scratch
``synthesize_corpus`` over the same scenarios in manifest order.

:meth:`CorpusStore.add_scenarios` fans the per-scenario ingest front
half (npz write, hashing, bucket table, noise calibration, grammar
warm-up — pure NumPy, no device work) across a worker pool; workers
make no CUDA call (the pool forks, possibly after the parent has
initialised the card), and the parent merges their bucket tables
deterministically in manifest order.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core import faults
from repro_torch.core.events import (
    N_METRICS, combine_bucket_tables, quantize_metrics,
    scenario_bucket_table,
)
from repro_torch.core.trace_ir import TraceStore

try:                         # POSIX advisory locks; absent on some platforms
    import fcntl
except ImportError:          # pragma: no cover - non-POSIX fallback
    fcntl = None

_MANIFEST_VERSION = 2
_INDEX_VERSION = 2
_N_SHARDS_DEFAULT = 16
_MANIFEST = "manifest.json"
_INDEX = "cluster_index.npz"
_FITS = "fit_cache.npz"
_GRAMMARS = "grammar_cache.json"
_SCENARIO_DIR = "scenarios"
_SHARD_DIR = "shards"
_LOCK_DIR = "locks"
_QUARANTINE_DIR = "quarantine"
_META = "store.meta.json"

#: how long a shard/header lock acquisition retries (with exponential
#: backoff) before raising :class:`LockTimeoutError`
LOCK_TIMEOUT = 30.0


class ToleranceMismatchError(ValueError):
    """A persisted clustering artifact disagrees with the store's
    ``rel_tol``.  Raised loudly instead of silently re-clustering: a
    readable index built at a different tolerance means mixed store
    directories or hand-edited artifacts, not bit rot."""


class IndexFormatError(ValueError):
    """Unversioned/old-version index artifact — the store rebuilds it
    once (the v1 → v2 migration path)."""


class ScenarioCorruptError(RuntimeError):
    """A scenario artifact (``scenarios/<name>.npz`` or its bucket
    sidecar, where the metrics fallback is also unreadable) failed to
    load.  Typed so callers — and :meth:`CorpusStore.repair` — can
    identify the culprit instead of unwinding on a raw
    ``zipfile``/``OSError`` from deep inside iteration or synthesis."""

    def __init__(self, name: str, path, cause: BaseException):
        self.name = name
        self.path = str(path)
        self.cause = cause
        super().__init__(
            f"scenario {name!r} artifact {path} is unreadable "
            f"({type(cause).__name__}: {cause}); run "
            "CorpusStore.verify()/repair() to quarantine it")


class ShardCorruptError(RuntimeError):
    """A shard manifest file is unparseable (torn write / bit rot).  The
    store opens with the shard recorded in :attr:`CorpusStore.
    shard_errors` — synthesis and serving refuse to run until
    :meth:`CorpusStore.repair` reconstructs the shard's entries from the
    surviving scenario artifacts."""

    def __init__(self, path, cause: BaseException):
        self.path = str(path)
        self.cause = cause
        super().__init__(
            f"shard manifest {path} is unreadable "
            f"({type(cause).__name__}: {cause}); run "
            "CorpusStore.repair() to reconstruct it from the scenario "
            "artifacts")


class LockTimeoutError(TimeoutError):
    """Could not acquire a store lock inside the bounded retry window.
    Carries the lock path and attempt count so the diagnostic names the
    stuck writer's lock file instead of hanging forever."""

    def __init__(self, path, timeout: float, attempts: int):
        self.path = str(path)
        self.timeout = timeout
        self.attempts = attempts
        super().__init__(
            f"could not acquire corpus lock {path} within {timeout:.1f}s "
            f"({attempts} attempts with backoff) — another writer is "
            "stuck or died while holding it; if no writer process is "
            "alive the flock is already released and this indicates "
            "pathological contention")


@dataclasses.dataclass
class IngestItemError:
    """One scenario's typed ingest failure (after the serial retry)."""

    name: str
    error: BaseException
    retried: bool = False

    def __str__(self) -> str:
        return (f"{self.name}: {type(self.error).__name__}: {self.error}"
                + (" (after serial retry)" if self.retried else ""))


class IngestBatchError(RuntimeError):
    """Some items of an :meth:`CorpusStore.add_scenarios` batch failed —
    **after** the survivors committed.  Per-item fault isolation: a dead
    worker or one corrupt input costs that item, never the batch.
    ``hashes`` holds the committed scenarios, ``errors`` the typed
    per-item failures."""

    def __init__(self, errors: list[IngestItemError], hashes: dict):
        self.errors = list(errors)
        self.hashes = dict(hashes)
        names = [e.name for e in self.errors]
        super().__init__(
            f"{len(self.errors)} of {len(self.errors) + len(self.hashes)} "
            f"scenarios failed ingest: {names} "
            f"({len(self.hashes)} committed); see .errors for causes")


# ---------------------------------------------------------------------------
# crash-safe writes + cross-process locking
# ---------------------------------------------------------------------------


def _finish_atomic(tmp: str, path: Path, spec, site: str) -> None:
    """Shared tail of every atomic-write site: implement a ``torn_write``
    fault (the non-atomic clobber the renamer exists to prevent — injected
    anyway so fsck is exercised against real damage), commit the rename,
    then a ``crash_after`` fault."""
    if spec is not None and spec.kind == "torn_write":
        data = Path(tmp).read_bytes()
        os.unlink(tmp)
        faults.apply_torn_write(path, data, site, str(path))
    os.replace(tmp, path)
    if spec is not None and spec.kind == "crash_after":
        raise faults.InjectedCrash(site, f"after commit of {path}")


def _atomic_npz_write(path: Path, writer, site: str = "write.index") -> None:
    """Write-then-rename so a crash (or SIGKILL) mid-write never
    truncates the live file.  The tmp name is unique per writer
    (``mkstemp``), so two processes racing on the same target each
    rename a complete file — last one wins, both are valid.  ``site``
    names the registered fault point (:mod:`repro_torch.core.faults`) this
    write arms — inert unless a plan is installed."""
    path = Path(path)
    spec = faults.arm(site, path)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        _finish_atomic(tmp, path, spec, site)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _atomic_json_write(path: Path, obj, sort_keys: bool = True,
                       site: str = "write.manifest") -> None:
    """JSON twin of :func:`_atomic_npz_write` — same contract: readers
    (and reopeners after a kill) observe either the old or the new
    manifest, never a truncated one.  ``sort_keys=False`` for payloads
    whose dict order is semantic (the grammar cache)."""
    path = Path(path)
    spec = faults.arm(site, path)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1, sort_keys=sort_keys)
            f.flush()
            os.fsync(f.fileno())
        _finish_atomic(tmp, path, spec, site)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _atomic_scenario_write(path: Path, tstore: TraceStore) -> Path:
    """Atomic form of ``TraceStore.save`` for the corpus's scenario npz
    files: a killed ingest must never leave a truncated scenario behind
    a committed shard entry (the sidecar-before-entry ordering covers
    the entry; this covers the artifact itself)."""
    path = Path(path)
    spec = faults.arm("write.scenario_npz", path)
    # suffix keeps .npz so TraceStore.save doesn't append another one
    fd, tmp = tempfile.mkstemp(dir=str(path.parent),
                               prefix=path.name + ".", suffix=".tmp.npz")
    os.close(fd)
    try:
        tstore.save(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        _finish_atomic(tmp, path, spec, "write.scenario_npz")
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    return path


def _acquire_flock(f, path: Path, timeout: float) -> None:
    """Bounded lock acquisition: non-blocking attempts with exponential
    backoff instead of an unbounded ``LOCK_EX`` wait, so a writer that
    died (or hung) holding a lock surfaces as a
    :class:`LockTimeoutError` diagnostic, never an eternal hang."""
    deadline = time.monotonic() + timeout
    delay = 1e-3
    attempts = 0
    while True:
        attempts += 1
        spec = faults.arm("lock.acquire", path)
        try:
            if spec is not None and spec.kind == "slow_lock":
                raise BlockingIOError(
                    f"injected lock contention on {path}")
            fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except BlockingIOError:
            if time.monotonic() >= deadline:
                raise LockTimeoutError(path, timeout, attempts) from None
            time.sleep(delay)
            delay = min(delay * 2, 0.05)


@contextlib.contextmanager
def _file_lock(path: Path, timeout: float = LOCK_TIMEOUT):
    """Exclusive advisory lock serializing cross-process read-modify-
    write of one shard manifest (or the header), acquired with bounded
    retry + backoff (:func:`_acquire_flock`).  Degrades to no locking
    where ``fcntl`` is unavailable — single-appender only there."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a+") as f:
        if fcntl is not None:
            _acquire_flock(f, path, timeout)
        try:
            yield
        finally:
            if fcntl is not None:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)


# ---------------------------------------------------------------------------
# per-scenario bucket tables + the incremental joint-clustering index
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioBuckets:
    """One scenario's pass-1 bucket table (the partial-sums unit the
    corpus clustering folds): distinct quantization keys in
    first-appearance order, per-key float64 sums accumulated in the
    scenario's own event order, row counts, and per-row local ids.

    Pure per-scenario data — computable in an ingest worker with no view
    of the rest of the corpus, persisted as a ``.buckets.npz`` sidecar so
    concurrent appenders never contend on a shared index file."""

    rel_tol: float
    keys: np.ndarray          # (k, 6) int64 quantization keys
    psums: np.ndarray         # (k, 6) float64 in-scenario partial sums
    counts: np.ndarray        # (k,) int64
    local_ids: np.ndarray     # (n_rows,) int64 → rows of ``keys``

    @classmethod
    def from_metrics(cls, metrics: np.ndarray, rel_tol: float,
                     ) -> "ScenarioBuckets":
        keys, psums, counts, local_ids = scenario_bucket_table(
            np.asarray(metrics, dtype=np.float64), rel_tol)
        return cls(rel_tol=rel_tol, keys=keys, psums=psums, counts=counts,
                   local_ids=local_ids)

    @property
    def n_rows(self) -> int:
        return int(self.local_ids.shape[0])

    def astuple(self) -> tuple:
        return (self.keys, self.psums, self.counts, self.local_ids)

    def save(self, path) -> None:
        meta = json.dumps({"version": _INDEX_VERSION,
                           "rel_tol": self.rel_tol})

        def write(f):
            np.savez(f, keys=self.keys, psums=self.psums,
                     counts=self.counts, local_ids=self.local_ids,
                     meta=np.asarray(meta))

        _atomic_npz_write(Path(path), write, site="write.sidecar")

    @classmethod
    def load(cls, path, expected_rel_tol: float | None = None,
             ) -> "ScenarioBuckets":
        faults.crash_point("read.sidecar", path)
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("version") != _INDEX_VERSION:
                raise IndexFormatError(
                    f"bucket sidecar {path} has version "
                    f"{meta.get('version')!r}, expected {_INDEX_VERSION}")
            rel_tol = float(meta["rel_tol"])
            if expected_rel_tol is not None and rel_tol != expected_rel_tol:
                raise ToleranceMismatchError(
                    f"bucket sidecar {path} was clustered at rel_tol="
                    f"{rel_tol}, the store expects {expected_rel_tol}; "
                    "refusing to silently re-cluster under a mismatched "
                    "tolerance")
            return cls(rel_tol=rel_tol,
                       keys=z["keys"].astype(np.int64),
                       psums=z["psums"].astype(np.float64),
                       counts=z["counts"].astype(np.int64),
                       local_ids=z["local_ids"].astype(np.int64))


#: one (6,) int64 quantization key as fixed-width bytes.  Distinct
#: equal-length byte strings stay distinct under the S-dtype trailing-null
#: stripping (same length → same stripped form ⇔ same raw bytes), so
#: sorting/searching this view is equality-exact.
_KEY_DTYPE = f"S{8 * N_METRICS}"


@dataclasses.dataclass(frozen=True)
class ClusterMatcher:
    """Immutable snapshot of the derived cluster-lookup state — the serve
    tier's hot-path matcher.

    Exact-key matching runs as one vectorized ``searchsorted`` over a
    sorted fixed-width byte view of the quantization keys (replacing the
    per-row ``dict.get`` loop, kept as
    :meth:`ClusterIndex.match_clusters_reference` — the parity oracle);
    unseen keys fall back to the nearest representative under the
    relative-max metric, unchanged.  Being frozen, a service can capture
    one and keep matching consistently while the owning index mutates
    underneath it."""

    rel_tol: float
    skeys: np.ndarray         # (k,) sorted quantization-key bytes
    scids: np.ndarray         # (k,) int64 cluster id per sorted key
    rep_ids: np.ndarray       # (c,) int64 cluster ids
    rep_mat: np.ndarray       # (c, 6) float64 representatives

    def match(self, metrics: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        metrics = np.asarray(metrics, dtype=np.float64)
        if metrics.ndim != 2 or metrics.shape[1] != N_METRICS:
            raise ValueError(f"expected (n, {N_METRICS}) metrics array")
        n = metrics.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
        if not len(self.skeys):
            raise ValueError("cannot match against an empty cluster index")
        q = np.ascontiguousarray(quantize_metrics(metrics, self.rel_tol))
        qs = q.view(_KEY_DTYPE).ravel()
        pos = np.minimum(np.searchsorted(self.skeys, qs),
                         len(self.skeys) - 1)
        matched = self.skeys[pos] == qs
        cids = np.zeros(n, dtype=np.int64)
        cids[matched] = self.scids[pos[matched]]
        if not matched.all():
            v = metrics[~matched][:, None, :]
            denom = np.maximum(
                np.maximum(np.abs(self.rep_mat[None]), np.abs(v)), 1e-30)
            dist = (np.abs(self.rep_mat[None] - v) / denom).max(axis=2)
            cids[~matched] = self.rep_ids[np.argmin(dist, axis=1)]
        return cids, matched


@dataclasses.dataclass
class ClusterIndex:
    """Running corpus-clustering state: one :class:`ScenarioBuckets` per
    scenario plus the derivation order (= manifest order).

    Derivation (:meth:`derive`) renumbers buckets by first appearance in
    ``order`` and folds partial sums left-to-right in that order — see
    :func:`repro_torch.core.events.combine_bucket_tables`, the single shared
    implementation that keeps this index bit-identical to the batch
    path.  Mutations (:meth:`ingest`, :meth:`remove`, :meth:`set_order`)
    only touch per-scenario tables and invalidate the derived cache, so
    removal costs O(remaining events) at the next derive instead of a
    full rebuild from metrics."""

    rel_tol: float
    tables: dict[str, ScenarioBuckets]
    order: list[str]

    def __post_init__(self):
        self._derived: dict | None = None

    @classmethod
    def empty(cls, rel_tol: float = 0.05) -> "ClusterIndex":
        return cls(rel_tol=rel_tol, tables={}, order=[])

    @property
    def n_buckets(self) -> int:
        return int(self._derive_full()["n_buckets"])

    @property
    def n_clusters(self) -> int:
        return len(self.derive()[1])

    # -- mutation --------------------------------------------------------------

    def ingest(self, name: str, metrics: np.ndarray) -> None:
        """Append one scenario's compute metrics as a fresh bucket table
        (partial sums accumulated in the scenario's own event order)."""
        self.ingest_table(name,
                          ScenarioBuckets.from_metrics(metrics, self.rel_tol))

    def ingest_table(self, name: str, sb: ScenarioBuckets) -> None:
        """Merge a pre-computed bucket table (the parallel-ingest path:
        workers build tables, the parent folds them in manifest order)."""
        if name in self.tables:
            raise ValueError(f"scenario {name!r} already in cluster index")
        if sb.rel_tol != self.rel_tol:
            raise ToleranceMismatchError(
                f"bucket table for {name!r} was clustered at rel_tol="
                f"{sb.rel_tol}, index expects {self.rel_tol}")
        self.tables[name] = sb
        self.order.append(name)
        self._derived = None

    def remove(self, name: str) -> None:
        """Drop one scenario — O(1) now, O(remaining events) at the next
        :meth:`derive` (renumber + refold the surviving partial sums)."""
        if name not in self.tables:
            raise KeyError(f"scenario {name!r} not in cluster index")
        del self.tables[name]
        self.order.remove(name)
        self._derived = None

    def set_order(self, order: Sequence[str]) -> None:
        """Pin the derivation order (the store's canonical manifest
        order).  Must be a permutation of the ingested scenarios."""
        order = list(order)
        if set(order) != set(self.tables) or len(order) != len(self.tables):
            raise ValueError(
                f"order {order!r} is not a permutation of the indexed "
                f"scenarios {sorted(self.tables)!r}")
        if order != self.order:
            self.order = order
            self._derived = None

    @classmethod
    def rebuild(cls, rel_tol: float,
                scenario_metrics: Sequence[tuple[str, np.ndarray]],
                expected_rel_tol: float | None = None) -> "ClusterIndex":
        """Fresh index over the given scenarios in order — the from-
        scratch semantics, used for self-healing and as the timing
        baseline the partial-sums removal is measured against.

        ``expected_rel_tol`` guards miswired callers: rebuilding under a
        tolerance different from the store's raises instead of silently
        re-clustering."""
        if expected_rel_tol is not None and rel_tol != expected_rel_tol:
            raise ToleranceMismatchError(
                f"asked to rebuild the cluster index at rel_tol={rel_tol} "
                f"but the store expects {expected_rel_tol}; refusing to "
                "silently re-cluster under a mismatched tolerance")
        idx = cls.empty(rel_tol)
        for name, metrics in scenario_metrics:
            idx.ingest(name, metrics)
        return idx

    # -- derivation ------------------------------------------------------------

    def _derive_full(self) -> dict:
        if self._derived is None:
            ids_list, reps, state = combine_bucket_tables(
                [self.tables[n].astuple() for n in self.order],
                self.rel_tol, return_state=True)
            state["ids"] = dict(zip(self.order, ids_list))
            self._derived = state
        return self._derived

    def derive(self) -> tuple[dict[str, np.ndarray], dict[int, np.ndarray]]:
        """(per-scenario cluster ids, cluster representatives) — the
        joint clustering folded in ``order``.  Cached until the next
        mutation."""
        d = self._derive_full()
        return d["ids"], d["reps"]

    def assignments(self, name: str) -> np.ndarray:
        """Cluster id per compute row of one scenario (aligned with its
        ``TraceStore.metrics``)."""
        return self._derive_full()["ids"][name]

    def matcher(self) -> ClusterMatcher:
        """Frozen :class:`ClusterMatcher` snapshot of the derived lookup
        state (sorted key view + representatives).  Cached alongside the
        derived state, so it rebuilds only after mutations; serving
        callers capture it once per sync and stay immune to concurrent
        index mutation mid-match."""
        d = self._derive_full()
        m = d.get("matcher")
        if m is None:
            by_key, remap = d["by_key"], d["remap"]
            if by_key:
                # insertion position == global bucket id, so the joined
                # key bytes line up with ``remap`` by construction
                flat = np.frombuffer(b"".join(by_key), dtype=_KEY_DTYPE)
                order = np.argsort(flat, kind="stable")
                skeys = flat[order]
                scids = np.asarray(remap, dtype=np.int64)[order]
            else:
                skeys = np.zeros(0, dtype=_KEY_DTYPE)
                scids = np.zeros(0, dtype=np.int64)
            reps = d["reps"]
            rep_ids = np.fromiter(reps.keys(), dtype=np.int64,
                                  count=len(reps))
            rep_mat = (np.stack([reps[int(c)] for c in rep_ids])
                       if len(reps) else np.zeros((0, N_METRICS)))
            m = ClusterMatcher(rel_tol=self.rel_tol, skeys=skeys,
                               scids=scids, rep_ids=rep_ids, rep_mat=rep_mat)
            d["matcher"] = m
        return m

    def match_clusters(self, metrics: np.ndarray,
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Map arbitrary metric rows onto the derived corpus clusters
        *without* re-clustering: exact quantization-key lookup with a
        nearest-representative fallback for unseen keys.  Pure NumPy —
        the serve tier's hot path, vectorized via the sorted key view in
        :class:`ClusterMatcher` (bit-identical to the per-row loop kept
        as :meth:`match_clusters_reference`).  Returns ``(cluster_ids,
        matched)`` where ``matched[i]`` is False for fallback rows."""
        return self.matcher().match(metrics)

    def match_clusters_reference(self, metrics: np.ndarray,
                                 ) -> tuple[np.ndarray, np.ndarray]:
        """The per-row dict-lookup matcher the vectorized path replaced —
        preserved verbatim as the parity oracle (repo oracle discipline):
        tests pin ``match_clusters`` bit-identical to this on zoo + fuzz
        streams."""
        metrics = np.asarray(metrics, dtype=np.float64)
        if metrics.ndim != 2 or metrics.shape[1] != N_METRICS:
            raise ValueError(f"expected (n, {N_METRICS}) metrics array")
        d = self._derive_full()
        n = metrics.shape[0]
        cids = np.zeros(n, dtype=np.int64)
        matched = np.zeros(n, dtype=bool)
        if n == 0:
            return cids, matched
        if d["n_buckets"] == 0:
            raise ValueError("cannot match against an empty cluster index")
        by_key, remap = d["by_key"], d["remap"]
        q = np.ascontiguousarray(quantize_metrics(metrics, self.rel_tol))
        for i in range(n):
            gid = by_key.get(q[i].tobytes())
            if gid is not None:
                cids[i] = remap[gid]
                matched[i] = True
        if not matched.all():
            reps = d["reps"]
            rep_ids = np.fromiter(reps.keys(), dtype=np.int64,
                                  count=len(reps))
            rep_mat = np.stack([reps[int(c)] for c in rep_ids])
            v = metrics[~matched][:, None, :]
            denom = np.maximum(
                np.maximum(np.abs(rep_mat[None]), np.abs(v)), 1e-30)
            dist = (np.abs(rep_mat[None] - v) / denom).max(axis=2)
            cids[~matched] = rep_ids[np.argmin(dist, axis=1)]
        return cids, matched

    # -- persistence -----------------------------------------------------------

    def save(self, path, order: Sequence[str] | None = None) -> None:
        """Persist as a versioned npz (atomically: tmp + rename) — the
        merged cache of the per-scenario sidecars; always rebuildable."""
        names = list(self.order if order is None else order)
        if set(names) != set(self.tables):
            raise ValueError("save order must cover exactly the indexed "
                             "scenarios")
        tabs = [self.tables[n] for n in names]
        kext = np.cumsum([0] + [len(t.keys) for t in tabs])
        rext = np.cumsum([0] + [t.n_rows for t in tabs])
        cat = {
            "keys": (np.concatenate([t.keys for t in tabs]) if tabs
                     else np.zeros((0, N_METRICS), dtype=np.int64)),
            "psums": (np.concatenate([t.psums for t in tabs]) if tabs
                      else np.zeros((0, N_METRICS), dtype=np.float64)),
            "counts": (np.concatenate([t.counts for t in tabs]) if tabs
                       else np.zeros(0, dtype=np.int64)),
            "local_ids": (np.concatenate([t.local_ids for t in tabs]) if tabs
                          else np.zeros(0, dtype=np.int64)),
        }
        meta = json.dumps({"version": _INDEX_VERSION, "rel_tol": self.rel_tol,
                           "order": names})

        def write(f):
            np.savez(f, key_extents=kext, row_extents=rext,
                     meta=np.asarray(meta), **cat)

        _atomic_npz_write(Path(path), write, site="write.index")

    @classmethod
    def load(cls, path, expected_rel_tol: float | None = None,
             ) -> "ClusterIndex":
        """Load a persisted index.  Raises :class:`IndexFormatError` for
        pre-v2 artifacts (callers rebuild once — the migration path) and
        :class:`ToleranceMismatchError` when the artifact's ``rel_tol``
        disagrees with ``expected_rel_tol`` (loud, never a silent
        re-cluster)."""
        faults.crash_point("read.index", path)
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("version") != _INDEX_VERSION:
                raise IndexFormatError(
                    f"cluster index {path} has version "
                    f"{meta.get('version')!r}, expected {_INDEX_VERSION} "
                    "(pre-v2 stores rebuild once on open)")
            rel_tol = float(meta["rel_tol"])
            if expected_rel_tol is not None and rel_tol != expected_rel_tol:
                raise ToleranceMismatchError(
                    f"cluster index {path} was clustered at rel_tol="
                    f"{rel_tol}, the store expects {expected_rel_tol}; "
                    "refusing to silently re-cluster under a mismatched "
                    "tolerance")
            order = list(meta["order"])
            kext = z["key_extents"].astype(np.int64)
            rext = z["row_extents"].astype(np.int64)
            keys = z["keys"].astype(np.int64)
            psums = z["psums"].astype(np.float64)
            counts = z["counts"].astype(np.int64)
            ids = z["local_ids"].astype(np.int64)
            tables = {
                n: ScenarioBuckets(
                    rel_tol=rel_tol,
                    keys=keys[kext[i]:kext[i + 1]],
                    psums=psums[kext[i]:kext[i + 1]],
                    counts=counts[kext[i]:kext[i + 1]],
                    local_ids=ids[rext[i]:rext[i + 1]])
                for i, n in enumerate(order)
            }
            return cls(rel_tol=rel_tol, tables=tables, order=order)


# ---------------------------------------------------------------------------
# content-addressed fit cache
# ---------------------------------------------------------------------------


class FitCache:
    """Persistent ``key -> FitResult`` map for block-combination fits.

    Keys are content hashes of the exact fit inputs (target vector bytes,
    count_scale, calibration-basis fingerprint, solver grid — built by
    ``repro_torch.core.synthesize``), so a cached fit is valid wherever its key
    matches regardless of which table union or scenario produced it; the
    corpus terminal-table fingerprint is recorded in the manifest for
    observability and coarse invalidation."""

    def __init__(self):
        self._fits: dict = {}

    def __len__(self):
        return len(self._fits)

    def __contains__(self, key: str) -> bool:
        return key in self._fits

    def get(self, key: str):
        return self._fits.get(key)

    def put(self, key: str, fr) -> None:
        self._fits[key] = fr

    def save(self, path) -> None:
        keys = list(self._fits)
        if not keys:
            Path(path).unlink(missing_ok=True)
            return
        frs = [self._fits[k] for k in keys]

        def write(f):
            np.savez(
                f,
                keys=np.asarray(keys),
                x=np.stack([np.asarray(fr.x, dtype=np.int64) for fr in frs]),
                predicted=np.stack([fr.predicted for fr in frs]),
                target=np.stack([fr.target for fr in frs]),
                residual=np.asarray([fr.residual for fr in frs]),
                rel_err=np.stack([fr.per_metric_rel_err for fr in frs]),
                unroll=np.asarray([fr.unroll for fr in frs], dtype=np.int64))

        _atomic_npz_write(Path(path), write, site="write.fit_cache")

    @classmethod
    def load(cls, path) -> "FitCache":
        # lazy: proxy_search pulls in torch, and the ingest worker pool
        # (which imports this module) never touches the fit cache
        from repro_torch.core.proxy_search import FitResult
        cache = cls()
        with np.load(path) as z:
            for i, k in enumerate(z["keys"].tolist()):
                cache._fits[str(k)] = FitResult(
                    x=z["x"][i].astype(np.int64),
                    predicted=z["predicted"][i].astype(np.float64),
                    target=z["target"][i].astype(np.float64),
                    residual=float(z["residual"][i]),
                    per_metric_rel_err=z["rel_err"][i].astype(np.float64),
                    unroll=int(z["unroll"][i]))
        return cache


# ---------------------------------------------------------------------------
# content-addressed grammar cache
# ---------------------------------------------------------------------------


class GrammarCache:
    """Persistent ``key -> frozen Sequitur rules`` map for rank-stream
    grammars, sibling to :class:`FitCache`.

    Keys are content hashes of the exact grammar-inference inputs: the
    interned local-id stream bytes plus the merge threshold (conservative
    — today's Sequitur rules depend only on the stream; keying on the
    threshold too keeps the cache valid if grammar semantics ever pick up
    threshold dependence).  A hit hands back the frozen
    ``{rid: [(kind, ref, exp), ...]}`` rules dict and skips the Sequitur
    run entirely — on a warm store, re-opened in a fresh process, every
    unchanged rank stream resolves from this cache, so grammar inference
    on incremental appends costs only the new scenario's novel streams.

    The parallel-ingest workers warm this cache speculatively: each runs
    the scenario-local front half and returns its rules, so later joint
    synthesis hits whenever the joint cluster partition restricted to the
    scenario equals the local one (the common case; a miss just re-runs
    Sequitur — the cache is content-addressed, never a correctness risk).

    Rules are pure int/str structures, so unlike the in-memory front-half
    memo they persist (``grammar_cache.json``); rule dicts alias across
    hits and are read-only downstream (the same convention as grammar
    aliasing across a signature class).  ``hits``/``misses`` count
    :meth:`get` outcomes since construction; synthesis stats report the
    per-run delta.
    """

    def __init__(self):
        self._rules: dict[str, dict[int, list[tuple]]] = {}
        self.hits = 0
        self.misses = 0
        self.dirty = False

    def __len__(self):
        return len(self._rules)

    def __contains__(self, key: str) -> bool:
        return key in self._rules

    @staticmethod
    def key(local_ids: np.ndarray, threshold: float) -> str:
        h = hashlib.sha256(f"grammar|1|{threshold!r}|".encode())
        h.update(np.ascontiguousarray(local_ids, dtype=np.int64).tobytes())
        return h.hexdigest()

    def get(self, key: str) -> dict[int, list[tuple]] | None:
        rules = self._rules.get(key)
        if rules is None:
            self.misses += 1
        else:
            self.hits += 1
        return rules

    def put(self, key: str, rules: dict[int, list[tuple]]) -> None:
        self._rules[key] = rules
        self.dirty = True

    def merge(self, rules_by_key: dict[str, dict[int, list[tuple]]]) -> int:
        """Fold another cache's rule entries in (the parallel-ingest
        merge); existing keys win.  Returns the number added."""
        added = 0
        for k, rules in rules_by_key.items():
            if k not in self._rules:
                self.put(k, rules)
                added += 1
        return added

    def save(self, path) -> None:
        path = Path(path)
        if not self._rules:
            path.unlink(missing_ok=True)
            self.dirty = False
            return
        # rid insertion order is part of the grammar identity (to_json
        # serializes rules in that order); JSON objects round-trip dict
        # order, so the frozen form persists it exactly
        payload = {"version": 1,
                   "entries": {k: {str(rid): [list(s) for s in body]
                                   for rid, body in rules.items()}
                               for k, rules in self._rules.items()}}
        # sort_keys=False: rid order is semantic (see comment above)
        _atomic_json_write(path, payload, sort_keys=False,
                           site="write.grammar_cache")
        self.dirty = False

    @classmethod
    def load(cls, path) -> "GrammarCache":
        cache = cls()
        payload = json.loads(Path(path).read_text())
        if payload.get("version") != 1:
            raise ValueError(f"unsupported grammar cache version "
                             f"{payload.get('version')!r} in {path}")
        for k, rules in payload["entries"].items():
            cache._rules[k] = {
                int(rid): [(s[0], int(s[1]), int(s[2])) for s in body]
                for rid, body in rules.items()}
        return cache


# ---------------------------------------------------------------------------
# the ingest front half (worker-pool safe: pure NumPy, no CUDA calls)
# ---------------------------------------------------------------------------


def _entry_sort_key(entry: dict) -> tuple[str, str]:
    return (entry["content_hash"], entry["name"])


def _ingest_front_half(root, name: str, src, rel_tol: float,
                       threshold: float = 0.5, warm_grammars: bool = False,
                       ) -> tuple[str, dict, ScenarioBuckets, dict]:
    """The per-scenario half of ingest with no view of the corpus: write
    the scenario npz + bucket sidecar, hash, calibrate noise, and
    (optionally) warm the grammar cache with the scenario-local front
    half.  Pure NumPy throughout — this is the function
    :meth:`CorpusStore.add_scenarios` fans across the worker pool, so it
    must make no CUDA call: a forked child of a process that has
    initialised the card cannot use it.  (``noise`` imports torch, but
    :func:`~repro_torch.core.noise.calibrate` computes in NumPy.)

    ``src`` is a :class:`TraceStore` or a path to one (paths are the
    fleet-scale case: workers load their own inputs, nothing large rides
    the pipe).  Returns ``(name, manifest_entry, buckets, grammar_rules)``
    for the parent to merge under the shard locks."""
    root = Path(root)
    faults.crash_point("worker.ingest", name)
    store = src if isinstance(src, TraceStore) else TraceStore.load(src)
    path = _atomic_scenario_write(root / _SCENARIO_DIR / f"{name}.npz", store)
    chash = store.content_hash()
    sb = ScenarioBuckets.from_metrics(store.metrics, rel_tol)
    sb.save(root / _SCENARIO_DIR / f"{name}.buckets.npz")
    from repro_torch.core import noise as noise_mod   # lazy: numpy at run time
    entry = {
        "name": name,
        "file": f"{_SCENARIO_DIR}/{name}.npz",
        "content_hash": chash,
        "n_ranks": store.n_ranks,
        "n_events": store.n_events,
        "n_compute_events": store.n_compute_events,
        # scenario-LOCAL noise calibration (this scenario's own
        # clustering at the store's rel_tol): an observability artifact
        # riding the manifest.  Synthesis recalibrates against the JOINT
        # cluster assignment so batch and incremental paths emit
        # identical NOISE_MODELS tables.
        "noise": noise_mod.calibrate(store, rel_tol=rel_tol).to_json(),
    }
    rules: dict = {}
    if warm_grammars:
        from repro_torch.core.trace_ir import compress_store   # numpy-only
        gc = GrammarCache()
        compress_store(store, rel_tol, threshold, grammar_cache=gc)
        rules = gc._rules
    return name, entry, sb, rules


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class CorpusStore:
    """Sharded on-disk trace corpus with incremental joint clustering.

    ::

        cs = CorpusStore("corpus/")            # opens or creates
        cs.add_scenario("transformer-dp", store)
        cs.add_scenarios(items, n_workers=4)   # parallel batch ingest
        corp = synthesize_corpus(store=cs)     # incremental synthesis

    Scenario order is **canonical**, not ingestion order: shards in index
    order, entries within a shard sorted by ``(content_hash, name)``.
    The clustering and the δ̄-parity invariant are defined relative to
    that order, which is a pure function of the scenario set — so any mix
    of appenders, worker counts, and append interleavings converges to
    the same bit-identical store state.
    """

    def __init__(self, root, rel_tol: float | None = None,
                 n_shards: int | None = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / _SCENARIO_DIR).mkdir(exist_ok=True)
        (self.root / _SHARD_DIR).mkdir(exist_ok=True)
        self._stores: dict[str, TraceStore] = {}
        #: in-memory front-half memo used by incremental synthesis
        #: (grammar objects are not persistable; the on-disk caches are
        #: the cluster index and the fit/grammar caches)
        self.memo: dict = {}
        #: serializes this handle's mutators against in-process serving
        #: refreshes (cross-process safety stays with the shard flocks)
        self.lock = threading.RLock()
        self._subscribers: list = []
        #: scenarios whose artifacts failed to load at open (corrupt npz
        #: with no healthy sidecar): excluded from the cluster index,
        #: poison synthesis until :meth:`repair` quarantines them
        self.damaged: dict[str, ScenarioCorruptError] = {}
        #: shard manifests that failed to parse at open: entries absent
        #: from this handle's view until :meth:`repair` reconstructs them
        self.shard_errors: dict[int, ShardCorruptError] = {}
        #: operational counters (pool breaks, serial retries, ...)
        self.stats: dict[str, int] = {"n_pool_breaks": 0,
                                      "n_serial_retries": 0,
                                      "n_ingest_errors": 0}

        mpath = self.root / _MANIFEST
        if mpath.exists():
            manifest = self._read_header(mpath)
            version = manifest.get("version")
            if version not in (1, _MANIFEST_VERSION):
                raise ValueError(
                    f"unsupported corpus manifest version {version!r} "
                    f"in {mpath}")
            if rel_tol is not None and rel_tol != manifest["rel_tol"]:
                raise ValueError(
                    f"corpus at {self.root} was built with rel_tol="
                    f"{manifest['rel_tol']}, asked to open with {rel_tol}")
            if version == 1:
                self._migrate_v1(manifest)
            else:
                if n_shards is not None and n_shards != manifest["n_shards"]:
                    raise ValueError(
                        f"corpus at {self.root} has {manifest['n_shards']} "
                        f"shards, asked to open with {n_shards}")
                self.manifest = manifest
                self._shards = [self._read_shard_safe(i)
                                for i in range(self.n_shards)]
        else:
            self.manifest = {"version": _MANIFEST_VERSION,
                             "rel_tol": 0.05 if rel_tol is None else rel_tol,
                             "n_shards": n_shards or _N_SHARDS_DEFAULT,
                             "table_fingerprint": None}
            self._shards = [[] for _ in range(self.n_shards)]
            self._write_manifest()
        self._write_meta()

        seen: set[str] = set()
        for e in self._iter_entries():
            if e["name"] in seen:
                raise ValueError(
                    f"corpus at {self.root} lists scenario "
                    f"{e['name']!r} in more than one shard (two appenders "
                    "raced on the same name with different content)")
            seen.add(e["name"])

        self.index = self._load_or_rebuild_index()
        fpath = self.root / _FITS
        try:
            self.fits = FitCache.load(fpath) if fpath.exists() else FitCache()
        except Exception:
            # fits are content-addressed pure derivations: a corrupt cache
            # costs a re-solve, never correctness — start empty
            self.fits = FitCache()
        gpath = self.root / _GRAMMARS
        try:
            self.grammars = (GrammarCache.load(gpath) if gpath.exists()
                             else GrammarCache())
        except Exception:
            # same contract as the fit cache: a corrupt grammar cache
            # costs a Sequitur re-run, never correctness
            self.grammars = GrammarCache()

    # -- open-time migration / healing -----------------------------------------

    def _read_header(self, mpath: Path) -> dict:
        """Read the manifest header, recovering a torn one from the
        immutable ``store.meta.json`` twin (written at creation; holds
        only the never-changing fields, so recovery loses at most the
        ``table_fingerprint`` observability field)."""
        try:
            return json.loads(mpath.read_text())
        except ValueError as e:
            meta_path = self.root / _META
            if not meta_path.exists():
                raise ValueError(
                    f"corpus manifest {mpath} is unreadable "
                    f"({type(e).__name__}: {e}) and no {_META} recovery "
                    "twin exists (pre-robustness store?)") from e
            recovered = json.loads(meta_path.read_text())
            manifest = {"version": recovered["version"],
                        "rel_tol": recovered["rel_tol"],
                        "n_shards": recovered["n_shards"],
                        "table_fingerprint": None}
            _atomic_json_write(mpath, manifest)   # heal in place
            return manifest

    def _write_meta(self) -> None:
        """Persist (once) the immutable header twin used by
        :meth:`_read_header` to recover from a torn ``manifest.json``.
        Pre-existing stores heal it on first open.  Plain write, no
        fault point: it is write-once and recovery-only."""
        meta_path = self.root / _META
        if not meta_path.exists():
            tmp = meta_path.with_suffix(".tmp")
            tmp.write_text(json.dumps(
                {"version": _MANIFEST_VERSION, "rel_tol": self.rel_tol,
                 "n_shards": self.n_shards}, sort_keys=True))
            os.replace(tmp, meta_path)

    def _migrate_v1(self, manifest: dict) -> None:
        """One-time v1 → v2 migration: reshard the flat scenario list and
        adopt the canonical order.  The v1 index npz fails the version
        check downstream and rebuilds once (writing the sidecars), as
        documented — v1's event-order accumulation is superseded by the
        partial-sums semantics, so derived reps may move by an ulp."""
        entries = manifest.get("scenarios", [])
        self.manifest = {"version": _MANIFEST_VERSION,
                         "rel_tol": manifest["rel_tol"],
                         "n_shards": _N_SHARDS_DEFAULT,
                         "table_fingerprint":
                             manifest.get("table_fingerprint")}
        self._shards = [[] for _ in range(self.n_shards)]
        for e in entries:
            self._shards[self._shard_of(e["content_hash"])].append(e)
        for i, shard in enumerate(self._shards):
            shard.sort(key=_entry_sort_key)
            if shard:
                _atomic_json_write(self._shard_path(i),
                                   {"version": _MANIFEST_VERSION,
                                    "entries": shard},
                                   site="write.shard")
        self._write_manifest()

    def _load_or_rebuild_index(self) -> ClusterIndex:
        """Load the merged cluster-index cache, validating it against the
        manifest (the source of truth).  A missing, corrupt, stale, or
        pre-v2 index refreshes from the per-scenario bucket sidecars
        (falling back to a metrics column load where a sidecar is also
        gone), so the store self-heals instead of silently serving
        assignments inconsistent with its contents.  A *tolerance
        mismatch* is not healed: it raises
        :class:`ToleranceMismatchError` loudly.

        A scenario whose sidecar *and* npz are both unreadable cannot be
        healed: it is recorded in :attr:`damaged` and excluded from the
        index (synthesis refuses to run until :meth:`repair` quarantines
        it) — a double fault must not brick ``open``."""
        ipath = self.root / _INDEX
        names = self.names
        idx: ClusterIndex | None = None
        if ipath.exists():
            try:
                idx = ClusterIndex.load(ipath, expected_rel_tol=self.rel_tol)
            except ToleranceMismatchError:
                raise
            except Exception:
                idx = None            # corrupt or pre-v2: rebuild below
        if idx is not None and set(idx.tables) == set(names):
            idx.set_order(names)
            return idx
        tables: dict[str, ScenarioBuckets] = (
            {} if idx is None
            else {n: idx.tables[n] for n in names if n in idx.tables})
        for n in names:
            if n in tables:
                continue
            sb = self._sidecar_or_rebuild(n)
            if sb is not None:
                tables[n] = sb
        healthy = [n for n in names if n in tables]
        idx = ClusterIndex(rel_tol=self.rel_tol, tables=tables,
                           order=healthy)
        if healthy and not self.damaged:
            idx.save(ipath)
        return idx

    def _sidecar_or_rebuild(self, n: str) -> ScenarioBuckets | None:
        """One scenario's bucket table: load the sidecar, else rebuild it
        from the scenario's metrics (healing the sidecar on disk).  When
        the npz is also unreadable, record the scenario in
        :attr:`damaged` and return ``None``."""
        spath = self._sidecar_path(n)
        sb: ScenarioBuckets | None = None
        if spath.exists():
            try:
                sb = ScenarioBuckets.load(spath,
                                          expected_rel_tol=self.rel_tol)
            except ToleranceMismatchError:
                raise
            except Exception:
                sb = None
        if sb is None:
            try:
                metrics = self._metrics_of(n)
            except ScenarioCorruptError as e:
                self.damaged[n] = e
                return None
            sb = ScenarioBuckets.from_metrics(metrics, self.rel_tol)
            sb.save(spath)            # heal the sidecar
        return sb

    # -- basic accessors -------------------------------------------------------

    @property
    def rel_tol(self) -> float:
        return float(self.manifest["rel_tol"])

    @property
    def n_shards(self) -> int:
        return int(self.manifest["n_shards"])

    def _iter_entries(self) -> Iterator[dict]:
        for shard in self._shards:
            yield from shard

    @property
    def names(self) -> list[str]:
        """Scenario names in canonical manifest order (shard-major,
        content-hash sorted within a shard)."""
        return [e["name"] for e in self._iter_entries()]

    def __len__(self) -> int:
        return sum(len(s) for s in self._shards)

    def __contains__(self, name: str) -> bool:
        return any(e["name"] == name for e in self._iter_entries())

    def __iter__(self) -> Iterator[tuple[str, TraceStore]]:
        for name in self.names:
            yield name, self.load_scenario(name)

    def _entry(self, name: str) -> dict:
        for e in self._iter_entries():
            if e["name"] == name:
                return e
        raise KeyError(f"scenario {name!r} not in corpus")

    def content_hash(self, name: str) -> str:
        return self._entry(name)["content_hash"]

    def noise_params(self, name: str):
        """The scenario-local calibrated noise model recorded at
        ``add_scenario`` time, or ``None`` for entries written before the
        noise layer existed (pre-noise manifests stay loadable)."""
        data = self._entry(name).get("noise")
        if data is None:
            return None
        from repro_torch.core import noise as noise_mod
        return noise_mod.NoiseModel.from_json(data)

    def scenario_path(self, name: str) -> Path:
        return self.root / _SCENARIO_DIR / f"{name}.npz"

    def _sidecar_path(self, name: str) -> Path:
        return self.root / _SCENARIO_DIR / f"{name}.buckets.npz"

    # -- shard plumbing --------------------------------------------------------

    def _shard_of(self, content_hash: str) -> int:
        return int(content_hash[:8], 16) % self.n_shards

    def _shard_path(self, i: int) -> Path:
        return self.root / _SHARD_DIR / f"shard-{i:02d}.json"

    def _lock_path(self, stem: str) -> Path:
        return self.root / _LOCK_DIR / f"{stem}.lock"

    @staticmethod
    def _read_shard(path: Path) -> list[dict]:
        if not path.exists():
            return []
        faults.crash_point("read.shard", path)
        try:
            data = json.loads(path.read_text())
        except (OSError, ValueError) as e:
            # torn write / bit rot: typed so open can record it and
            # repair() can reconstruct the shard from scenario artifacts
            raise ShardCorruptError(path, e) from e
        if data.get("version") != _MANIFEST_VERSION:
            raise ValueError(f"unsupported shard manifest version "
                             f"{data.get('version')!r} in {path}")
        return sorted(data["entries"], key=_entry_sort_key)

    def _read_shard_safe(self, i: int) -> list[dict]:
        """Open-time shard read that records (instead of raising) a
        :class:`ShardCorruptError` in :attr:`shard_errors`, so a torn
        shard manifest leaves the store openable — and repairable —
        rather than bricked."""
        try:
            return self._read_shard(self._shard_path(i))
        except ShardCorruptError as e:
            self.shard_errors[i] = e
            return []

    def _append_entry(self, entry: dict) -> None:
        """Commit one scenario entry to its shard: flock the shard,
        re-read it from disk (picking up concurrent appenders), insert in
        canonical position, atomic-rename the new shard file."""
        i = self._shard_of(entry["content_hash"])
        with _file_lock(self._lock_path(f"shard-{i:02d}")):
            cur = self._read_shard(self._shard_path(i))
            if any(e["name"] == entry["name"] for e in cur):
                raise ValueError(
                    f"scenario {entry['name']!r} already in corpus")
            cur.append(entry)
            cur.sort(key=_entry_sort_key)
            _atomic_json_write(self._shard_path(i),
                               {"version": _MANIFEST_VERSION, "entries": cur},
                               site="write.shard")
        self._shards[i] = cur

    def _remove_entry(self, entry: dict) -> None:
        i = self._shard_of(entry["content_hash"])
        with _file_lock(self._lock_path(f"shard-{i:02d}")):
            cur = [e for e in self._read_shard(self._shard_path(i))
                   if e["name"] != entry["name"]]
            _atomic_json_write(self._shard_path(i),
                               {"version": _MANIFEST_VERSION, "entries": cur},
                               site="write.shard")
        self._shards[i] = cur

    # -- mutation notifications ------------------------------------------------

    def subscribe(self, fn) -> None:
        """Register ``fn(event, names)`` to run after every mutation this
        handle commits (``event`` is ``"add"`` or ``"remove"``; ``names``
        a tuple of affected scenarios).  Callbacks fire after
        ``_finish_mutation`` under :attr:`lock`; they must be cheap and
        must not mutate the store (serving subscribers just flip a stale
        bit and refresh lazily)."""
        self._subscribers.append(fn)

    def unsubscribe(self, fn) -> None:
        """Drop a subscriber registered with :meth:`subscribe` (no-op if
        absent)."""
        with contextlib.suppress(ValueError):
            self._subscribers.remove(fn)

    def _notify(self, event: str, names) -> None:
        for fn in list(self._subscribers):
            fn(event, tuple(names))

    def manifest_fingerprint(self) -> str:
        """sha256 over this handle's canonical ``(name, content_hash)``
        entry list — the cheap drift probe serving caches compare against
        (a mutation through this handle always changes it)."""
        h = hashlib.sha256()
        for e in self._iter_entries():
            h.update(e["name"].encode())
            h.update(b"\x00")
            h.update(e["content_hash"].encode())
            h.update(b"\x00")
        return h.hexdigest()

    # -- mutation --------------------------------------------------------------

    @staticmethod
    def _validate_name(name: str) -> None:
        if "/" in name or name in (".", ".."):
            raise ValueError(f"invalid scenario name {name!r}")

    def add_scenario(self, name: str, store: TraceStore) -> str:
        """Append one scenario: write its npz + bucket sidecar, commit
        the shard entry under the shard lock, fold its bucket table into
        the cluster index.  Returns the content hash."""
        with self.lock:
            self._validate_name(name)
            if name in self:
                raise ValueError(f"scenario {name!r} already in corpus")
            _, entry, sb, _ = _ingest_front_half(self.root, name, store,
                                                 self.rel_tol)
            self._append_entry(entry)
            self.index.ingest_table(name, sb)
            self._stores[name] = store
            self._finish_mutation()
            self._notify("add", [name])
            return entry["content_hash"]

    def add_scenarios(self, items, n_workers: int = 0,
                      threshold: float = 0.5, warm_grammars: bool = True,
                      ) -> dict[str, str]:
        """Batch ingest; ``n_workers > 0`` fans the per-scenario front
        half (:func:`_ingest_front_half`: npz write, hashing, bucket
        table, noise calibration, grammar warm-up — all pure NumPy)
        across a process pool, then merges the returned bucket tables
        deterministically in canonical manifest order, so the final state
        is bit-identical to ``n_workers=0`` serial ingest.

        ``items`` is a sequence of ``(name, TraceStore | path)`` pairs —
        paths are the fleet-scale form (each worker loads its own input).
        ``warm_grammars`` runs the scenario-local Sequitur front half in
        the worker and folds the rules into the persistent grammar cache,
        so the first joint synthesis after ingest skips Sequitur for
        every stream whose joint partition matches the local one.
        Returns ``{name: content_hash}``."""
        with self.lock:
            return self._add_scenarios_locked(items, n_workers, threshold,
                                              warm_grammars)

    def _pool_front_half(self, items, n_workers, threshold, warm_grammars,
                         results: dict, errors: dict) -> None:
        """Fan :func:`_ingest_front_half` across a process pool with
        per-future fault isolation: one worker dying (a real
        ``BrokenProcessPool`` — e.g. OOM-killed) or one corrupt input
        fails only its own items, never the batch.  Failed items land in
        ``errors`` for the caller's serial retry."""
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool
        method = ("fork" if "fork" in mp.get_all_start_methods()
                  else "spawn")
        ctx = mp.get_context(method)
        pool_broke = False
        with ProcessPoolExecutor(
                max_workers=min(n_workers, len(items)),
                mp_context=ctx) as ex:
            futs = [(name, ex.submit(_ingest_front_half, str(self.root),
                                     name,
                                     src if isinstance(src, TraceStore)
                                     else str(src),
                                     self.rel_tol, threshold, warm_grammars))
                    for name, src in items]
            for name, fut in futs:
                try:
                    results[name] = fut.result()
                except BrokenProcessPool as e:
                    # the pool is dead: every unfinished future fails
                    # with this — count the break once, queue the items
                    # for the serial retry
                    if not pool_broke:
                        pool_broke = True
                        self.stats["n_pool_breaks"] += 1
                    errors[name] = e
                except (Exception, faults.InjectedCrash) as e:
                    # InjectedCrash here came over the pipe from a
                    # *child* — a worker crash, not this process's
                    errors[name] = e

    def _add_scenarios_locked(self, items, n_workers, threshold,
                              warm_grammars) -> dict[str, str]:
        items = [(name, src) for name, src in items]
        for name, _ in items:
            self._validate_name(name)
            if name in self:
                raise ValueError(f"scenario {name!r} already in corpus")
        if len({n for n, _ in items}) != len(items):
            raise ValueError("duplicate scenario names in batch")

        results: dict[str, tuple] = {}
        errors: dict[str, BaseException] = {}
        if n_workers and len(items) > 1:
            self._pool_front_half(items, n_workers, threshold, warm_grammars,
                                  results, errors)
        else:
            # serial path: Exception costs the item (retried below);
            # InjectedCrash propagates — it simulates THIS process dying
            for name, src in items:
                try:
                    results[name] = _ingest_front_half(
                        self.root, name, src, self.rel_tol, threshold,
                        warm_grammars)
                except Exception as e:
                    errors[name] = e

        # one serial retry per failed item (transient faults — a dead
        # worker, flaky EIO — clear; deterministic ones fail again and
        # are reported as typed per-item errors)
        item_errors: list[IngestItemError] = []
        by_name = dict(items)
        for name in list(errors):
            self.stats["n_serial_retries"] += 1
            try:
                results[name] = _ingest_front_half(
                    self.root, name, by_name[name], self.rel_tol, threshold,
                    warm_grammars)
                del errors[name]
            except Exception as e:
                item_errors.append(IngestItemError(name, e, retried=True))

        # commit the survivors (canonical order washes out which failed)
        hashes: dict[str, str] = {}
        for name, src in items:
            r = results.get(name)
            if r is None:
                continue
            _, entry, sb, rules = r
            self._append_entry(entry)
            self.index.ingest_table(name, sb)
            self.grammars.merge(rules)
            hashes[name] = entry["content_hash"]
            if isinstance(src, TraceStore):
                self._stores[name] = src
        self._finish_mutation()
        self.save_grammars()
        if hashes:
            self._notify("add", list(hashes))
        if item_errors:
            self.stats["n_ingest_errors"] += len(item_errors)
            # after commit: per-item fault isolation means the failures
            # cost their items, never the batch
            raise IngestBatchError(item_errors, hashes)
        return hashes

    def remove_scenario(self, name: str) -> None:
        """Drop a scenario in O(remaining events): delete its shard
        entry, npz, and bucket sidecar, and drop its partial-sum table
        from the cluster index — the survivors' buckets renumber and
        their partials refold (in manifest order) at the next derive.  No
        metrics reload, no full rebuild; post-removal clustering is
        bit-identical to a from-scratch index over the survivors."""
        with self.lock:
            entry = self._entry(name)
            self._remove_entry(entry)
            self._stores.pop(name, None)
            self.scenario_path(name).unlink(missing_ok=True)
            self._sidecar_path(name).unlink(missing_ok=True)
            self.index.remove(name)
            self._finish_mutation()
            self._notify("remove", [name])

    def _metrics_of(self, name: str) -> np.ndarray:
        cached = self._stores.get(name)
        if cached is not None:
            return cached.metrics
        path = self.root / self._entry(name)["file"]
        try:
            # fault point inside the try: an injected EIO is typed like a
            # real one (InjectedCrash is a BaseException and still escapes)
            faults.crash_point("read.scenario_npz", path)
            cols = TraceStore.load_columns(path, ["metrics"])
        except Exception as e:
            raise ScenarioCorruptError(name, path, e) from e
        return cols["metrics"]

    def load_scenario(self, name: str) -> TraceStore:
        st = self._stores.get(name)
        if st is None:
            path = self.root / self._entry(name)["file"]
            try:
                faults.crash_point("read.scenario_npz", path)
                st = TraceStore.load(path)
            except Exception as e:
                # typed: a truncated npz must name its scenario, not
                # unwind as a raw zipfile/OSError mid-synthesis
                raise ScenarioCorruptError(name, path, e) from e
            self._stores[name] = st
        return st

    # -- clustering view -------------------------------------------------------

    def cluster_assignments(self) -> tuple[dict[str, np.ndarray],
                                           dict[int, np.ndarray]]:
        """Per-scenario cluster ids (aligned to each scenario's metrics
        rows) + the joint cluster representatives — bit-identical to
        :func:`repro_torch.core.events.cluster_corpus` over the manifest-order
        scenario metrics."""
        ids, reps = self.index.derive()
        return dict(ids), reps

    # -- persistence -----------------------------------------------------------

    def _write_manifest(self) -> None:
        _atomic_json_write(self.root / _MANIFEST, self.manifest)

    def _finish_mutation(self) -> None:
        """Sync the index with the manifest view and re-pin canonical
        order.  The locked shard re-read inside ``_append_entry`` makes
        concurrent appenders' commits visible to this handle, so fold in
        their sidecar tables (a scenario's sidecar is always written
        *before* its shard entry commits) and drop tables for scenarios
        removed elsewhere.  The merged index cache write is atomic but
        last-writer-wins across processes — harmless, because open-time
        validation refreshes any stale cache from the sidecars."""
        names = self.names
        current = set(names)
        for n in list(self.index.tables):
            if n not in current:
                self.index.remove(n)
        for n in names:
            if n in self.index.tables or n in self.damaged:
                continue
            sb = self._sidecar_or_rebuild(n)
            if sb is not None:
                self.index.ingest_table(n, sb)
        self.index.set_order([n for n in names
                              if n in self.index.tables])
        self.index.save(self.root / _INDEX)

    def save_fits(self, table_fingerprint: str | None = None) -> None:
        """Persist the fit cache (called by incremental synthesis after a
        solve) and record the corpus table version in the manifest header
        (under the header lock — concurrent synthesizers last-write-wins
        on this observability field, never on scenario entries)."""
        if table_fingerprint is not None:
            with _file_lock(self._lock_path("manifest")):
                mpath = self.root / _MANIFEST
                if mpath.exists():     # pick up concurrent header edits
                    on_disk = json.loads(mpath.read_text())
                    if on_disk.get("version") == _MANIFEST_VERSION:
                        self.manifest = on_disk
                self.manifest["table_fingerprint"] = table_fingerprint
                self._write_manifest()
        self.fits.save(self.root / _FITS)

    def save_grammars(self) -> None:
        """Persist the grammar cache if it gained entries (called by
        incremental synthesis after the front half)."""
        if self.grammars.dirty:
            self.grammars.save(self.root / _GRAMMARS)

    # -- integrity: fsck + quarantine ------------------------------------------

    def quarantine_dir(self) -> Path:
        """Where :meth:`repair` moves damaged scenario artifacts
        (created on first use)."""
        return self.root / _QUARANTINE_DIR

    def verify(self, deep: bool = True):
        """fsck: cross-check every shard entry against its scenario npz
        (existence, loadability, content-hash match), sidecar presence
        and coherence, index/manifest agreement, and cache readability.
        Returns a typed :class:`repro_torch.core.fsck.VerifyReport`; mutates
        nothing.  ``deep=False`` skips re-hashing the scenario npz
        payloads (existence/metadata checks only)."""
        from repro_torch.core.fsck import verify_store   # lazy: keeps ingest
        with self.lock:                            # workers import-light
            return verify_store(self, deep=deep)

    def repair(self):
        """Quarantine every damaged scenario (npz + sidecar moved to
        ``quarantine/`` with a JSON damage record), reconstruct corrupt
        shard manifests from the surviving scenario artifacts, and heal
        sidecars/index/caches — then re-derive.  Post-repair store state
        is bit-identical to a from-scratch store over the surviving
        scenario set (the chaos-sweep oracle).  Returns a
        :class:`repro_torch.core.fsck.RepairReport`."""
        from repro_torch.core.fsck import repair_store
        with self.lock:
            return repair_store(self)

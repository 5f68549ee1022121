"""Corpus-store integrity: ``verify`` (fsck) and ``repair`` (quarantine).

Port copy of :mod:`repro.core.fsck`; ``repro_torch`` imports nothing from
``repro``.

The store's crash-safety machinery (atomic renames, sidecar-before-entry
ordering, locked shard read-modify-write) makes *clean* crashes
recoverable by construction — reopening observes either the old or the
new state.  This module covers what that machinery cannot: torn
non-atomic overwrites, bit rot, and operator error, injected
deterministically by :mod:`repro_torch.core.faults` and swept by
``benchmarks/chaos.py``.

``verify_store`` is a read-only fsck.  It cross-checks every shard entry
against its scenario npz (existence, loadability, content-hash match,
metadata agreement), every bucket sidecar against a recomputation from
the scenario's metrics, the merged index cache and the fit/grammar
caches for readability, and surfaces open-time damage records
(:attr:`CorpusStore.damaged`, :attr:`CorpusStore.shard_errors`).  Each
problem is a typed :class:`Issue`; ``fatal`` issues name scenarios whose
*source data* is gone (quarantine is the only remedy), everything else
is healable in place because it is a pure derivation of the scenario
artifacts.

``repair_store`` makes the store consistent again:

1. corrupt shard manifests are **reconstructed** from the scenario
   artifacts (an entry is a pure function of ``name`` + ``TraceStore`` +
   ``rel_tol``, so reconstruction is bit-identical to the lost commit);
2. fatal scenarios are **quarantined** — npz + sidecar moved to
   ``quarantine/`` beside a JSON damage record, the shard entry removed
   under the shard lock, the cluster-index table dropped (the survivors
   refold via the existing O(buckets) removal path);
3. healable derivations (sidecars, merged index, caches) are rebuilt.

The oracle (pinned by tests and the chaos sweep): after ``repair``, the
store's per-scenario δ̄ is **bit-identical** to a from-scratch store over
the surviving scenario set.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from repro_torch.core.corpus_store import (
    _MANIFEST_VERSION, _SCENARIO_DIR, ScenarioBuckets, _atomic_json_write,
    _entry_sort_key, _file_lock,
)
from repro_torch.core.trace_ir import TraceStore

__all__ = ["Issue", "VerifyReport", "RepairReport", "verify_store",
           "repair_store"]


@dataclasses.dataclass(frozen=True)
class Issue:
    """One integrity finding.  ``fatal`` means the scenario's source
    data is unrecoverable (quarantine); non-fatal issues are pure
    derivations and heal in place."""

    kind: str                 # e.g. "scenario_corrupt", "sidecar_stale"
    path: str
    detail: str
    name: str | None = None   # implicated scenario, if any
    fatal: bool = False

    def __str__(self) -> str:
        sev = "FATAL" if self.fatal else "heal"
        who = f" [{self.name}]" if self.name else ""
        return f"{sev} {self.kind}{who}: {self.path} — {self.detail}"


@dataclasses.dataclass
class VerifyReport:
    """The fsck result: every issue found, plus coverage counters."""

    issues: list[Issue]
    n_scenarios: int          # entries visible in the manifest view
    deep: bool                # whether payloads were re-hashed

    @property
    def clean(self) -> bool:
        return not self.issues

    @property
    def fatal(self) -> list[Issue]:
        return [i for i in self.issues if i.fatal]

    @property
    def healable(self) -> list[Issue]:
        return [i for i in self.issues if not i.fatal]

    @property
    def fatal_names(self) -> list[str]:
        return sorted({i.name for i in self.fatal if i.name is not None})

    def summary(self) -> str:
        if self.clean:
            return (f"clean: {self.n_scenarios} scenarios verified "
                    f"({'deep' if self.deep else 'shallow'})")
        return (f"{len(self.fatal)} fatal / {len(self.healable)} healable "
                f"issues over {self.n_scenarios} scenarios:\n"
                + "\n".join(f"  {i}" for i in self.issues))


@dataclasses.dataclass
class RepairReport:
    """What :func:`repair_store` did."""

    quarantined: list[str]            # scenario names moved to quarantine/
    rebuilt_shards: list[int]         # shard indices reconstructed
    healed: list[Issue]               # non-fatal issues fixed in place
    pre: VerifyReport                 # the fsck that drove the repair

    def summary(self) -> str:
        return (f"quarantined {len(self.quarantined)} "
                f"({', '.join(self.quarantined) or 'none'}), rebuilt "
                f"{len(self.rebuilt_shards)} shard(s), healed "
                f"{len(self.healed)} issue(s)")


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------


def _check_entry(cs, entry: dict, deep: bool, issues: list[Issue]) -> None:
    """All per-scenario checks for one manifest entry."""
    name = entry["name"]
    npz = cs.root / entry["file"]
    if not npz.exists():
        issues.append(Issue("scenario_missing", str(npz),
                            "npz listed in manifest but absent on disk",
                            name=name, fatal=True))
        return
    if not deep:
        return
    try:
        store = TraceStore.load(npz)
    except Exception as e:
        issues.append(Issue("scenario_corrupt", str(npz),
                            f"{type(e).__name__}: {e}", name=name,
                            fatal=True))
        return
    chash = store.content_hash()
    if chash != entry["content_hash"]:
        issues.append(Issue(
            "hash_mismatch", str(npz),
            f"npz content hash {chash[:12]}… != manifest "
            f"{entry['content_hash'][:12]}…", name=name, fatal=True))
        return
    meta = {"n_ranks": store.n_ranks, "n_events": store.n_events,
            "n_compute_events": store.n_compute_events}
    stale = {k: (entry.get(k), v) for k, v in meta.items()
             if entry.get(k) != v}
    if stale:
        # hash matches, so the npz is authoritative: entry fields are a
        # pure derivation — healable
        issues.append(Issue("entry_stale", str(npz),
                            f"manifest fields disagree with npz: {stale}",
                            name=name))
    spath = cs._sidecar_path(name)
    expected = ScenarioBuckets.from_metrics(store.metrics, cs.rel_tol)
    if not spath.exists():
        issues.append(Issue("sidecar_missing", str(spath),
                            "bucket sidecar absent", name=name))
        return
    try:
        sb = cs.index.tables.get(name)
        on_disk = ScenarioBuckets.load(spath, expected_rel_tol=cs.rel_tol)
    except Exception as e:
        issues.append(Issue("sidecar_corrupt", str(spath),
                            f"{type(e).__name__}: {e}", name=name))
        return
    same = all(np.array_equal(a, b) for a, b in
               zip(on_disk.astuple(), expected.astuple()))
    if not same:
        issues.append(Issue(
            "sidecar_stale", str(spath),
            "sidecar partial sums differ from a recomputation off the "
            "scenario's metrics", name=name))
    elif sb is not None and not all(
            np.array_equal(a, b) for a, b in
            zip(sb.astuple(), expected.astuple())):
        issues.append(Issue(
            "index_stale", str(cs.root / "cluster_index.npz"),
            "in-memory index table differs from the scenario's metrics",
            name=name))


def verify_store(cs, deep: bool = True) -> VerifyReport:
    """Read-only fsck of a :class:`~repro_torch.core.corpus_store.CorpusStore`.

    Reads artifacts straight off disk (bypassing the handle's in-memory
    ``TraceStore`` cache), so damage that post-dates a cached load is
    still found."""
    issues: list[Issue] = []
    for i, err in sorted(cs.shard_errors.items()):
        issues.append(Issue("shard_corrupt", err.path,
                            f"unparseable at open: {err.cause}"))
    for name, err in sorted(cs.damaged.items()):
        issues.append(Issue("scenario_corrupt", err.path,
                            f"unreadable at open: {err.cause}", name=name,
                            fatal=True))
    entries = list(cs._iter_entries())
    seen_fatal = {i.name for i in issues if i.fatal}
    for entry in entries:
        if entry["name"] in seen_fatal:
            continue                       # already reported from open
        _check_entry(cs, entry, deep, issues)

    healthy = [e["name"] for e in entries
               if e["name"] not in {i.name for i in issues if i.fatal}]
    if set(cs.index.order) != set(healthy):
        issues.append(Issue(
            "index_stale", str(cs.root / "cluster_index.npz"),
            f"index covers {sorted(cs.index.tables)} but the healthy "
            f"manifest view is {sorted(healthy)}"))

    # derived caches: readability only — they are content-addressed and
    # self-heal at open, so damage here is healable by definition
    fpath = cs.root / "fit_cache.npz"
    if fpath.exists():
        try:
            with np.load(fpath) as z:
                z["keys"]
        except Exception as e:
            issues.append(Issue("cache_corrupt", str(fpath),
                                f"{type(e).__name__}: {e}"))
    gpath = cs.root / "grammar_cache.json"
    if gpath.exists():
        try:
            payload = json.loads(gpath.read_text())
            if payload.get("version") != 1:
                raise ValueError(f"version {payload.get('version')!r}")
        except Exception as e:
            issues.append(Issue("cache_corrupt", str(gpath),
                                f"{type(e).__name__}: {e}"))
    ipath = cs.root / "cluster_index.npz"
    if ipath.exists():
        try:
            from repro_torch.core.corpus_store import ClusterIndex
            ClusterIndex.load(ipath, expected_rel_tol=cs.rel_tol)
        except Exception as e:
            issues.append(Issue("index_corrupt", str(ipath),
                                f"{type(e).__name__}: {e}"))
    return VerifyReport(issues=issues, n_scenarios=len(entries), deep=deep)


# ---------------------------------------------------------------------------
# repair
# ---------------------------------------------------------------------------


def _reconstruct_entry(cs, name: str, store: TraceStore) -> dict:
    """A manifest entry is a pure function of (name, TraceStore,
    rel_tol) — reconstruction is bit-identical to the lost commit."""
    from repro_torch.core import noise as noise_mod
    return {
        "name": name,
        "file": f"{_SCENARIO_DIR}/{name}.npz",
        "content_hash": store.content_hash(),
        "n_ranks": store.n_ranks,
        "n_events": store.n_events,
        "n_compute_events": store.n_compute_events,
        "noise": noise_mod.calibrate(store, rel_tol=cs.rel_tol).to_json(),
    }


def _rebuild_shard(cs, i: int) -> None:
    """Reconstruct one corrupt shard manifest from the scenario
    artifacts: every loadable npz whose content hash routes to shard
    ``i`` and is not claimed by a healthy shard gets its entry
    recomputed.  Unloadable npz files stay on disk — the quarantine pass
    sweeps orphans afterwards."""
    known = {e["name"] for e in cs._iter_entries()}
    entries: list[dict] = []
    for npz in sorted((cs.root / _SCENARIO_DIR).glob("*.npz")):
        if npz.name.endswith(".buckets.npz"):
            continue
        name = npz.name[:-len(".npz")]
        if name in known:
            continue
        try:
            store = TraceStore.load(npz)
        except Exception:
            continue               # damaged orphan: swept below
        if cs._shard_of(store.content_hash()) != i:
            continue
        entries.append(_reconstruct_entry(cs, name, store))
    entries.sort(key=_entry_sort_key)
    with _file_lock(cs._lock_path(f"shard-{i:02d}")):
        _atomic_json_write(cs._shard_path(i),
                           {"version": _MANIFEST_VERSION,
                            "entries": entries},
                           site="write.shard")
    cs._shards[i] = entries
    cs.shard_errors.pop(i, None)


def _quarantine(cs, name: str, reason: str) -> None:
    """Move one damaged scenario's artifacts to ``quarantine/`` beside a
    JSON damage record, and drop it from the manifest + index."""
    qdir = cs.quarantine_dir()
    qdir.mkdir(exist_ok=True)
    moved = []
    for src in (cs.scenario_path(name), cs._sidecar_path(name)):
        if src.exists():
            dst = qdir / src.name
            os.replace(src, dst)
            moved.append(dst.name)
    record = {"name": name, "reason": reason, "moved": moved}
    (qdir / f"{name}.json").write_text(json.dumps(record, indent=1,
                                                 sort_keys=True))
    entry = next((e for e in cs._iter_entries() if e["name"] == name), None)
    if entry is not None:
        cs._remove_entry(entry)
    cs._stores.pop(name, None)
    cs.damaged.pop(name, None)
    if name in cs.index.tables:
        cs.index.remove(name)     # survivors refold (O(buckets)) at derive


def repair_store(cs) -> RepairReport:
    """Drive a full repair off a deep :func:`verify_store` pass.  See
    the module docstring for the three repair classes; the post-repair
    oracle is bit-parity with a from-scratch store over the survivors."""
    # shards first: quarantine needs parseable shards to remove entries
    rebuilt = []
    for i in sorted(cs.shard_errors):
        _rebuild_shard(cs, i)
        rebuilt.append(i)

    pre = verify_store(cs, deep=True)
    for name in pre.fatal_names:
        reasons = "; ".join(str(i) for i in pre.fatal if i.name == name)
        _quarantine(cs, name, reasons)

    healed = list(pre.healable)
    for issue in pre.healable:
        if issue.kind in ("sidecar_corrupt", "sidecar_stale",
                          "sidecar_missing") and issue.name:
            # drop the bad sidecar AND the in-memory table so
            # _finish_mutation recomputes both from the npz metrics
            Path(issue.path).unlink(missing_ok=True)
            if issue.name in cs.index.tables:
                cs.index.remove(issue.name)
        elif issue.kind == "index_stale" and issue.name:
            if issue.name in cs.index.tables:
                cs.index.remove(issue.name)
        elif issue.kind == "entry_stale" and issue.name:
            entry = next(e for e in cs._iter_entries()
                         if e["name"] == issue.name)
            store = TraceStore.load(cs.root / entry["file"])
            fresh = _reconstruct_entry(cs, issue.name, store)
            cs._remove_entry(entry)
            cs._append_entry(fresh)
        elif issue.kind == "cache_corrupt":
            # content-addressed pure derivations: start empty (costs a
            # re-solve / Sequitur re-run, never correctness)
            from repro_torch.core.corpus_store import FitCache, GrammarCache
            Path(issue.path).unlink(missing_ok=True)
            if issue.path.endswith(".npz"):
                cs.fits = FitCache()
            else:
                cs.grammars = GrammarCache()

    # orphan sweep: unloadable npz files referenced by no shard (their
    # entry died with a torn shard) — quarantine so they cannot be
    # resurrected by a later rebuild
    known = {e["name"] for e in cs._iter_entries()}
    quarantined = list(pre.fatal_names)
    for npz in sorted((cs.root / _SCENARIO_DIR).glob("*.npz")):
        if npz.name.endswith(".buckets.npz"):
            continue
        name = npz.name[:-len(".npz")]
        if name in known:
            continue
        try:
            TraceStore.load(npz)
        except Exception as e:
            _quarantine(cs, name, f"orphan npz unreadable: "
                                  f"{type(e).__name__}: {e}")
            quarantined.append(name)

    # the front-half memo may reference quarantined scenarios; it is a
    # pure cache, so dropping it costs recompute only
    cs.memo.clear()
    cs._finish_mutation()
    if quarantined:
        cs._notify("remove", quarantined)
    return RepairReport(quarantined=quarantined, rebuilt_shards=rebuilt,
                        healed=healed, pre=pre)

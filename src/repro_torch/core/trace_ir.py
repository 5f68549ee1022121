"""Columnar trace IR: the array-of-events representation of multi-rank traces.

Port copy of :mod:`repro.core.trace_ir`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

The per-event pipeline (``list[Event]`` per rank, one ``intern``/``push``/
dict-op per event) is O(python) in trace length.  :class:`TraceStore` keeps
the same information columnar:

* ``metrics``  — ``(n_compute_events, 6)`` float64, every compute event's
  metric vector across all ranks, rank-major in stream order;
* ``tokens``   — ``(n_events,)`` int64, the concatenated per-rank event
  streams: token ``t >= 0`` is the compute event stored in ``metrics[t]``,
  token ``t < 0`` is the interned communication event
  ``comm_pool[-t - 1]`` (comm events are deduplicated by canonical key);
* ``extents``  — ``(n_ranks + 1,)`` int64 rank offsets into ``tokens``;
* ``cluster_ids`` — ``(n_compute_events,)`` int64, the *ingested*
  ``ComputeEvent.cluster_id`` per row (``-1`` when unassigned).  Pipeline
  clustering never mutates the store; it returns fresh arrays.

The round trip to/from ``list[Event]`` is lossless (ppermute ``detail``
tuples, canonicalized ``axis_index_groups`` handles, pre-assigned cluster
ids all survive), and :meth:`TraceStore.save`/:meth:`TraceStore.load` make
traces offline ``.npz`` artifacts — trace once, synthesize anywhere.

:func:`compress_store` is the columnar rewrite of the grammar front half:
vectorized clustering (:func:`repro_torch.core.events.cluster_vectors`),
vectorized terminal interning (first-appearance factorization per rank),
and **signature-deduplicated** grammar construction — ranks whose token
streams are byte-identical (the overwhelmingly common SPMD case, the same
redundancy the replay engine's SIGNATURE_GROUPS exploit) share one
Sequitur run instead of paying for one each.  Each run RLE-collapses the
interned stream and feeds the flat-array kernel's batch entry point
(:meth:`repro_torch.core.sequitur.Sequitur.push_runs`), optionally consulting a
content-addressed grammar cache; per-stage timings land in an optional
``profile`` dict.  Output is bit-identical to the per-event reference
(:mod:`repro.core.frontend_reference`).
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Sequence

import numpy as np

from repro_torch.core.events import (
    CommEvent, ComputeEvent, Event, N_METRICS, cluster_vectors,
    encode_relative_perm, is_comm,
)
from repro_torch.core.grammar import Grammar, TerminalTable
from repro_torch.core.interproc import MergedProgram, merge_grammars
from repro_torch.core.sequitur import Sequitur, rle_runs

_NPZ_VERSION = 1


@dataclasses.dataclass
class TraceStore:
    """Columnar multi-rank event trace (see module docstring for layout)."""

    tokens: np.ndarray                 # (n_events,) int64
    extents: np.ndarray                # (n_ranks + 1,) int64
    metrics: np.ndarray                # (n_compute_events, 6) float64
    cluster_ids: np.ndarray            # (n_compute_events,) int64
    comm_pool: list[CommEvent]
    axis_sizes: dict[str, int]

    # -- shape accessors -------------------------------------------------------

    @property
    def n_ranks(self) -> int:
        return len(self.extents) - 1

    @property
    def n_events(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def n_compute_events(self) -> int:
        return int(self.metrics.shape[0])

    @property
    def n_comm_events(self) -> int:
        return self.n_events - self.n_compute_events

    def rank_tokens(self, rank: int) -> np.ndarray:
        return self.tokens[self.extents[rank]:self.extents[rank + 1]]

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_rank_traces(cls, rank_traces: Sequence[Sequence[Event]],
                         axis_sizes: dict[str, int] | None = None,
                         ) -> "TraceStore":
        """Ingest per-rank event lists (one Python pass; everything after
        this is columnar)."""
        tokens: list[int] = []
        extents = [0]
        rows: list[tuple] = []
        cids: list[int] = []
        pool: list[CommEvent] = []
        by_key: dict[str, int] = {}
        for tr in rank_traces:
            for ev in tr:
                if is_comm(ev):
                    k = ev.key()
                    cid = by_key.get(k)
                    if cid is None:
                        cid = len(pool)
                        by_key[k] = cid
                        pool.append(ev)
                    tokens.append(-cid - 1)
                else:
                    tokens.append(len(rows))
                    rows.append(ev.metrics)
                    cids.append(ev.cluster_id)
            extents.append(len(tokens))
        metrics = (np.asarray(rows, dtype=np.float64) if rows
                   else np.zeros((0, N_METRICS), dtype=np.float64))
        return cls(tokens=np.asarray(tokens, dtype=np.int64),
                   extents=np.asarray(extents, dtype=np.int64),
                   metrics=metrics,
                   cluster_ids=np.asarray(cids, dtype=np.int64),
                   comm_pool=pool,
                   axis_sizes=dict(axis_sizes or {}))

    @classmethod
    def from_template(cls, trace, axis_sizes: dict[str, int] | None = None,
                      ) -> "TraceStore":
        """Specialize an SPMD template trace straight into columnar form.

        Equivalent to ``from_rank_traces(per_rank_traces(trace))`` — same
        tokens, same metrics layout (rank-major), same comm pool order —
        without materializing per-rank Event lists.  Per-rank variation
        comes only from ``rawperm`` ppermute participation, so ranks are
        grouped into participation classes and each class's token stream
        is built once.
        """
        axis_sizes = dict(trace.axis_sizes if axis_sizes is None
                          else axis_sizes)
        axes = list(axis_sizes)
        sizes = [axis_sizes[a] for a in axes]
        n_ranks = int(np.prod(sizes)) if sizes else 1

        pool: list[CommEvent] = []
        by_key: dict[str, int] = {}

        def intern(ev: CommEvent) -> int:
            k = ev.key()
            cid = by_key.get(k)
            if cid is None:
                cid = len(pool)
                by_key[k] = cid
                pool.append(ev)
            return cid

        base: list[int] = []            # template tokens (compute rows local)
        trows: list[tuple] = []
        tcids: list[int] = []
        cond: list[tuple[int, str | None, frozenset]] = []
        for ev in trace.events:
            if not is_comm(ev):
                base.append(len(trows))
                trows.append(ev.metrics)
                tcids.append(ev.cluster_id)
                continue
            if ev.kind == "ppermute" and ev.detail \
                    and ev.detail[0] == "rawperm":
                perm = [tuple(p) for p in ev.detail[1]]
                axis = ev.axes[0] if ev.axes else None
                size = axis_sizes.get(
                    axis, max((max(s, d) for s, d in perm), default=0) + 1)
                rel = encode_relative_perm(perm, size)
                parts = frozenset({s for s, _ in perm}
                                  | {d for _, d in perm})
                cond.append((len(base), axis, parts))
                base.append(-intern(dataclasses.replace(ev, detail=rel)) - 1)
            else:
                base.append(-intern(ev) - 1)

        base_arr = np.asarray(base, dtype=np.int64)
        n_comp = len(trows)

        # per-rank mesh coordinates, vectorized (row-major rank flattening,
        # mirroring repro_torch.core.tracer.per_rank_traces)
        ranks = np.arange(n_ranks)
        coord: dict[str, np.ndarray] = {}
        stride = 1
        for a, s in zip(reversed(axes), reversed(sizes)):
            coord[a] = (ranks // stride) % s
            stride *= s
        zero = np.zeros(n_ranks, dtype=np.int64)

        if cond:
            bits = np.stack(
                [np.isin(coord.get(a, zero),
                         np.fromiter(parts, dtype=np.int64, count=len(parts)))
                 for (_, a, parts) in cond], axis=1)
        else:
            bits = np.zeros((n_ranks, 0), dtype=bool)

        class_tokens: dict[bytes, np.ndarray] = {}
        rank_chunks: list[np.ndarray] = []
        extents = [0]
        total = 0
        for r in range(n_ranks):
            key = bits[r].tobytes()
            toks = class_tokens.get(key)
            if toks is None:
                keep = np.ones(len(base_arr), dtype=bool)
                for (pos, _, _), b in zip(cond, bits[r]):
                    if not b:
                        keep[pos] = False
                toks = base_arr[keep]
                class_tokens[key] = toks
            tr = toks.copy()
            comp = tr >= 0
            tr[comp] += r * n_comp
            rank_chunks.append(tr)
            total += len(tr)
            extents.append(total)

        tmetrics = (np.asarray(trows, dtype=np.float64) if trows
                    else np.zeros((0, N_METRICS), dtype=np.float64))
        return cls(
            tokens=(np.concatenate(rank_chunks) if rank_chunks
                    else np.zeros(0, dtype=np.int64)),
            extents=np.asarray(extents, dtype=np.int64),
            metrics=np.tile(tmetrics, (n_ranks, 1)),
            cluster_ids=np.tile(np.asarray(tcids, dtype=np.int64), n_ranks),
            comm_pool=pool,
            axis_sizes=axis_sizes)

    # -- lossless expansion ----------------------------------------------------

    def _event_pool(self) -> np.ndarray:
        """Object array mapping token keys to Event instances: slot ``c``
        is comm event ``comm_pool[c]``, slot ``n_comms + t`` the
        ComputeEvent of metrics row ``t``.

        Compute rows are interned by value — one ComputeEvent per distinct
        (metrics, cluster_id) row, gathered back over the row index — so
        SPMD-tiled stores materialize one object per template event, not
        one per occurrence.  Cached on the store (stores are immutable
        once built)."""
        cached = getattr(self, "_event_pool_cache", None)
        if cached is not None:
            return cached
        n_comms = len(self.comm_pool)
        pool = np.empty(n_comms + self.n_compute_events, dtype=object)
        for c, ev in enumerate(self.comm_pool):
            pool[c] = ev
        if self.n_compute_events:
            keyed = np.concatenate(
                [self.metrics, self.cluster_ids[:, None].astype(np.float64)],
                axis=1)
            uq, inv = np.unique(keyed, axis=0, return_inverse=True)
            uniq_events = np.empty(len(uq), dtype=object)
            for u, row in enumerate(uq):
                uniq_events[u] = ComputeEvent(tuple(row[:N_METRICS].tolist()),
                                              cluster_id=int(row[N_METRICS]))
            pool[n_comms:] = uniq_events[inv.reshape(-1)]
        self._event_pool_cache = pool
        return pool

    def rank_events(self, rank: int) -> list[Event]:
        """Materialize rank ``rank``'s event list (lossless round trip) in
        one interned-key gather over the token stream (value-equal
        ComputeEvents alias one instance; events are frozen)."""
        toks = self.rank_tokens(rank)
        n_comms = len(self.comm_pool)
        idx = np.where(toks < 0, -toks - 1, toks + n_comms)
        return self._event_pool()[idx].tolist()

    def to_rank_traces(self) -> list[list[Event]]:
        return [self.rank_events(r) for r in range(self.n_ranks)]

    # -- size accounting (vectorized raw_trace_bytes) --------------------------

    def raw_trace_bytes(self) -> int:
        """Uncompressed trace-size estimate, identical to summing
        ``len(ev.key()) + 1`` over every materialized event."""
        total = 0
        comm_toks = self.tokens[self.tokens < 0]
        if len(comm_toks):
            comm_lens = np.asarray([len(ev.key()) + 1 for ev in self.comm_pool],
                                   dtype=np.int64)
            total += int(comm_lens[-comm_toks - 1].sum())
        if self.n_compute_events:
            uq, inv = np.unique(self.metrics, axis=0, return_inverse=True)
            base = np.asarray(
                [len("X|" + "|".join(f"{m:.6g}" for m in row)) + 1
                 for row in uq], dtype=np.int64)
            row_lens = base[inv.reshape(-1)]
            pre = self.cluster_ids >= 0
            if pre.any():
                row_lens = row_lens.copy()
                row_lens[pre] = [len(f"X|{c}") + 1
                                 for c in self.cluster_ids[pre].tolist()]
            comp_toks = self.tokens[self.tokens >= 0]
            total += int(row_lens[comp_toks].sum())
        return total

    def comm_occurrence_counts(self) -> np.ndarray:
        """Per-comm-pool-entry occurrence counts across all ranks,
        ``(len(comm_pool),)`` int64 — the weights the noise calibrator
        uses so a collective repeated 10⁴ times dominates its kind's
        payload-spread estimate over a one-off of the same kind."""
        ct = self.tokens[self.tokens < 0]
        return np.bincount(-ct - 1, minlength=len(self.comm_pool))

    def compute_totals(self) -> np.ndarray:
        """Per-rank compute-metric totals, ``(n_ranks, 6)`` (the original
        side of the fidelity comparison), in one vectorized pass."""
        out = np.zeros((self.n_ranks, N_METRICS))
        if self.n_compute_events:
            rank_of = np.repeat(np.arange(self.n_ranks),
                                np.diff(self.extents))
            comp = self.tokens >= 0
            np.add.at(out, rank_of[comp], self.metrics[self.tokens[comp]])
        return out

    # -- content identity ------------------------------------------------------

    def content_hash(self) -> str:
        """Deterministic sha256 over the full store content (tokens,
        extents, metrics, ingested cluster ids, comm keys, axis sizes).

        Two stores with equal content hash synthesize identically; the
        corpus store keys its manifest entries and fit caches on it.
        """
        h = hashlib.sha256()
        for arr in (self.tokens, self.extents, self.metrics,
                    self.cluster_ids):
            h.update(np.ascontiguousarray(arr).tobytes())
        for ev in self.comm_pool:
            h.update(ev.key().encode())
            h.update(b"\x00")
        h.update(json.dumps(self.axis_sizes, sort_keys=True).encode())
        return h.hexdigest()

    # -- offline artifacts (.npz) ----------------------------------------------

    def save(self, path) -> Path:
        """Write the store as a ``.npz`` artifact; returns the actual path."""
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_suffix(path.suffix + ".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        comm = [repr((ev.kind, ev.shape, ev.dtype, ev.axes, ev.detail))
                for ev in self.comm_pool]
        comm_arr = (np.asarray(comm) if comm
                    else np.zeros(0, dtype="<U1"))
        meta = json.dumps({"version": _NPZ_VERSION,
                           "axis_sizes": self.axis_sizes})
        with open(path, "wb") as f:
            np.savez(f, tokens=self.tokens, extents=self.extents,
                     metrics=self.metrics, cluster_ids=self.cluster_ids,
                     comm=comm_arr, meta=np.asarray(meta))
        return path

    @staticmethod
    def load_columns(path, names: Sequence[str]) -> dict[str, np.ndarray]:
        """Partial load: read only the named arrays (``tokens`` /
        ``extents`` / ``metrics`` / ``cluster_ids``) from a saved store
        without materializing the comm pool (``ast.literal_eval`` per comm
        event is the slow part of a full :meth:`load`).  The cluster-index
        rebuild path reads just ``metrics`` this way.
        """
        valid = {"tokens", "extents", "metrics", "cluster_ids"}
        bad = set(names) - valid
        if bad:
            raise ValueError(f"unknown store columns {sorted(bad)}")
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            version = meta.get("version")
            if version != _NPZ_VERSION:
                raise ValueError(
                    f"unsupported trace store version {version!r} in {path}"
                    f" (this build reads version {_NPZ_VERSION})")
            dtypes = {"metrics": np.float64}
            return {n: z[n].astype(dtypes.get(n, np.int64)) for n in names}

    @classmethod
    def load(cls, path) -> "TraceStore":
        with np.load(path) as z:
            meta = json.loads(str(z["meta"]))
            version = meta.get("version")
            if version != _NPZ_VERSION:
                raise ValueError(
                    f"unsupported trace store version {version!r} in {path}"
                    f" (this build reads version {_NPZ_VERSION})")
            pool = []
            for s in z["comm"].tolist():
                kind, shape, dtype, axes, detail = ast.literal_eval(s)
                pool.append(CommEvent(kind, tuple(shape), dtype,
                                      tuple(axes), tuple(detail)))
            return cls(tokens=z["tokens"].astype(np.int64),
                       extents=z["extents"].astype(np.int64),
                       metrics=z["metrics"].astype(np.float64),
                       cluster_ids=z["cluster_ids"].astype(np.int64),
                       comm_pool=pool,
                       axis_sizes={str(k): int(v) for k, v in
                                   meta["axis_sizes"].items()})


# ---------------------------------------------------------------------------
# columnar grammar front half
# ---------------------------------------------------------------------------


def _first_appearance_factorize(sym: np.ndarray,
                                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map a symbol stream to local ids numbered by first appearance.

    Returns ``(local_ids, uniq_syms, first_pos)`` where ``uniq_syms[k]`` is
    the symbol assigned local id ``k`` and ``first_pos[k]`` its first
    occurrence index — exactly the order a per-event ``TerminalTable``
    intern loop would have produced.
    """
    uq, first, inv = np.unique(sym, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    lid = np.empty(len(uq), dtype=np.int64)
    lid[order] = np.arange(len(uq))
    return lid[inv], uq[order], first[order]


def rank_symbol_streams(store: TraceStore, cluster_ids: np.ndarray,
                        ) -> np.ndarray:
    """Global symbol per token for every rank's stream, concatenated:
    comm id ``c`` -> ``c``, compute cluster ``k`` -> ``n_comms + k``
    (slice with ``store.extents`` for per-rank views).  Shared by
    :func:`compress_store` and the grammar benchmarks."""
    n_comms = len(store.comm_pool)
    toks = store.tokens
    if store.n_compute_events:
        comp_sym = n_comms + cluster_ids[np.maximum(toks, 0)]
    else:
        comp_sym = np.zeros(len(toks), dtype=np.int64)
    return np.where(toks < 0, -toks - 1, comp_sym)


def compress_store(store: TraceStore,
                   rel_tol: float = 0.05,
                   threshold: float = 0.5,
                   *,
                   cluster_ids: np.ndarray | None = None,
                   reps: dict[int, np.ndarray] | None = None,
                   grammar_cache=None,
                   profile: dict | None = None,
                   ) -> tuple[list[Grammar], MergedProgram,
                              list[list[int]], dict[int, np.ndarray]]:
    """Columnar replacement for the per-event ``compress_rank_traces``.

    Clusters compute events jointly across ranks (vectorized), interns
    terminals by first-appearance factorization of each rank's symbol
    stream, runs the flat Sequitur kernel once per *distinct* stream
    (ranks with byte-identical streams share the resulting grammar
    object) after an RLE pre-pass (:func:`repro_torch.core.sequitur.rle_runs`),
    and merges (Algorithm 1).  Pass precomputed ``cluster_ids``/``reps``
    (aligned to ``store.metrics`` rows) to reuse a corpus-level joint
    clustering.

    ``grammar_cache`` (any object with the
    :class:`repro.core.corpus_store.GrammarCache` interface) memoizes the
    frozen Sequitur rules content-addressed by (local-id stream, threshold)
    — a hit skips grammar inference entirely; the terminal table is still
    built per stream (it binds store-local events).  Cached rule dicts
    alias across hits, read-only downstream like the per-class grammar
    aliasing below.

    ``profile`` (a dict) accumulates per-stage wall-clock and cache
    counters: ``cluster_ms``/``intern_ms``/``grammar_ms``/``merge_ms``,
    ``n_distinct_streams``/``n_sequitur_runs``, and
    ``grammar_cache_hits``/``grammar_cache_misses``.  Keys add onto
    existing values so one dict can aggregate across scenarios.
    """
    from time import perf_counter

    t0 = perf_counter()
    if cluster_ids is None:
        cluster_ids, reps = cluster_vectors(store.metrics, rel_tol)
    else:
        cluster_ids = np.asarray(cluster_ids, dtype=np.int64)
        if reps is None:
            raise ValueError("cluster_ids without reps")
    t_cluster = perf_counter() - t0

    n_comms = len(store.comm_pool)
    toks = store.tokens
    sym_all = rank_symbol_streams(store, cluster_ids)

    grammars: list[Grammar] = []
    rank_ids: list[list[int]] = []
    cache: dict[bytes, tuple[Grammar, list[int]]] = {}
    t_intern = t_grammar = 0.0
    n_runs = n_hits = n_misses = 0
    for r in range(store.n_ranks):
        sl = slice(int(store.extents[r]), int(store.extents[r + 1]))
        sym = sym_all[sl]
        key = sym.tobytes()
        hit = cache.get(key)
        if hit is None:
            t1 = perf_counter()
            local_ids, uniq, first = _first_appearance_factorize(sym)
            table = TerminalTable()
            rtoks = toks[sl]
            for s, fi in zip(uniq.tolist(), first.tolist()):
                if s < n_comms:
                    table.intern(store.comm_pool[s])
                else:
                    row = int(rtoks[fi])
                    table.intern(ComputeEvent(
                        tuple(store.metrics[row].tolist()),
                        cluster_id=int(s - n_comms)))
            t2 = perf_counter()
            t_intern += t2 - t1
            rules = gkey = None
            if grammar_cache is not None:
                gkey = grammar_cache.key(local_ids, threshold)
                rules = grammar_cache.get(gkey)
            if rules is None:
                if gkey is not None:
                    n_misses += 1
                seq = Sequitur()
                seq.push_runs(*rle_runs(local_ids))
                rules = seq.grammar_rules()
                n_runs += 1
                if gkey is not None:
                    grammar_cache.put(gkey, rules)
            else:
                n_hits += 1
            t_grammar += perf_counter() - t2
            hit = (Grammar(rules=rules, table=table), local_ids.tolist())
            cache[key] = hit
        grammars.append(hit[0])
        # grammars deliberately alias across a signature class (read-only
        # downstream, tested); id lists get a per-rank copy so in-place
        # edits by callers can't corrupt sibling ranks
        rank_ids.append(list(hit[1]))
    t3 = perf_counter()
    merged = merge_grammars(grammars, threshold)
    if profile is not None:
        for k, v in (("cluster_ms", t_cluster * 1e3),
                     ("intern_ms", t_intern * 1e3),
                     ("grammar_ms", t_grammar * 1e3),
                     ("merge_ms", (perf_counter() - t3) * 1e3),
                     ("n_distinct_streams", len(cache)),
                     ("n_sequitur_runs", n_runs),
                     ("grammar_cache_hits", n_hits),
                     ("grammar_cache_misses", n_misses)):
            profile[k] = profile.get(k, 0) + v
    return grammars, merged, rank_ids, reps

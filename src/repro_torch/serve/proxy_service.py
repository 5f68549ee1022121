"""Proxy-serving query tier: "give me a proxy shaped like X" without
re-synthesis.

Port copy of :mod:`repro.serve.proxy_service`; ``repro_torch`` imports nothing from
``repro``.

The fleet-scale payoff of the corpus store (ROADMAP "Fleet-scale
corpus"): profiling feeds a trace in, placement/procurement asks which
known workload it resembles and what it would cost on each chip — the
automated profiling → prediction loop of Synapse (PAPERS.md).  The
serving discipline mirrors :class:`repro_torch.serve.engine.ServeEngine`: pay
the compile/synthesis cost once up front, then answer every request from
warm state at fixed cost — batched, observable, and coherent under
corpus mutation:

* **Batched queries.**  :meth:`ProxyService.query_batch` featurizes many
  traces against one vectorized cluster match over their concatenated
  metric rows (:class:`~repro_torch.core.corpus_store.ClusterMatcher`) and
  answers them with a single (n_queries × n_scenarios) distance
  computation; :meth:`ProxyService.query` is the batch of one, so the
  two paths cannot drift.

* **Mutation-coherent warm cache.**  The service subscribes to
  :meth:`CorpusStore.subscribe` notifications; ``add``/``remove`` flips
  a stale bit and the next query triggers :meth:`ProxyService.refresh`
  — one incremental ``synthesize_corpus`` (memo/cache-resolved, *not* a
  re-warm: ``n_warm_synthesis`` stays 1) that re-embeds **only** the
  scenarios whose label-invariant embed key changed and invalidates
  only the ``(name, chip)`` profile memos whose module changed.
  Refreshed state is pinned bit-identical to a freshly constructed
  service on the mutated store.  An *unsubscribed* service detects
  manifest-fingerprint drift and raises :class:`StaleServiceError`
  instead of serving removed scenarios.

* **Nearest-neighbor structure.**  At or above ``ann_threshold``
  scenarios the distance stage queries an exact
  :class:`~repro_torch.serve.ann.BallTree` instead of materializing the full
  distance matrix; the brute-force path stays as the parity oracle
  (same nearest scenario, bit-equal distance).  In ANN mode
  ``QueryResult.distances`` holds only the matched scenario.

* **Sequence-aware embedding.**  Embeddings concatenate three
  unit-log-normalized terms: summed fit-coefficient mass over matched
  clusters, the comm-kind payload·occurrence histogram, and a
  grammar-rule histogram (depth-binned transitive rule-instantiation
  counts, :func:`repro_torch.core.grammar.rule_histogram`) read from the
  store's cached frozen grammars — schedule-divergent but comm-identical
  workloads separate, with **no Sequitur on any path** (an uncached
  query stream just contributes a zero term and bumps
  ``n_grammar_hist_misses``).

* **Observability.**  ``stats`` carries per-stage latency accumulators
  (``match_ms``/``featurize_ms``/``distance_ms``/``profile_ms``, via the
  shared :class:`repro_torch.serve.engine.StageTimers`) and hit-rate counters;
  ``benchmarks/corpus_scale.py`` snapshots them per row.

No Sequitur, no fit dispatch, no codegen on the hot path — the ``stats``
counters pin this (``n_warm_synthesis`` stays 1 however many queries and
refreshes run), and tests assert it by poisoning the cold-path entry
points after warm-up.

Featurizing over fit coefficients rather than raw metrics deliberately
measures distance in *proxy space*: two traces that synthesize to the
same block combinations are the same workload to the serving tier, even
if their raw metric magnitudes differ.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading

import numpy as np

from repro_torch.core.corpus_store import GrammarCache, ScenarioCorruptError
from repro_torch.core.events import COMM_KINDS, N_METRICS
from repro_torch.core.grammar import GRAMMAR_HIST_BINS, rule_histogram
from repro_torch.core.interproc import compute_gid_index
from repro_torch.core.portability import (
    CHIPS, REFERENCE_CHIP, ProfilePrediction, predict_profile,
)
from repro_torch.device import resolve_device
from repro_torch.core.trace_ir import (
    TraceStore, _first_appearance_factorize, rank_symbol_streams,
)
from repro_torch.serve.ann import BallTree
from repro_torch.serve.engine import StageTimers

_KIND_INDEX = {k: i for i, k in enumerate(COMM_KINDS)}
_N_COEF = 11                       # block-combination loop counts (x_1..x_11)

#: corpus size at which the distance stage switches from the brute-force
#: matrix to the exact ball tree (overridable per service)
ANN_THRESHOLD = 64


class StaleServiceError(RuntimeError):
    """The corpus store mutated under a service that is not subscribed to
    its mutation notifications — the warm cache can no longer be trusted,
    so the service fails loudly instead of answering from stale state."""


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Answer to one nearest-scenario query."""

    name: str                      # nearest corpus scenario
    distance: float                # embedding distance to it
    #: per-scenario distances for inspection — every scenario in
    #: brute-force mode; only the matched one once the ANN index is
    #: active (the tree never materializes the rest)
    distances: dict[str, float]
    module: object                 # its cached pre-assembled proxy module
    profile: ProfilePrediction     # cross-chip roofline estimate
    matched_frac: float            # fraction of rows exact-key matched

    @property
    def module_path(self) -> str:
        """The generated proxy source on disk — reloadable anywhere via
        :func:`repro_torch.core.replay.load_saved_module`."""
        return self.module.__proxy_path__


def _unit_log_rows(m: np.ndarray) -> np.ndarray:
    """Row-wise log1p then L2-normalize: comparable across trace lengths
    and robust to the metric magnitude spread.  One vectorized pass over
    a whole batch; the reduction (elementwise square, per-row sum, sqrt)
    is row-local, so a row's bits do not depend on batch size — the
    batch of one and the batch of N embed identically."""
    m = np.log1p(np.maximum(np.asarray(m, dtype=np.float64), 0.0))
    n = np.sqrt((m ** 2).sum(axis=1, keepdims=True))
    return np.divide(m, np.where(n > 0, n, 1.0))


def _unit_log(v: np.ndarray) -> np.ndarray:
    """:func:`_unit_log_rows` of a single vector."""
    return _unit_log_rows(np.asarray(v, dtype=np.float64)[None])[0]


class ProxyService:
    """Warm-cache nearest-scenario serving over a corpus store.

    ::

        svc = ProxyService(cstore)                 # one warm synthesis
        ans = svc.query(trace_store, chip="h200")  # hot path: pure NumPy
        outs = svc.query_batch(traces)             # one vectorized pass
        ans.module.__proxy_path__                  # pre-assembled proxy
        ans.profile.step_time                      # cross-chip estimate

    ``chip`` is the default target for profile predictions; per-query
    ``chip=`` overrides.  ``count_scale``/``threshold``/``out_dir``
    forward to the warm :func:`~repro_torch.core.synthesize.synthesize_corpus`
    call (``out_dir`` makes the cached modules land somewhere durable).
    ``device`` is where the fits and the cached proxy modules run
    (``None`` means the CUDA card, and raises without one; the hot path
    itself is NumPy on the host).
    ``subscribe=False`` opts out of the store's mutation notifications —
    such a service raises :class:`StaleServiceError` if the store drifts
    under it.  ``ann_threshold`` sets the corpus size at which nearest-
    scenario lookup switches to the exact ball tree.
    """

    def __init__(self, cstore, *, chip: str = REFERENCE_CHIP,
                 threshold: float = 0.5, count_scale: float = 1.0,
                 out_dir=None, subscribe: bool = True,
                 ann_threshold: int = ANN_THRESHOLD, device=None):
        if not cstore.names:
            raise ValueError("cannot serve an empty corpus")
        if chip not in CHIPS:
            raise ValueError(f"unknown chip {chip!r} (have {sorted(CHIPS)})")
        from repro_torch.core.synthesize import synthesize_corpus   # lazy: torch
        self._device = resolve_device(device)
        self._cstore = cstore
        self.chip = chip
        self._threshold = threshold
        self._count_scale = count_scale
        self._out_dir = out_dir
        self._ann_threshold = int(ann_threshold)
        self._lock = threading.RLock()
        self._stale = False
        self._timers = StageTimers("match", "featurize", "distance",
                                   "profile")
        self.stats = {
            "n_warm_synthesis": 0,
            "n_refresh": 0,
            "n_queries": 0,
            "n_query_batches": 0,
            "n_module_cache_hits": 0,
            "n_profile_cache_hits": 0,
            "n_profile_cache_misses": 0,
            "n_profile_invalidated": 0,
            "n_matched_rows": 0,
            "n_fallback_rows": 0,
            "n_reembedded": 0,
            "n_grammar_hist_hits": 0,
            "n_grammar_hist_misses": 0,
            "n_ann_queries": 0,
            "n_brute_queries": 0,
            # degraded-mode serving (see refresh()): a failed refresh
            # keeps answering from the last-good snapshot
            "degraded": False,
            "n_degraded_refreshes": 0,
            "n_excluded_scenarios": 0,
        }
        self._degraded_cause: BaseException | None = None
        self._failed_fingerprint: str | None = None
        self.stats.update(self._timers.snapshot_ms())
        # the single cold-path synthesis (on a warm store this resolves
        # from the persisted grammar/fit caches and the result memo)
        self.corpus = synthesize_corpus(store=cstore, threshold=threshold,
                                        count_scale=count_scale,
                                        out_dir=out_dir, device=self._device)
        self.stats["n_warm_synthesis"] += 1
        self._embeddings: dict[str, np.ndarray] = {}
        self._embed_keys: dict[str, str] = {}
        self._profiles: dict[tuple[str, str], ProfilePrediction] = {}
        self._sync(count_reembeds=False)
        self._subscribed = False
        if subscribe:
            cstore.subscribe(self._on_store_mutation)
            self._subscribed = True

    # -- warm-state derivation / refresh ---------------------------------------

    def _sync(self, count_reembeds: bool) -> None:
        """(Re)derive every piece of warm serving state from the current
        ``self.corpus`` + store view, reusing embeddings whose
        label-invariant embed key is unchanged."""
        cstore = self._cstore
        # cluster id -> fit-coefficient row, via the corpus terminal table
        gid_of = compute_gid_index(self.corpus.table)
        n_cids = (max(gid_of) + 1) if gid_of else 0
        self._coef = np.zeros((n_cids, _N_COEF))
        for cid, gid in gid_of.items():
            fr = self.corpus.fits.get(gid)
            if fr is not None:
                self._coef[cid] = np.asarray(fr.x, dtype=np.float64)
        # frozen matcher snapshot: in-flight queries stay immune to index
        # mutations until the next sync
        self._matcher = cstore.index.matcher()
        ids_by_name, _ = cstore.cluster_assignments()
        old_keys, old_emb = self._embed_keys, self._embeddings
        embeddings: dict[str, np.ndarray] = {}
        keys: dict[str, str] = {}
        memo: dict = {}
        n_re = 0
        for name in cstore.names:
            k = self._embed_key(name, ids_by_name[name])
            keys[name] = k
            if old_keys.get(name) == k:
                embeddings[name] = old_emb[name]
            else:
                embeddings[name] = self._featurize(
                    cstore.load_scenario(name), ids_by_name[name], memo)
                n_re += 1
        if count_reembeds:
            self.stats["n_reembedded"] += n_re
        self._embeddings, self._embed_keys = embeddings, keys
        self._names = list(embeddings)
        self._emb_mat = np.stack([embeddings[n] for n in self._names])
        self._ann = (BallTree(self._emb_mat)
                     if len(self._names) >= self._ann_threshold else None)
        self._fingerprint = cstore.manifest_fingerprint()

    def _embed_key(self, name: str, cids: np.ndarray) -> str:
        """Content key of one scenario's embedding: trace content hash ⊕
        first-appearance cluster pattern ⊕ the coefficient rows of the
        clusters it touches.  Deliberately invariant under pure cluster
        relabeling (the common effect of unrelated appends/removals), so
        refresh re-embeds only scenarios whose embedding inputs actually
        changed."""
        local, uniq, _ = _first_appearance_factorize(
            np.asarray(cids, dtype=np.int64))
        h = hashlib.sha256(
            f"embed|1|{self._threshold!r}|"
            f"{self._cstore.content_hash(name)}|".encode())
        h.update(np.ascontiguousarray(local, dtype=np.int64).tobytes())
        for u in uniq.tolist():
            if 0 <= u < len(self._coef):
                h.update(self._coef[int(u)].tobytes())
            else:
                h.update(b"\xff")
        return h.hexdigest()

    def _on_store_mutation(self, event: str, names) -> None:
        # runs inside the mutator (under the store lock): only flip the
        # stale bit — taking the service lock here would invert the
        # service-then-store lock order refresh uses
        self._stale = True

    def _ensure_fresh(self) -> None:
        if self._degraded_cause is not None:
            # degraded: retry the refresh only once the store actually
            # changed (a repair/mutation moves the fingerprint) — never a
            # retry storm against the same broken state
            if (self._stale or self._cstore.manifest_fingerprint()
                    != self._failed_fingerprint):
                self.refresh()
            return
        if self._stale:
            self.refresh()
            return
        if self._cstore.manifest_fingerprint() != self._fingerprint:
            if self._subscribed:
                self.refresh()        # notification raced us: catch up
            else:
                raise StaleServiceError(
                    "corpus store mutated under an unsubscribed "
                    "ProxyService (manifest fingerprint drifted); construct "
                    "a fresh service or subscribe to mutation notifications")

    def refresh(self) -> "ProxyService":
        """Catch the warm cache up with the mutated store: one
        incremental ``synthesize_corpus`` (memo/cache-resolved — not a
        re-warm), selective re-embedding, precise profile-memo
        invalidation.  Resulting state is bit-identical to a freshly
        constructed service on the mutated store.

        A refresh that *fails* (corrupt scenario artifact, damaged
        store, synthesis error) does not take the service down: the
        last-good snapshot keeps serving, ``stats["degraded"]`` /
        :meth:`health` surface the cause, scenarios implicated in the
        failure are excluded from matching, and the next store change
        (e.g. :meth:`~repro_torch.core.corpus_store.CorpusStore.repair`
        quarantining the culprit) triggers a retry that restores normal
        service — with state bit-identical to a rebuilt one."""
        from repro_torch.core.synthesize import synthesize_corpus   # lazy: torch
        with self._lock:
            cstore = self._cstore
            with cstore.lock:
                # clear the stale bit *before* re-deriving: a mutation
                # landing after we release the store lock re-arms it, so
                # no update is ever lost
                self._stale = False
                if not cstore.names:
                    raise ValueError("cannot serve an empty corpus")
                old_corpus = self.corpus
                old_modules = {n: r.proxy.module
                               for n, r in self.corpus.results.items()}
                try:
                    self.corpus = synthesize_corpus(
                        store=cstore, threshold=self._threshold,
                        count_scale=self._count_scale,
                        out_dir=self._out_dir, device=self._device)
                    self.stats["n_refresh"] += 1
                    dropped = 0
                    for key in list(self._profiles):
                        res = self.corpus.results.get(key[0])
                        if (res is None or res.proxy.module
                                is not old_modules.get(key[0])):
                            del self._profiles[key]
                            dropped += 1
                    self.stats["n_profile_invalidated"] += dropped
                    self._sync(count_reembeds=True)
                except Exception as e:
                    # keep serving the last-good snapshot (InjectedCrash
                    # is a BaseException: a simulated process death is
                    # not degradable and propagates)
                    self.corpus = old_corpus
                    self._enter_degraded(e)
                    return self
                self._exit_degraded()
        return self

    # -- degraded-mode serving -------------------------------------------------

    def _enter_degraded(self, cause: BaseException) -> None:
        """A refresh failed: record the cause + the fingerprint it failed
        against (the retry gate), and drop scenarios implicated in the
        failure from the match set so a damaged scenario is never
        *answered* from the stale snapshot."""
        self._degraded_cause = cause
        self._failed_fingerprint = self._cstore.manifest_fingerprint()
        self.stats["degraded"] = True
        self.stats["n_degraded_refreshes"] += 1
        bad: set[str] = set(getattr(self._cstore, "damaged", {}) or {})
        c: BaseException | None = cause
        while c is not None:
            if isinstance(c, ScenarioCorruptError):
                bad.add(c.name)
            c = c.__cause__
        keep = [n for n in self._names if n not in bad]
        if keep and len(keep) < len(self._names):
            self._names = keep
            self._emb_mat = np.stack([self._embeddings[n] for n in keep])
            self._ann = (BallTree(self._emb_mat)
                         if len(keep) >= self._ann_threshold else None)
        self.stats["n_excluded_scenarios"] = (
            len(self._embeddings) - len(self._names))

    def _exit_degraded(self) -> None:
        self._degraded_cause = None
        self._failed_fingerprint = None
        self.stats["degraded"] = False
        self.stats["n_excluded_scenarios"] = 0

    def health(self) -> dict:
        """Liveness/consistency snapshot for operators: ``status`` is
        ``"ok"`` or ``"degraded"``; degraded responses carry the refresh
        failure's cause and how much of the corpus is still served."""
        with self._lock:
            degraded = self._degraded_cause is not None
            return {
                "status": "degraded" if degraded else "ok",
                "degraded": degraded,
                "cause": (f"{type(self._degraded_cause).__name__}: "
                          f"{self._degraded_cause}" if degraded else None),
                "serving_scenarios": len(self._names),
                "excluded_scenarios": int(
                    self.stats["n_excluded_scenarios"]),
                "n_refresh": int(self.stats["n_refresh"]),
                "n_degraded_refreshes": int(
                    self.stats["n_degraded_refreshes"]),
            }

    def close(self) -> None:
        """Detach from the store's mutation notifications (idempotent)."""
        if self._subscribed:
            self._cstore.unsubscribe(self._on_store_mutation)
            self._subscribed = False

    # -- featurization (pure NumPy + cached frozen grammars) -------------------

    def _grammar_hist(self, store: TraceStore, cids: np.ndarray,
                      memo: dict | None = None) -> np.ndarray:
        """Summed depth-binned rule histogram over the trace's per-rank
        streams, read from the store's cached frozen grammars (the same
        content-addressed keys joint synthesis populates) — no Sequitur;
        an uncached stream contributes zeros and counts a miss.  ``memo``
        dedupes work on repeated streams, keyed first by raw stream bytes
        (skipping factorize + hashing entirely) and then by grammar key;
        :meth:`query_batch` shares one memo across the whole batch, so
        look-alike probes pay for featurization once."""
        memo = {} if memo is None else memo
        hist = np.zeros(2 * GRAMMAR_HIST_BINS, dtype=np.int64)
        syms = rank_symbol_streams(store, np.asarray(cids, dtype=np.int64))
        ext = store.extents
        for r in range(store.n_ranks):
            s = syms[int(ext[r]):int(ext[r + 1])]
            if not len(s):
                continue
            sb = s.tobytes()
            h = memo.get(sb)
            if h is None:
                local_ids, _, _ = _first_appearance_factorize(s)
                key = GrammarCache.key(local_ids, self._threshold)
                h = memo.get(key)
                if h is None:
                    rules = self._cstore.grammars.get(key)
                    if rules is None:
                        self.stats["n_grammar_hist_misses"] += 1
                        h = np.zeros(2 * GRAMMAR_HIST_BINS, dtype=np.int64)
                    else:
                        self.stats["n_grammar_hist_hits"] += 1
                        h = rule_histogram(rules)
                    memo[key] = h
                memo[sb] = h
            hist += h
        return hist

    def _featurize_parts(self, store: TraceStore, cids: np.ndarray,
                         memo: dict | None = None,
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The three raw (un-normalized) embedding terms of one trace:
        summed fit-coefficient mass over its compute rows, comm-kind
        payload·occurrence histogram, grammar-rule histogram."""
        comp = np.zeros(_N_COEF)
        if len(cids) and len(self._coef):
            valid = cids[(cids >= 0) & (cids < len(self._coef))]
            comp = self._coef[valid].sum(axis=0)
        comm = np.zeros(len(COMM_KINDS))
        occ = store.comm_occurrence_counts()
        for c, ev in enumerate(store.comm_pool):
            comm[_KIND_INDEX[ev.kind]] += float(occ[c]) * ev.payload_bytes
        return comp, comm, self._grammar_hist(store, cids, memo)

    @staticmethod
    def _embed_rows(parts: list) -> np.ndarray:
        """Normalize a batch of :meth:`_featurize_parts` outputs in three
        vectorized passes (one per term) — row bits are batch-size
        independent, so this is the single embedding definition for
        corpus scenarios, single queries, and batches alike."""
        return np.concatenate(
            [_unit_log_rows(np.stack([p[i] for p in parts]))
             for i in range(3)], axis=1)

    def _featurize(self, store: TraceStore, cids: np.ndarray,
                   memo: dict | None = None) -> np.ndarray:
        """Embed one trace: the three terms of :meth:`_featurize_parts`,
        each log-scaled and unit-normalized."""
        return self._embed_rows([self._featurize_parts(store, cids, memo)])[0]

    def embedding(self, name: str) -> np.ndarray:
        """The precomputed embedding of a corpus scenario."""
        return self._embeddings[name]

    # -- the hot path ----------------------------------------------------------

    def query(self, store: TraceStore, chip: str | None = None,
              ) -> QueryResult:
        """Nearest corpus scenario for a query trace — index matching +
        embedding distance + cached module/profile lookup; no synthesis
        stage runs.  The batch of one: bit-identical to
        :meth:`query_batch` by construction."""
        return self.query_batch([store], chip=chip)[0]

    def query_batch(self, stores, chip: str | None = None,
                    ) -> list[QueryResult]:
        """Answer many queries in one vectorized pass: a single cluster
        match over the concatenated metric rows, per-segment
        featurization, and one (n_queries × n_scenarios) distance
        computation (or one ball-tree walk per query in ANN mode)."""
        stores = list(stores)
        for i, st in enumerate(stores):
            if st.n_events == 0:
                raise ValueError(
                    f"cannot query an empty trace (batch index {i}): the "
                    "all-zero embedding would match an arbitrary scenario")
        if not stores:
            return []
        with self._lock:
            return self._query_batch_locked(stores, chip)

    def _query_batch_locked(self, stores: list, chip: str | None,
                            ) -> list[QueryResult]:
        self._ensure_fresh()
        self.stats["n_query_batches"] += 1
        self.stats["n_queries"] += len(stores)

        ext = np.cumsum([0] + [st.metrics.shape[0] for st in stores])
        with self._timers.time("match"):
            allm = (np.concatenate([st.metrics for st in stores])
                    if ext[-1] else np.zeros((0, N_METRICS)))
            cids_all, matched_all = self._matcher.match(allm)
        self.stats["n_matched_rows"] += int(matched_all.sum())
        self.stats["n_fallback_rows"] += int((~matched_all).sum())

        with self._timers.time("featurize"):
            memo: dict = {}       # shared: look-alike probes featurize once
            Q = self._embed_rows(
                [self._featurize_parts(st, cids_all[ext[i]:ext[i + 1]], memo)
                 for i, st in enumerate(stores)])

        with self._timers.time("distance"):
            if self._ann is not None:
                self.stats["n_ann_queries"] += len(stores)
                picks = [self._ann.query(q) for q in Q]
                idxs = [i for i, _ in picks]
                dists = [{self._names[i]: float(d)} for i, d in picks]
            else:
                self.stats["n_brute_queries"] += len(stores)
                D = np.sqrt(((Q[:, None, :] - self._emb_mat[None]) ** 2)
                            .sum(axis=-1))
                idxs = np.argmin(D, axis=1).tolist()
                dists = [dict(zip(self._names, row)) for row in D.tolist()]

        out: list[QueryResult] = []
        with self._timers.time("profile"):
            for k, st in enumerate(stores):
                name = self._names[int(idxs[k])]
                module = self.corpus.results[name].proxy.module
                self.stats["n_module_cache_hits"] += 1
                profile = self.predict_profile(name, chip)
                m = matched_all[ext[k]:ext[k + 1]]
                out.append(QueryResult(
                    name=name, distance=float(dists[k][name]),
                    distances=dists[k], module=module, profile=profile,
                    matched_frac=(float(m.mean()) if len(m) else 1.0)))
        self.stats.update(self._timers.snapshot_ms())
        return out

    def predict_profile(self, name: str, chip: str | None = None,
                        ) -> ProfilePrediction:
        """Memoized cross-chip roofline estimate for a corpus scenario's
        proxy module (the prediction is a pure function of the cached
        module, so one computation per (scenario, chip) serves every
        query)."""
        chip = chip or self.chip
        key = (name, chip)
        with self._lock:
            hit = self._profiles.get(key)
            if hit is None:
                self.stats["n_profile_cache_misses"] += 1
                hit = predict_profile(
                    self.corpus.results[name].proxy.module, chip)
                self._profiles[key] = hit
            else:
                self.stats["n_profile_cache_hits"] += 1
            return hit

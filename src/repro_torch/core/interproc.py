"""Inter-process compression (paper §2.6, Algorithm 1).

Port copy of :mod:`repro.core.interproc`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

Input: one per-rank :class:`~repro_torch.core.grammar.Grammar` each (own terminal
table, own rule ids).  Output: a :class:`MergedProgram` with

  * a single global terminal table          (§2.6.1, tree-merge semantics)
  * a global non-terminal rule set, merged bottom-up by rule depth (§2.6.2)
  * per-cluster merged main rules whose symbols carry rank sets (§2.6.3,
    Algorithm 1: normalized-edit-distance clustering + LCS merge)

The losslessness invariant — ``expand_rank(r)`` reproduces rank r's original
event-id sequence exactly, for every rank — is property-tested.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.events import is_comm
from repro_torch.core.grammar import Grammar, Sym, TerminalTable

#: merged main-rule entry: (kind, ref, exp, ranks)
MainSym = tuple[str, int, int, frozenset]


@dataclasses.dataclass
class MergedProgram:
    table: TerminalTable
    rules: dict[int, list[Sym]]          # global non-terminals (no main here)
    mains: list[list[MainSym]]           # one merged main rule per cluster
    cluster_ranks: list[frozenset]       # ranks covered by each cluster
    n_ranks: int

    # -- lossless expansion ---------------------------------------------------

    def expand_rank(self, rank: int) -> list[int]:
        out: list[int] = []
        for main, ranks in zip(self.mains, self.cluster_ranks):
            if rank not in ranks:
                continue
            for kind, ref, exp, rset in main:
                if rank not in rset:
                    continue
                if kind == "t":
                    out.extend([ref] * exp)
                else:
                    self._expand(ref, exp, out)
        return out

    def _expand(self, rid: int, times: int, out: list[int]) -> None:
        body = self.rules[rid]
        for _ in range(times):
            for kind, ref, exp in body:
                if kind == "t":
                    out.extend([ref] * exp)
                else:
                    self._expand(ref, exp, out)

    # -- structure exposure (codegen lowering, §2.7) --------------------------
    #
    # Codegen lowers rule bodies into rolled loop nests; these accessors hand
    # it the structure it needs (evaluation order, nesting depth, per-rule
    # comm-axis footprints) so the emitter never re-derives grammar shape.

    def rule_topo_order(self) -> list[int]:
        """Children-first ordering of the global rules (deterministic: ids
        ascending within a level of readiness)."""
        seen: set[int] = set()
        out: list[int] = []

        def visit(rid: int) -> None:
            if rid in seen:
                return
            seen.add(rid)
            for kind, ref, _ in self.rules[rid]:
                if kind == "r":
                    visit(ref)
            out.append(rid)

        for rid in sorted(self.rules):
            visit(rid)
        return out

    def rule_depths(self) -> dict[int, int]:
        """Depth of every global rule (terminals = leaves), bottom-up."""
        depths: dict[int, int] = {}
        for rid in self.rule_topo_order():
            d = 1
            for kind, ref, _ in self.rules[rid]:
                if kind == "r":
                    d = max(d, 1 + depths[ref])
            depths[rid] = d
        return depths

    def max_rule_depth(self) -> int:
        """Deepest rule nesting — the scan-nest depth of compiled modules."""
        return max(self.rule_depths().values(), default=0)

    def rule_histogram(self, n_bins: int | None = None):
        """Depth-binned transitive rule-instantiation counts over the
        whole merged program (:func:`repro_torch.core.grammar.rule_histogram`
        applied to a synthetic main that concatenates every merged main
        rule, each entry weighted by its rank-set size) — the program's
        shape as a small integer vector, rank-weighted so an SPMD rule
        executed by 64 ranks counts 64×."""
        from repro_torch.core.grammar import GRAMMAR_HIST_BINS, rule_histogram
        n_bins = GRAMMAR_HIST_BINS if n_bins is None else n_bins
        synth = max(self.rules, default=-1) + 1
        body: list[Sym] = [(k, ref, exp * len(ranks))
                           for main in self.mains
                           for k, ref, exp, ranks in main]
        return rule_histogram({**self.rules, synth: body}, main_id=synth,
                              n_bins=n_bins)

    def rule_comm_axes(self) -> dict[int, frozenset]:
        """Mesh axes touched by comm terminals reachable from each rule,
        computed once bottom-up (drives per-group device hints)."""
        axes: dict[int, frozenset] = {}
        for rid in self.rule_topo_order():
            acc: set[str] = set()
            for kind, ref, _ in self.rules[rid]:
                if kind == "t":
                    ev = self.table.events[ref]
                    if is_comm(ev):
                        acc.update(ev.axes)
                else:
                    acc |= axes[ref]
            axes[rid] = frozenset(acc)
        return axes

    # -- size accounting -------------------------------------------------------

    def n_symbols(self) -> int:
        n = sum(len(b) for b in self.rules.values())
        n += sum(len(m) for m in self.mains)
        return n

    def encoded_size_bytes(self) -> int:
        """Symbols ~9B, rank sets ~4B+4B/rank-range, terminals by key size."""
        sym = 9 * self.n_symbols() + 4 * len(self.rules)
        ranks = sum(4 + 4 * _rankset_cost(s[3], self.n_ranks)
                    for m in self.mains for s in m)
        table = sum(len(ev.key()) + 2 for ev in self.table.events)
        return sym + ranks + table


def _rankset_cost(rs: frozenset, n_ranks: int) -> int:
    """Encoded cost of a rank set: 0 if all ranks, else #contiguous runs."""
    if len(rs) == n_ranks:
        return 0
    runs, prev = 0, None
    for r in sorted(rs):
        if prev is None or r != prev + 1:
            runs += 1
        prev = r
    return runs


# ---------------------------------------------------------------------------
# §2.6.1 terminal-table merge
# ---------------------------------------------------------------------------


def merge_terminal_tables(tables: Sequence[TerminalTable],
                          ) -> tuple[TerminalTable, list[dict[int, int]]]:
    """Union all per-rank tables into one global table.

    Deployed multi-controller this is the paper's log2(P)-round tree merge
    followed by a root broadcast; the result (global id per unique key,
    first-use order) is identical, so the host implementation is sequential.
    """
    glob = TerminalTable()
    maps: list[dict[int, int]] = []
    for tab in tables:
        m = {local: glob.intern(ev) for local, ev in enumerate(tab.events)}
        maps.append(m)
    return glob, maps


def corpus_terminal_table(programs: Sequence[MergedProgram],
                          ) -> tuple[TerminalTable, list[dict[int, int]]]:
    """§2.6.1 applied once more, across scenarios: union the merged tables
    of several synthesized programs into one corpus-level terminal table.

    Compute terminals keyed by joint cluster id (``X|<cid>``) and identical
    comm terminals unify across scenarios, so one block-combination fit per
    corpus terminal covers every scenario that uses it.  Returns the global
    table plus one per-scenario ``{scenario gid -> corpus gid}`` map.
    The union's identity (:func:`table_fingerprint`) versions downstream
    caches: a fit cached under one table version is only reusable while the
    terminal it fits still means the same thing.
    """
    return merge_terminal_tables([p.table for p in programs])


def compute_gid_index(table: TerminalTable) -> dict[int, int]:
    """``{joint cluster id -> corpus gid}`` over a corpus terminal
    table's compute terminals.

    The inverse lookup the serve tier needs: a query trace's metric rows
    map onto joint cluster ids (``ClusterIndex.match_clusters``), and
    this index maps those onto the corpus-gid-keyed fit coefficients
    (``CorpusResult.fits``) — pure dict work, no clustering or fitting.
    Cluster ids are unique across a corpus table's compute terminals by
    construction (they key the union, ``X|<cid>``)."""
    return {ev.cluster_id: gid for gid, ev in enumerate(table.events)
            if not is_comm(ev) and ev.cluster_id >= 0}


def table_fingerprint(table: TerminalTable) -> str:
    """Content version of a terminal table: sha256 over the ordered
    terminal keys.

    Two unions with the same fingerprint assign identical meanings to
    every gid prefix they share, so per-terminal artifacts (block-
    combination fits, codegen combos) keyed by ``(fingerprint-compatible
    terminal key, target)`` survive incremental re-unions; any semantic
    drift (a cluster id re-used for a different behaviour) changes the
    fingerprint and invalidates them.
    """
    import hashlib

    h = hashlib.sha256()
    for ev in table.events:
        h.update(ev.key().encode())
        h.update(b"\x00")
    return h.hexdigest()


# ---------------------------------------------------------------------------
# §2.6.2 non-terminal merge (bottom-up by depth, structural hashing)
# ---------------------------------------------------------------------------


def merge_nonterminals(grammars: Sequence[Grammar],
                       tmaps: Sequence[dict[int, int]],
                       ) -> tuple[dict[int, list[Sym]], list[dict[int, int]]]:
    """Merge rules across ranks: identical bodies (in global ids) unify.

    Processing by increasing depth guarantees child rules are canonical
    before parents are compared — the paper's observation that equal-depth
    comparison from the bottom is both necessary and sufficient.
    """
    sig2gid: dict[tuple, int] = {}
    glob: dict[int, list[Sym]] = {}
    rmaps: list[dict[int, int]] = []
    for g, tmap in zip(grammars, tmaps):
        depths = g.rule_depths()
        rmap: dict[int, int] = {}
        for rid in sorted((r for r in g.rules if r != g.main_id),
                          key=lambda r: depths[r]):
            body = []
            for kind, ref, exp in g.rules[rid]:
                gref = tmap[ref] if kind == "t" else rmap[ref]
                body.append((kind, gref, exp))
            sig = tuple(body)
            gid = sig2gid.get(sig)
            if gid is None:
                gid = len(sig2gid)
                sig2gid[sig] = gid
                glob[gid] = body
            rmap[rid] = gid
        rmaps.append(rmap)
    return glob, rmaps


def _globalize_main(g: Grammar, tmap: dict[int, int], rmap: dict[int, int],
                    ) -> tuple[Sym, ...]:
    out = []
    for kind, ref, exp in g.rules[g.main_id]:
        gref = tmap[ref] if kind == "t" else rmap[ref]
        out.append((kind, gref, exp))
    return tuple(out)


# ---------------------------------------------------------------------------
# §2.6.3 main-rule merge (Algorithm 1)
# ---------------------------------------------------------------------------


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Classic O(len(a)*len(b)) token edit distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ta in enumerate(a, 1):
        cur = [i]
        for j, tb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ta != tb)))
        prev = cur
    return prev[-1]


def difference_degree(a: Sequence, b: Sequence) -> float:
    """Paper: Δ_{a,b} = d_{a,b} / max(l_a, l_b)."""
    m = max(len(a), len(b))
    return levenshtein(a, b) / m if m else 0.0


def _lcs_pairs(a: Sequence, b: Sequence) -> list[tuple[int, int]]:
    """Index pairs of one longest common subsequence."""
    la, lb = len(a), len(b)
    dp = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la - 1, -1, -1):
        for j in range(lb - 1, -1, -1):
            dp[i][j] = (dp[i + 1][j + 1] + 1 if a[i] == b[j]
                        else max(dp[i + 1][j], dp[i][j + 1]))
    out, i, j = [], 0, 0
    while i < la and j < lb:
        if a[i] == b[j]:
            out.append((i, j))
            i += 1
            j += 1
        elif dp[i + 1][j] >= dp[i][j + 1]:
            i += 1
        else:
            j += 1
    return out


def _merge_into(merged: list[MainSym], body: tuple[Sym, ...],
                ranks: frozenset) -> list[MainSym]:
    """LCS-merge one more rank-group's main-rule body into the running merge.

    LCS symbols get the union rank set; off-LCS symbols keep their own
    rank list, placed in order (paper §2.6.3 merge procedure steps 1-3).
    """
    a_toks = [(k, r, e) for k, r, e, _ in merged]
    pairs = _lcs_pairs(a_toks, list(body))
    out: list[MainSym] = []
    ai = bi = 0
    for ia, ib in pairs:
        out.extend(merged[ai:ia])
        out.extend((k, r, e, ranks) for k, r, e in body[bi:ib])
        k, r, e, rs = merged[ia]
        out.append((k, r, e, rs | ranks))
        ai, bi = ia + 1, ib + 1
    out.extend(merged[ai:])
    out.extend((k, r, e, ranks) for k, r, e in body[bi:])
    return out


def merge_main_rules(mains: Sequence[tuple[Sym, ...]],
                     threshold: float = 0.5,
                     ) -> tuple[list[list[MainSym]], list[frozenset]]:
    """Algorithm 1: dedupe -> Δ-threshold clustering -> LCS merge.

    ``mains[r]`` is rank r's globalized main-rule body.  Identical bodies are
    grouped first (the overwhelmingly common SPMD case), so the quadratic
    distance matrix is over *distinct* bodies only.
    """
    groups: dict[tuple, list[int]] = {}
    for r, body in enumerate(mains):
        groups.setdefault(body, []).append(r)
    distinct = list(groups)
    granks = [frozenset(groups[b]) for b in distinct]

    # Δ-threshold greedy clustering over distinct bodies (paper: "there is no
    # effect of merging in some cases" -> Δ above threshold starts a cluster)
    unmerged = list(range(len(distinct)))
    clusters: list[list[int]] = []
    while unmerged:
        leader = unmerged.pop(0)
        cluster = [leader]
        rest = []
        for j in unmerged:
            if difference_degree(distinct[leader], distinct[j]) <= threshold:
                cluster.append(j)
            else:
                rest.append(j)
        unmerged = rest
        clusters.append(cluster)

    merged_mains: list[list[MainSym]] = []
    cluster_ranks: list[frozenset] = []
    for cluster in clusters:
        lead = cluster[0]
        merged = [(k, r, e, granks[lead]) for k, r, e in distinct[lead]]
        ranks = granks[lead]
        for j in cluster[1:]:
            merged = _merge_into(merged, distinct[j], granks[j])
            ranks = ranks | granks[j]
        merged_mains.append(merged)
        cluster_ranks.append(ranks)
    return merged_mains, cluster_ranks


# ---------------------------------------------------------------------------
# top-level
# ---------------------------------------------------------------------------


def merge_grammars(grammars: Sequence[Grammar], threshold: float = 0.5,
                   ) -> MergedProgram:
    tables = [g.table for g in grammars]
    glob_table, tmaps = merge_terminal_tables(tables)
    glob_rules, rmaps = merge_nonterminals(grammars, tmaps)
    mains = [_globalize_main(g, tm, rm)
             for g, tm, rm in zip(grammars, tmaps, rmaps)]
    merged_mains, cluster_ranks = merge_main_rules(mains, threshold)
    return MergedProgram(table=glob_table, rules=glob_rules,
                         mains=merged_mains, cluster_ranks=cluster_ranks,
                         n_ranks=len(grammars))

"""Frozen grammar + terminal-table model (paper §2.5-2.6 data structures).

Port copy of :mod:`repro.core.grammar`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

A :class:`Grammar` is the per-process result of intra-process compression:
an id-keyed rule set (rule 0 = main rule) over a :class:`TerminalTable` that
maps canonical event keys to small integer ids (the hash table of §2.5).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

import numpy as np

from repro_torch.core.events import CommEvent, ComputeEvent, Event, is_comm
from repro_torch.core.sequitur import Sequitur

# A rule body entry: ("t", terminal_id, exp) or ("r", rule_id, exp)
Sym = tuple[str, int, int]

#: depth bins of :func:`rule_histogram` (the last bin absorbs deeper rules)
GRAMMAR_HIST_BINS = 8


def rule_histogram(rules: dict[int, list[Sym]], main_id: int = 0,
                   n_bins: int = GRAMMAR_HIST_BINS) -> np.ndarray:
    """Depth-binned rule occurrence/instantiation counts of a frozen rule
    set — the grammar's *shape* as a small integer vector of length
    ``2 * n_bins``.

    The first half sums, over every non-main rule of depth ``d`` (depth
    1 = all-terminal bodies; depths ``>= n_bins`` fold into the last
    bin), how many times the rule is instantiated in one full expansion
    of ``main_id`` (exponents multiply through the rule DAG); the second
    half counts the *distinct* reachable rules per depth.  Two streams
    with identical symbol mass but different schedules compress to
    different rule sets, so their histograms separate — the serve tier's
    sequence-aware embedding term.  Both halves ride along deliberately:
    after the serve tier's scale-invariant log-normalization a single
    vector would collapse scalar multiples (e.g. one depth-1 rule
    instantiated 6× vs two instantiated 6× each), while the pair keeps
    distinct log-magnitude ratios.  Pure dict/int work over the frozen
    ``{rid: [(kind, ref, exp), ...]}`` form (the
    :class:`~repro.core.corpus_store.GrammarCache` payload): no Sequitur,
    no terminal table.  int64 (exact counts), not normalized.
    """
    depths: dict[int, int] = {}

    def depth(r: int) -> int:
        if r in depths:
            return depths[r]
        depths[r] = 0  # cycle guard (well-formed grammars are acyclic)
        d = 1 + max((depth(ref) for k, ref, _ in rules[r] if k == "r"),
                    default=0)
        depths[r] = d
        return d

    for r in rules:
        depth(r)

    # transitive instantiation counts: parents (strictly deeper than any
    # rule they reference) propagate before children are read
    counts: dict[int, int] = {main_id: 1}
    for r in sorted(rules, key=lambda r: (-depths[r], r)):
        c = counts.get(r, 0)
        if not c:
            continue            # unreachable from main
        for kind, ref, exp in rules[r]:
            if kind == "r":
                counts[ref] = counts.get(ref, 0) + c * exp
    hist = np.zeros(2 * n_bins, dtype=np.int64)
    for r, d in depths.items():
        if r != main_id and counts.get(r, 0):
            hist[min(d, n_bins) - 1] += counts[r]
            hist[n_bins + min(d, n_bins) - 1] += 1
    return hist


class TerminalTable:
    """Event <-> id interning table (paper: 'events are stored in a hash
    table ... then the trace is represented by a sequence of ids')."""

    def __init__(self):
        self.by_key: dict[str, int] = {}
        self.events: list[Event] = []

    def intern(self, ev: Event) -> int:
        k = ev.key()
        tid = self.by_key.get(k)
        if tid is None:
            tid = len(self.events)
            self.by_key[k] = tid
            self.events.append(ev)
        return tid

    def __len__(self):
        return len(self.events)

    def __getitem__(self, tid: int) -> Event:
        return self.events[tid]


@dataclasses.dataclass
class Grammar:
    rules: dict[int, list[Sym]]     # rule 0 is the main rule
    table: TerminalTable
    main_id: int = 0

    # -- lossless expansion ---------------------------------------------------

    def expand_ids(self, rid: int | None = None) -> list[int]:
        rid = self.main_id if rid is None else rid
        out: list[int] = []
        self._expand(rid, 1, out)
        return out

    def _expand(self, rid: int, times: int, out: list[int]) -> None:
        body = self.rules[rid]
        for _ in range(times):
            for kind, ref, exp in body:
                if kind == "t":
                    out.extend([ref] * exp)
                else:
                    self._expand(ref, exp, out)

    def expand_events(self) -> list[Event]:
        return [self.table[i] for i in self.expand_ids()]

    def expanded_length(self, rid: int | None = None) -> int:
        """Number of events the grammar expands to, without expanding."""
        rid = self.main_id if rid is None else rid
        memo: dict[int, int] = {}

        def length(r: int) -> int:
            if r in memo:
                return memo[r]
            total = 0
            for kind, ref, exp in self.rules[r]:
                total += exp * (1 if kind == "t" else length(ref))
            memo[r] = total
            return total

        return length(rid)

    # -- size accounting (paper Table 3 'compressed size') --------------------

    def n_symbols(self) -> int:
        return sum(len(b) for b in self.rules.values())

    def encoded_size_bytes(self) -> int:
        """Serialized size: symbols (kind+ref+exp ~ 9B) + terminal table."""
        sym_bytes = 9 * self.n_symbols() + 4 * len(self.rules)
        table_bytes = sum(len(ev.key()) + 2 for ev in self.table.events)
        return sym_bytes + table_bytes

    def rule_depth(self, rid: int) -> int:
        """Tree height with terminals as leaves (paper §2.6.2)."""
        return self.rule_depths()[rid]

    def rule_depths(self) -> dict[int, int]:
        """Depths of every rule in one shared-memo pass — callers that need
        all depths (non-terminal merge, codegen lowering) pay O(symbols)
        total instead of O(rules * symbols)."""
        memo: dict[int, int] = {}

        def depth(r: int) -> int:
            if r in memo:
                return memo[r]
            memo[r] = 0  # cycle guard (well-formed grammars are acyclic)
            d = 1 + max((depth(ref) for k, ref, _ in self.rules[r] if k == "r"),
                        default=0)
            memo[r] = d
            return d

        for r in self.rules:
            depth(r)
        return memo

    def to_json(self) -> str:
        return json.dumps({
            "rules": {str(k): v for k, v in self.rules.items()},
            "terminals": [ev.key() for ev in self.table.events],
        })


def raw_trace_bytes(events: Iterable[Event]) -> int:
    """Uncompressed trace size estimate (paper Table 3 'trace size'):
    one record per event (key string, like a text trace line)."""
    return sum(len(ev.key()) + 1 for ev in events)


def from_sequitur(s: Sequitur, table: TerminalTable) -> Grammar:
    """Freeze a Sequitur run (flat kernel or reference — both expose
    ``grammar_rules`` over their pool) into a :class:`Grammar`."""
    return Grammar(rules=s.grammar_rules(), table=table)


def compress_events(events: Iterable[Event]) -> Grammar:
    """Intern + Sequitur-compress a flat event sequence.

    Interning runs first so the id stream feeds the kernel's batch entry
    point (``push_ids`` RLE-collapses internally) instead of a scalar
    push per event.
    """
    table = TerminalTable()
    ids = [table.intern(ev) for ev in events]
    s = Sequitur()
    s.push_ids(ids)
    return from_sequitur(s, table)

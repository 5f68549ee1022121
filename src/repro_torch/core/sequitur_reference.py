"""Reference Sequitur — the preserved object-graph implementation.

Port copy of :mod:`repro.core.sequitur_reference`, kept line for line so
both packages hold their flat kernels to the same oracle; ``repro_torch``
imports nothing from ``repro``.  ``KERNEL == "reference"``.

This module keeps, verbatim, the linked-``Node``/``Rule`` Sequitur that
:mod:`repro_torch.core.sequitur` (the flat-array kernel) replaced.  It is
the **parity oracle**, mirroring the
:mod:`repro_torch.core.frontend_reference` convention: the flat kernel
must emit ``to_json``-identical grammars to this implementation on every
stream (``tests/test_torch_oracles.py`` pins that for the port,
``tests/test_sequitur_kernel.py`` for the reference).
Keep it in sync with any grammar *semantics* change; never "optimize" it.

Classic Sequitur [Nevill-Manning & Witten 1997] maintains two constraints over
an online-constructed context-free grammar:

  (1) digram uniqueness -- any adjacent symbol pair occurs at most once;
  (2) rule utility      -- every rule (except the main rule) is used >= twice.

The paper adds the Omnisc'IO-style run-length constraint:

  (3) adjacent equal symbols a^i a^j are merged into a^{i+j},

which turns the O(log n) encoding of a loop that repeats n times into O(1).

Symbols are integers (terminal ids) or :class:`Rule` references; every symbol
occurrence carries an exponent.  ``push_run`` lets a caller append an already
run-length-compressed repetition in O(1) -- used by the tracer for
collective-free ``lax.scan`` bodies with huge trip counts.
"""
from __future__ import annotations

from typing import Iterable, Iterator


class Rule:
    """A grammar rule: circular doubly-linked list of symbols with a guard."""
    __slots__ = ("rid", "guard", "users")
    _counter = 0

    def __init__(self, rid: int):
        self.rid = rid
        self.users: set["Node"] = set()   # symbol nodes referencing this rule
        g = Node(None, 0)
        g.owner = self
        g.prev = g.next = g
        self.guard = g

    @property
    def first(self) -> "Node":
        return self.guard.next

    @property
    def last(self) -> "Node":
        return self.guard.prev

    def symbols(self) -> Iterator["Node"]:
        n = self.guard.next
        while n is not self.guard:
            yield n
            n = n.next

    def __repr__(self):
        return f"R{self.rid}"


class Node:
    """One symbol occurrence: (sym, exp) in a doubly-linked rule body."""
    __slots__ = ("sym", "exp", "prev", "next", "owner")

    def __init__(self, sym, exp: int):
        self.sym = sym            # int terminal id, Rule, or None for guard
        self.exp = exp
        self.prev: "Node" = None  # type: ignore
        self.next: "Node" = None  # type: ignore
        self.owner = None         # set on guard nodes only

    @property
    def is_guard(self) -> bool:
        return self.sym is None

    def ident(self):
        if isinstance(self.sym, Rule):
            return ("r", self.sym.rid)
        return ("t", self.sym)

    def __repr__(self):
        s = f"R{self.sym.rid}" if isinstance(self.sym, Rule) else str(self.sym)
        return f"{s}^{self.exp}" if self.exp != 1 else s


class Sequitur:
    """Online grammar builder enforcing constraints (1)-(3)."""

    KERNEL = "reference"

    def __init__(self):
        self._next_rid = 1
        self.main = Rule(0)
        self.rules: dict[int, Rule] = {0: self.main}
        self.digrams: dict[tuple, Node] = {}

    # -- public API ---------------------------------------------------------

    def push(self, sym: int) -> None:
        self.push_run(sym, 1)

    def push_run(self, sym: int, count: int) -> None:
        if count <= 0:
            return
        node = Node(sym, count)
        self._link_rule_use(node)
        last = self.main.last
        self._join(last, node)
        self._join(node, self.main.guard)
        self._check(last)

    def push_many(self, syms: Iterable[int]) -> None:
        for s in syms:
            self.push(s)

    def push_ids(self, ids) -> None:
        """Ingest a pre-interned terminal-id array (the columnar trace IR
        hands sequences over as numpy int arrays).

        Ids are converted to plain Python ints in one bulk ``tolist()``
        call before the push loop: numpy scalars hash like ints but leak
        into digram keys and frozen rule bodies (breaking ``to_json`` and
        bit-exact rule comparisons), and per-element ``int()`` conversion
        is the slowest part of the loop.  The grammar produced is
        bit-identical to ``push_many`` over the same sequence.
        """
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        for s in ids:
            self.push(s)

    def expand(self) -> list[int]:
        """Expand the grammar back into the original sequence (lossless)."""
        out: list[int] = []
        self._expand_rule(self.main, 1, out)
        return out

    def grammar_rules(self) -> dict[int, list[tuple]]:
        """Freeze to ``{rid: [(kind, ref, exp), ...]}`` with kind in {t, r}."""
        out = {}
        for rid, rule in self.rules.items():
            body = []
            for n in rule.symbols():
                if isinstance(n.sym, Rule):
                    body.append(("r", n.sym.rid, n.exp))
                else:
                    body.append(("t", n.sym, n.exp))
            out[rid] = body
        return out

    def size(self) -> int:
        """Total number of symbol occurrences across all rules."""
        return sum(len(list(r.symbols())) for r in self.rules.values())

    # -- internals ----------------------------------------------------------

    def _expand_rule(self, rule: Rule, times: int, out: list) -> None:
        for _ in range(times):
            for n in rule.symbols():
                if isinstance(n.sym, Rule):
                    self._expand_rule(n.sym, n.exp, out)
                else:
                    out.extend([n.sym] * n.exp)

    def _link_rule_use(self, node: Node) -> None:
        if isinstance(node.sym, Rule):
            node.sym.users.add(node)

    def _unlink_rule_use(self, node: Node) -> None:
        if isinstance(node.sym, Rule):
            node.sym.users.discard(node)

    @staticmethod
    def _digram_key(node: Node) -> tuple:
        return (node.ident(), node.exp, node.next.ident(), node.next.exp)

    def _remove_digram(self, node: Node) -> None:
        """Drop the table entry for the digram starting at ``node`` if it is
        the registered occurrence."""
        if node.is_guard or node.next is None or node.next.is_guard:
            return
        key = self._digram_key(node)
        if self.digrams.get(key) is node:
            del self.digrams[key]

    def _join(self, left: Node, right: Node) -> None:
        if left.next is not None:
            self._remove_digram(left)
        left.next = right
        right.prev = left

    def _delete_node(self, node: Node) -> None:
        """Unlink ``node``; cleans its digrams and rule-use accounting."""
        self._remove_digram(node.prev)
        self._remove_digram(node)
        self._join(node.prev, node.next)
        self._unlink_rule_use(node)
        node.prev = node.next = None  # poison

    def _insert_after(self, where: Node, node: Node) -> None:
        self._link_rule_use(node)
        self._join(node, where.next)
        self._join(where, node)

    def _check(self, node: Node) -> bool:
        """Enforce constraints on the digram (node, node.next).

        Returns True if the grammar was modified.
        """
        if node is None or node.is_guard or node.next is None or node.next.is_guard:
            return False

        nxt = node.next
        # constraint (3): run-length merge of adjacent equal symbols
        if node.ident() == nxt.ident():
            self._remove_digram(node.prev)
            self._remove_digram(nxt)
            node.exp += nxt.exp
            self._delete_node(nxt)
            # digrams around the merged node changed; re-check both sides
            self._check(node.prev)
            self._check(node)
            return True

        key = self._digram_key(node)
        match = self.digrams.get(key)
        if match is None:
            self.digrams[key] = node
            return False
        if match is node or match.next is node or node.next is match:
            return False  # identical or overlapping occurrence
        self._process_match(node, match)
        return True

    def _is_full_rule_body(self, first: Node) -> Rule | None:
        """If (first, first.next) is the entire body of a rule, return it."""
        if first.prev.is_guard and first.next.next.is_guard:
            return first.prev.owner
        return None

    def _process_match(self, node: Node, match: Node) -> None:
        rule = self._is_full_rule_body(match)
        if rule is not None and rule is not self.main:
            self._substitute(node, rule)
        else:
            rule = self._is_full_rule_body(node)
            if rule is not None and rule is not self.main:
                # the *new* digram is itself a full rule body; reuse it for the
                # match occurrence instead.
                self._substitute(match, rule)
            else:
                new_rule = Rule(self._next_rid)
                self._next_rid += 1
                self.rules[new_rule.rid] = new_rule
                a = Node(node.sym, node.exp)
                b = Node(node.next.sym, node.next.exp)
                self._insert_after(new_rule.guard, a)
                self._insert_after(a, b)
                self._substitute(match, new_rule)
                self._substitute(node, new_rule)
                # Register the rule-body digram.  NB: a rule-utility inline
                # during the substitutions above may have spliced new bodies
                # into ``new_rule`` (poisoning ``a``), so consult the live
                # body rather than the captured nodes.
                first = new_rule.first
                if first is not new_rule.guard and first.next is not new_rule.guard:
                    key = self._digram_key(first)
                    cur = self.digrams.get(key)
                    if cur is None or cur.prev is None:
                        self.digrams[key] = first

    def _substitute(self, node: Node, rule: Rule) -> None:
        """Replace the digram starting at ``node`` with one ``rule`` symbol."""
        prev = node.prev
        first_sym, second_sym = node.sym, node.next.sym
        self._delete_node(node.next)
        self._delete_node(node)
        use = Node(rule, 1)
        self._insert_after(prev, use)
        # rule-utility bookkeeping for symbols we just removed
        for s in (first_sym, second_sym):
            if isinstance(s, Rule) and s is not rule:
                self._maybe_inline(s)
        if not self._check(prev):
            self._check(use)

    def _maybe_inline(self, rule: Rule) -> None:
        """Constraint (2): a rule used once with exponent 1 is inlined."""
        if rule is self.main or rule.rid not in self.rules:
            return
        if len(rule.users) != 1:
            return
        (use,) = tuple(rule.users)
        if use.prev is None:  # poisoned node awaiting GC
            rule.users.discard(use)
            return
        if use.exp != 1:
            return  # keeps a loop body alive (run-length semantics)
        prev = use.prev
        nxt = use.next
        first, last = rule.first, rule.last
        if first is rule.guard:  # empty rule body; just drop the use
            self._delete_node(use)
            del self.rules[rule.rid]
            return
        self._delete_node(use)
        # splice the body in place (nodes keep their digram registrations)
        self._join(prev, first)
        self._join(last, nxt)
        del self.rules[rule.rid]
        # boundary digrams are new
        if not self._check(prev):
            self._check(last)

    # -- debugging ----------------------------------------------------------

    def dump(self) -> str:
        lines = []
        for rid in sorted(self.rules):
            body = " ".join(map(repr, self.rules[rid].symbols()))
            lines.append(f"R{rid} -> {body}")
        return "\n".join(lines)


def compress(seq: Iterable[int]) -> Sequitur:
    s = Sequitur()
    s.push_many(seq)
    return s

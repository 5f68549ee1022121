"""Space-optimized Sequitur (paper §2.5.2) — flat-array kernel.

Port copy of :mod:`repro.core.sequitur`, kept line for line so both packages build
the same grammars and tables; ``repro_torch`` imports nothing from ``repro``.

Classic Sequitur [Nevill-Manning & Witten 1997] maintains two constraints over
an online-constructed context-free grammar:

  (1) digram uniqueness -- any adjacent symbol pair occurs at most once;
  (2) rule utility      -- every rule (except the main rule) is used >= twice.

The paper adds the Omnisc'IO-style run-length constraint:

  (3) adjacent equal symbols a^i a^j are merged into a^{i+j},

which turns the O(log n) encoding of a loop that repeats n times into O(1).

**Flat layout.**  The original implementation (preserved verbatim as the
parity oracle in :mod:`repro.core.sequitur_reference`) kept one Python
``Node`` object per symbol occurrence in doubly-linked ``Rule`` bodies and
hashed 4-deep nested tuples per digram.  This kernel stores the symbol pool
as five index-linked columns, so a "node" is an integer index and every
structural step is a column read/write:

* ``_sym[i] >= 0`` — terminal id; ``_sym[i] < 0`` — rule reference encoding
  rule id ``-sym - 1``; ``_sym[i] is None`` — a rule's guard (the guard's
  ``_exp`` slot holds the owning rule id, the analog of ``Node.owner``);
* ``_prev``/``_next`` hold pool indices; ``None`` marks an unlinked
  (poisoned) node exactly where the reference poisons ``Node.prev``;
* ``_reg[i]`` caches the digram-table key node ``i`` is currently
  registered under (None when unregistered) — see the invariant below;
* the digram table maps flat ``(sym1, exp1, sym2, exp2)`` int keys to pool
  indices — the encoded ``sym`` already distinguishes terminal from rule,
  so the reference's nested ``("t"/"r", ref)`` ident tuples disappear.

The columns are deliberately Python lists, not numpy arrays: the kernel is
a scalar pointer-chasing loop, and per-element ``ndarray`` access measures
~3x slower than list indexing on the floor CPython (numpy views of the
pool are available via :meth:`Sequitur.columns` for vectorized export).

**The registration invariant.**  In the reference, ``_remove_digram(n)``
rebuilds n's digram key and drops the table entry only if it maps to n.
Three facts make that probe equivalent to an O(1) column access:

* a table entry always reflects a *current* adjacency — every link change
  goes through a join/delete that first probes the left node's digram, so
  a registered key never goes stale (equivalently: a node is registered
  under at most one key, and it is its current digram's key);
* entries are never overwritten while their owner is live — every
  registration site first misses on a lookup of the same key;
* equal-symbol digrams are never registered (the run-length merge branch
  fires before the registration branch), so a node whose exponent just
  changed is provably unregistered.

Hence ``_remove_digram(n)`` == ``if _reg[n] is not None: del digrams[
_reg[n]]; _reg[n] = None``, and the reference's probes of freshly-created
adjacencies (e.g. ``(p, n2)`` right after both deletions in
``_substitute``) are provably no-ops and elided.  Every elision below is
annotated with the reference call it collapses.  The parity fuzz suite
(tests/test_sequitur_kernel.py) is the enforcement mechanism for this
reasoning: any violation diverges the emitted grammar from the reference.

The kernel enforces the same three constraints in the same online order as
the reference, so the emitted grammar is **bit-identical**
(``Grammar.to_json`` equality — pinned by tests/test_sequitur_kernel.py
and the CI grammar-parity step).

**Recycling.**  Freed indices go to a limbo list and only become
allocatable at the next push boundary: within one push's constraint
cascade a freed index stays poisoned — never recycled — so an index
captured before churn behaves exactly like the reference's poisoned
``Node`` object instead of aliasing a new allocation.

**Batch entry points.**  ``push_runs(ids, counts)`` ingests an
RLE-collapsed stream and is bit-identical to the scalar push loop over the
expanded stream: run increments replay the reference's merge branch with
one dict probe instead of a full push (alloc + link + cascade), and a run
pushed right after a guard collapses to a single exponent addition.
``push_ids`` RLE-collapses (:func:`rle_runs`) and delegates.  ``push_run``
keeps the reference's O(1) bulk-repetition semantics -- used by the tracer
for collective-free ``lax.scan`` bodies with huge trip counts (note it is
*not* equivalent to ``count`` scalar pushes: a mid-run digram match that
scalar pushes would take is deliberately skipped, exactly as the reference
skips it).

Terminal ids must be >= 0 (negative ids are the rule-reference encoding).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def rle_runs(ids) -> tuple[list[int], list[int]]:
    """Collapse equal-adjacent ids into an RLE ``(ids, counts)`` pair.

    Vectorized pre-pass shared by :meth:`Sequitur.push_ids` and the
    columnar front end (``trace_ir.compress_store``): one
    ``np.flatnonzero(np.diff(...))`` instead of a per-token Python loop.
    """
    arr = np.asarray(ids, dtype=np.int64)
    if arr.size == 0:
        return [], []
    starts = np.concatenate(
        [np.zeros(1, dtype=np.int64), np.flatnonzero(np.diff(arr)) + 1])
    counts = np.diff(np.concatenate([starts, [arr.size]]))
    return arr[starts].tolist(), counts.tolist()


class Sequitur:
    """Online grammar builder enforcing constraints (1)-(3) on the flat pool."""

    KERNEL = "flat"

    __slots__ = ("_sym", "_exp", "_prev", "_next", "_reg", "_free", "_limbo",
                 "_rules", "_users", "digrams", "_next_rid")

    def __init__(self):
        # pool slot 0 is the main rule's guard (links to itself: empty body)
        self._sym: list = [None]
        self._exp: list = [0]          # guard exp slot = owning rule id
        self._prev: list = [0]
        self._next: list = [0]
        self._reg: list = [None]       # current digram-table key per node
        self._free: list[int] = []
        # freed during the current push's cascade; drained into _free at
        # the next push boundary (deferred recycling — see module docs)
        self._limbo: list[int] = []
        self._rules: dict[int, int] = {0: 0}       # rid -> guard index
        self._users: dict[int, set[int]] = {0: set()}
        self.digrams: dict[tuple, int] = {}
        self._next_rid = 1

    # -- public API ---------------------------------------------------------

    def push(self, sym: int) -> None:
        self.push_run(sym, 1)

    def push_run(self, sym: int, count: int) -> None:
        """Append an already run-length-compressed repetition in O(1)."""
        if count <= 0:
            return
        if sym < 0:
            raise ValueError(f"terminal ids must be >= 0, got {sym}")
        limbo = self._limbo
        if limbo:
            self._free.extend(limbo)
            del limbo[:]
        i = self._alloc(sym, count)
        prv, nxt = self._prev, self._next
        last = prv[0]
        nxt[last] = i
        prv[i] = last
        nxt[i] = 0
        prv[0] = i
        self._check(last)

    def push_many(self, syms: Iterable[int]) -> None:
        for s in syms:
            self.push_run(s, 1)

    def push_ids(self, ids) -> None:
        """Ingest a pre-interned terminal-id sequence (numpy array or list).

        RLE-collapses equal-adjacent ids (:func:`rle_runs`) and feeds
        :meth:`push_runs`; the grammar produced is bit-identical to
        ``push_many`` over the same sequence.
        """
        run_ids, counts = rle_runs(ids)
        self.push_runs(run_ids, counts)

    def push_runs(self, ids: Sequence[int], counts: Sequence[int]) -> None:
        """Push an RLE ``(ids, counts)`` stream, bit-identical to the
        scalar push loop over the expanded stream.

        This is the shared fast entry point for the columnar front end.
        The scalar push and its digram check are inlined (the new node's
        digram is always ``(tail, new)`` with exponent 1, so the general
        :meth:`_check` guard tests collapse away), and within a run each
        repetition replays exactly the reference's merge branch
        (constraint 3) — drop the tail's left-digram registration, bump
        the tail exponent, re-probe the left digram — without allocating
        and immediately freeing a pool node.  A mid-run digram match falls
        back to the general machinery, so matches fire in the same online
        order as scalar pushes.
        """
        sym, exp = self._sym, self._exp
        prv, nxt = self._prev, self._next
        reg, free = self._reg, self._free
        dig, limbo = self.digrams, self._limbo
        for a, k in zip(ids, counts):
            if a < 0:
                raise ValueError(f"terminal ids must be >= 0, got {a}")
            while k > 0:
                # scalar push of one `a` (the reference push_run(a, 1))
                if limbo:
                    free.extend(limbo)
                    del limbo[:]
                if free:
                    i = free.pop()
                    sym[i] = a
                    exp[i] = 1
                else:
                    i = len(sym)
                    sym.append(a)
                    exp.append(1)
                    prv.append(None)
                    nxt.append(None)
                    reg.append(None)
                last = prv[0]
                nxt[last] = i
                prv[i] = last
                nxt[i] = 0
                prv[0] = i
                k -= 1
                # inline _check(last): next[last] is the fresh node (a, 1)
                s1 = sym[last]
                if s1 is not None:          # last == guard -> nothing to do
                    if s1 == a:
                        self._check(last)   # rare: tail merged after churn
                    else:
                        key = (s1, exp[last], a, 1)
                        m = dig.get(key)
                        if m is None:
                            dig[key] = last
                            reg[last] = key
                        elif m != last and nxt[m] != last and m != i:
                            self._process_match(last, m)
                if k == 0:
                    break
                t = prv[0]
                if sym[t] != a:
                    continue            # tail restructured; push scalar again
                # fast increments: each iteration is the reference's merge
                # branch for (tail a^e, new a^1) + _check(tail.prev).  The
                # reference's probes of the (a^e', a^1) keys are elided —
                # equal-symbol digrams are never registered.
                p = prv[t]
                sp = sym[p]
                if sp is None:
                    # guard before tail: no left digram to maintain — the
                    # whole remaining run is one exponent addition
                    exp[t] += k
                    k = 0
                    continue
                ep = exp[p]
                while k > 0:
                    rk = reg[p]                 # _remove_digram(tail.prev)
                    if rk is not None:
                        del dig[rk]
                        reg[p] = None
                    e = exp[t] + 1
                    exp[t] = e
                    k -= 1
                    # _check(tail.prev) on the digram (p, tail)
                    key = (sp, ep, a, e)
                    m = dig.get(key)
                    if m is None:
                        dig[key] = p
                        reg[p] = key
                    elif m == p or nxt[m] == p or m == t:
                        pass                    # identical / overlapping
                    else:
                        self._process_match(p, m)
                        break           # structure changed; back to scalar

    def expand(self) -> list[int]:
        """Expand the grammar back into the original sequence (lossless)."""
        out: list[int] = []
        self._expand_rule(0, 1, out)
        return out

    def grammar_rules(self) -> dict[int, list[tuple]]:
        """Freeze to ``{rid: [(kind, ref, exp), ...]}`` with kind in {t, r}."""
        sym, exp, nxt = self._sym, self._exp, self._next
        out: dict[int, list[tuple]] = {}
        for rid, g in self._rules.items():
            body = []
            n = nxt[g]
            while n != g:
                s = sym[n]
                if s < 0:
                    body.append(("r", -s - 1, exp[n]))
                else:
                    body.append(("t", s, exp[n]))
                n = nxt[n]
            out[rid] = body
        return out

    def size(self) -> int:
        """Total number of symbol occurrences across all rules."""
        nxt = self._next
        total = 0
        for g in self._rules.values():
            n = nxt[g]
            while n != g:
                total += 1
                n = nxt[n]
        return total

    def columns(self) -> dict[str, np.ndarray]:
        """Numpy snapshot of the pool columns (``None`` -> -2**31 in
        ``sym``, -1 in the link columns) for vectorized inspection."""
        def col(xs, null):
            return np.asarray([null if x is None else x for x in xs],
                              dtype=np.int64)
        return {"sym": col(self._sym, -2**31),
                "exp": col(self._exp, 0),
                "prev": col(self._prev, -1),
                "next": col(self._next, -1)}

    # -- internals ----------------------------------------------------------
    #
    # Each mutation method performs the same digram-table operations, in
    # the same order, as the corresponding reference method — with removal
    # probes replaced by _reg accesses per the registration invariant, and
    # probes of freshly-created adjacencies elided (annotated inline).

    def _alloc(self, s, e) -> int:
        free = self._free
        if free:
            i = free.pop()
            self._sym[i] = s
            self._exp[i] = e
            # links stay poisoned (None) until joined, like a fresh Node
        else:
            i = len(self._sym)
            self._sym.append(s)
            self._exp.append(e)
            self._prev.append(None)
            self._next.append(None)
            self._reg.append(None)
        return i

    def _expand_rule(self, rid: int, times: int, out: list) -> None:
        sym, exp, nxt = self._sym, self._exp, self._next
        g = self._rules[rid]
        for _ in range(times):
            n = nxt[g]
            while n != g:
                s = sym[n]
                if s < 0:
                    self._expand_rule(-s - 1, exp[n], out)
                else:
                    out.extend([s] * exp[n])
                n = nxt[n]

    def _check(self, i) -> bool:
        """Enforce constraints on the digram (i, next[i]).

        Returns True if the grammar was modified.
        """
        if i is None:
            return False
        sym = self._sym
        s1 = sym[i]
        if s1 is None:                  # guard
            return False
        prv, nxt = self._prev, self._next
        j = nxt[i]
        if j is None:
            return False
        s2 = sym[j]
        if s2 is None:                  # next is guard
            return False

        exp, reg = self._exp, self._reg
        dig = self.digrams
        if s1 == s2:
            # constraint (3): run-length merge of adjacent equal symbols.
            # Reference sequence: _remove_digram(i.prev); _remove_digram(j);
            # i.exp += j.exp; _delete_node(j) — whose probes of (i, j)
            # under the merged exponent are elided (equal-symbol digrams
            # are never registered, so i is provably unregistered);
            # re-check both sides.
            p = prv[i]
            rk = reg[p]
            if rk is not None:
                del dig[rk]
                reg[p] = None
            rk = reg[j]
            if rk is not None:
                del dig[rk]
                reg[j] = None
            exp[i] += exp[j]
            n2 = nxt[j]
            nxt[i] = n2
            prv[n2] = i
            if s2 < 0:
                self._users[-s2 - 1].discard(j)
            prv[j] = nxt[j] = None      # poison
            self._limbo.append(j)
            # digrams around the merged node changed; re-check both sides
            self._check(p)
            self._check(i)
            return True

        key = (s1, exp[i], s2, exp[j])
        m = dig.get(key)
        if m is None:
            dig[key] = i
            reg[i] = key
            return False
        if m == i or nxt[m] == i or j == m:
            return False                # identical or overlapping occurrence
        self._process_match(i, m)
        return True

    def _process_match(self, node: int, match: int) -> None:
        sym, exp, prv, nxt = self._sym, self._exp, self._prev, self._next
        # _is_full_rule_body(match), inlined: prev is a guard and
        # next.next is a guard; the guard's exp slot is the owning rule id
        # (0 = main, which never substitutes).
        p = prv[match]
        if sym[p] is None and sym[nxt[nxt[match]]] is None and exp[p] != 0:
            self._substitute(node, exp[p])
            return
        p = prv[node]
        if sym[p] is None and sym[nxt[nxt[node]]] is None and exp[p] != 0:
            # the *new* digram is itself a full rule body; reuse it for the
            # match occurrence instead.
            self._substitute(match, exp[p])
            return
        new_rid = self._next_rid
        self._next_rid = new_rid + 1
        j = nxt[node]
        sn, en = sym[node], exp[node]
        sj, ej = sym[j], exp[j]
        reg, free = self._reg, self._free
        # three inline allocations: the new rule's guard + copies of the
        # matched digram's two symbols
        if free:
            g = free.pop()
            sym[g] = None
            exp[g] = new_rid
        else:
            g = len(sym)
            sym.append(None)
            exp.append(new_rid)
            prv.append(None)
            nxt.append(None)
            reg.append(None)
        self._rules[new_rid] = g
        self._users[new_rid] = set()
        if free:
            a = free.pop()
            sym[a] = sn
            exp[a] = en
        else:
            a = len(sym)
            sym.append(sn)
            exp.append(en)
            prv.append(None)
            nxt.append(None)
            reg.append(None)
        if free:
            b = free.pop()
            sym[b] = sj
            exp[b] = ej
        else:
            b = len(sym)
            sym.append(sj)
            exp.append(ej)
            prv.append(None)
            nxt.append(None)
            reg.append(None)
        # _insert_after(guard, a) + _insert_after(a, b), inlined: joins
        # against a guard or a fresh node never probe the digram table
        # (fresh nodes have poisoned links; guard digrams are skipped).
        if sn < 0:
            self._users[-sn - 1].add(a)
        if sj < 0:
            self._users[-sj - 1].add(b)
        nxt[a] = b
        prv[b] = a
        nxt[b] = g
        prv[g] = b
        nxt[g] = a
        prv[a] = g
        self._substitute(match, new_rid)
        self._substitute(node, new_rid)
        # Register the rule-body digram.  NB: a rule-utility inline during
        # the substitutions above may have spliced new bodies into the new
        # rule (poisoning ``a``), so consult the live body rather than the
        # captured indices.
        first = nxt[g]
        if first != g:
            second = nxt[first]
            if second != g:
                key = (sym[first], exp[first], sym[second], exp[second])
                dig = self.digrams
                cur = dig.get(key)
                if cur is None or prv[cur] is None:
                    dig[key] = first
                    reg[first] = key

    def _substitute(self, node: int, rid: int) -> None:
        """Replace the digram starting at ``node`` with one rule-use node.

        Reference sequence: _delete_node(node.next); _delete_node(node);
        insert a fresh rule use after the old prev; rule-utility checks on
        the removed symbols; boundary re-checks.  Registration drops, in
        reference probe order:

        * node (its digram is (node, j)) — _delete_node(j)'s
          _remove_digram(j.prev); join(node, j.next)'s re-probe elided;
        * j (digram (j, n2)) — _delete_node(j)'s _remove_digram(j);
        * p (digram (p, node)) — _delete_node(node)'s
          _remove_digram(node.prev); join(p, n2)'s re-probe elided;
        * _delete_node(node)'s probe of (node, n2) and join(p, use)'s
          probe of (p, n2) are elided: both adjacencies were created
          within this call, so neither node is registered for them.
        """
        sym, exp, prv, nxt = self._sym, self._exp, self._prev, self._next
        reg, free = self._reg, self._free
        dig, limbo = self.digrams, self._limbo
        p = prv[node]
        j = nxt[node]
        n2 = nxt[j]
        s1 = sym[node]
        s2 = sym[j]
        # -- _delete_node(j)
        rk = reg[node]
        if rk is not None:
            del dig[rk]
            reg[node] = None
        rk = reg[j]
        if rk is not None:
            del dig[rk]
            reg[j] = None
        nxt[node] = n2
        prv[n2] = node
        if s2 < 0:
            self._users[-s2 - 1].discard(j)
        prv[j] = nxt[j] = None
        limbo.append(j)
        # -- _delete_node(node)
        rk = reg[p]
        if rk is not None:
            del dig[rk]
            reg[p] = None
        nxt[p] = n2
        prv[n2] = p
        if s1 < 0:
            self._users[-s1 - 1].discard(node)
        prv[node] = nxt[node] = None
        limbo.append(node)
        # -- use = Node(rule, 1); _insert_after(p, use)
        ref = -rid - 1
        if free:
            use = free.pop()
            sym[use] = ref
            exp[use] = 1
        else:
            use = len(sym)
            sym.append(ref)
            exp.append(1)
            prv.append(None)
            nxt.append(None)
            reg.append(None)
        self._users[rid].add(use)
        nxt[use] = n2
        prv[n2] = use
        nxt[p] = use
        prv[use] = p
        # rule-utility bookkeeping for symbols we just removed (the
        # rid-membership and single-user gates of _maybe_inline are
        # pre-checked here so the common no-op skips the call)
        if s1 < 0:
            r1 = -s1 - 1
            if r1 != rid and r1 in self._rules \
                    and len(self._users[r1]) == 1:
                self._maybe_inline(r1)
        if s2 < 0:
            r2 = -s2 - 1
            if r2 != rid and r2 in self._rules \
                    and len(self._users[r2]) == 1:
                self._maybe_inline(r2)
        # -- if not _check(p): _check(use), with _check's common
        # miss-register branch inlined.  The inline calls above may have
        # restructured around p (deleted it, spliced between p and use);
        # specialize only when p's digram is still exactly (p, use),
        # otherwise take the general path the reference takes.
        sp = sym[p]
        if nxt[p] != use or sp is None or sp == sym[use]:
            if not self._check(p):
                self._check(use)
            return
        su, eu = sym[use], exp[use]
        key = (sp, exp[p], su, eu)
        m = dig.get(key)
        if m is None:
            dig[key] = p
            reg[p] = key
        elif m == p or nxt[m] == p or m == use:
            pass
        else:
            self._process_match(p, m)
            return
        # _check(use) on the digram (use, next[use]), same specialization
        nu = nxt[use]
        s3 = sym[nu]
        if s3 is None:
            return
        if su == s3:
            self._check(use)
            return
        k5 = (su, eu, s3, exp[nu])
        m2 = dig.get(k5)
        if m2 is None:
            dig[k5] = use
            reg[use] = k5
        elif m2 != use and nxt[m2] != use and nxt[use] != m2:
            self._process_match(use, m2)

    def _maybe_inline(self, rid: int) -> None:
        """Constraint (2): a rule used once with exponent 1 is inlined."""
        if rid == 0 or rid not in self._rules:
            return
        users = self._users[rid]
        if len(users) != 1:
            return
        (use,) = users
        sym, exp, prv, nxt = self._sym, self._exp, self._prev, self._next
        if prv[use] is None:            # poisoned node awaiting recycling
            users.discard(use)
            return
        if exp[use] != 1:
            return                      # keeps a loop body alive (RLE)
        reg, dig, limbo = self._reg, self.digrams, self._limbo
        p = prv[use]
        n = nxt[use]
        g = self._rules[rid]
        first, last = nxt[g], prv[g]
        # -- _delete_node(use): drop p's (p, use) and use's (use, n)
        # registrations; join(p, n)'s re-probe of (p, use) elided
        rk = reg[p]
        if rk is not None:
            del dig[rk]
            reg[p] = None
        rk = reg[use]
        if rk is not None:
            del dig[rk]
            reg[use] = None
        nxt[p] = n
        prv[n] = p
        users.discard(use)
        prv[use] = nxt[use] = None
        limbo.append(use)
        if first == g:                  # empty rule body; just drop the use
            del self._rules[rid]
            prv[g] = nxt[g] = None
            limbo.append(g)
            return
        # -- splice the body in place (nodes keep their digram
        # registrations).  join(p, first)'s probe of (p, n) is elided —
        # that adjacency was created by the delete above, so p is
        # unregistered; join(last, n)'s probe of (last, guard) is a guard
        # digram, never registered.
        nxt[p] = first
        prv[first] = p
        nxt[last] = n
        prv[n] = last
        del self._rules[rid]
        prv[g] = nxt[g] = None
        limbo.append(g)
        # boundary digrams are new
        if not self._check(p):
            self._check(last)

    # -- debugging ----------------------------------------------------------

    def dump(self) -> str:
        sym, exp, nxt = self._sym, self._exp, self._next
        lines = []
        for rid in sorted(self._rules):
            g = self._rules[rid]
            parts = []
            n = nxt[g]
            while n != g:
                s = sym[n]
                rep = f"R{-s - 1}" if s < 0 else str(s)
                parts.append(f"{rep}^{exp[n]}" if exp[n] != 1 else rep)
                n = nxt[n]
            lines.append(f"R{rid} -> {' '.join(parts)}")
        return "\n".join(lines)


def compress(seq: Iterable[int]) -> Sequitur:
    s = Sequitur()
    s.push_many(seq)
    return s

"""Program-table lowering: grammar-shaped replay (paper §2.7).

Port of :mod:`repro.core.progtable`.  A generated module ships the grammar
itself — terminal descriptors plus rule bodies as ``(opcode, ref,
exponent)`` tuples — and :class:`ProgramTable` maps it onto replay code:

* a symbol with exponent ``n`` replays through
  :func:`repro_torch.core.replay.rep` — unrolled up to
  :data:`~repro_torch.core.replay.REP_UNROLL_THRESHOLD`, a counted loop above
  it (one walk of the body, whatever n);
* a symbol sequence is a Python loop over its symbols.  The reference lowers
  a long sequence that reuses symbols to a ``lax.scan`` over a constant
  opcode array with ``lax.switch`` dispatch, which keeps its jaxpr small;
  eager PyTorch has no staged program to keep small, and a switch would make
  the same calls in the same order, so the port has no such lowering.  The
  walker charges nothing for the Python loop, as the reference's exact-cond
  walker charges nothing for its switch;
* nested rules lower children-first, so rule exponents become nested loops.

Comm terminals keep their exact traced parameters (the collective schedule
stays lossless).
"""
from __future__ import annotations

from typing import Mapping, Sequence

from repro_torch.core import blocks
from repro_torch.core import noise as noise_mod
from repro_torch.core.replay import rep


def topo_order(rules: Mapping[int, Sequence]) -> list[int]:
    """Children-first ordering of rule ids (deterministic)."""
    seen: set[int] = set()
    out: list[int] = []

    def visit(rid: int) -> None:
        if rid in seen:
            return
        seen.add(rid)
        for kind, ref, _ in rules[rid]:
            if kind == "r":
                visit(ref)
        out.append(rid)

    for rid in sorted(rules):
        visit(rid)
    return out


def expand_symbols(seq: Sequence, rules: Mapping[int, Sequence]) -> list[int]:
    """Symbolic expansion of a symbol sequence to its terminal-id stream.

    This is the comm-sequence oracle for compiled modules: expanding the
    emitted tables must reproduce ``MergedProgram.expand_rank`` exactly
    (losslessness survives the lowering), without executing anything.
    """
    out: list[int] = []

    def go(symbols: Sequence) -> None:
        for kind, ref, exp in symbols:
            if kind == "t":
                out.extend([int(ref)] * int(exp))
            else:
                for _ in range(int(exp)):
                    go(rules[ref])

    go(seq)
    return out


class ProgramTable:
    """Executable lowering of a generated module's grammar tables.

    ``terminals[gid]`` is ``("comm", buf_name, params_dict)`` or
    ``("compute", x_tuple, unroll)``; ``rules[rid]`` is a tuple of
    ``(kind, ref, exp)`` symbols; ``programs[gi]`` is signature group
    ``gi``'s flattened (guard-resolved) symbol sequence.  All lowered
    callables take ``(st, comm)`` and return the new state, exactly like
    the unrolled emitter's functions — the replay engine cannot tell the
    flavors apart.
    """

    def __init__(self, terminals: Sequence, rules: Mapping[int, Sequence],
                 programs: Sequence, noise: Sequence | None = None):
        self.terminals = tuple(tuple(t) for t in terminals)
        self.rules = {int(rid): tuple(tuple(s) for s in body)
                      for rid, body in dict(rules).items()}
        self.programs = tuple(tuple(tuple(s) for s in seq)
                              for seq in programs)
        # Per-terminal (sigma, shift) noise params (the module's
        # NOISE_MODELS table), lowered once; perturb is the identity unless
        # the replay state carries the noise key.
        if noise is not None:
            self._noise = noise_mod.lower_params(noise, self.terminals)
        else:
            self._noise = (None,) * len(self.terminals)
        self._term_fns = [self._lower_terminal(t, nz) for t, nz
                          in zip(self.terminals, self._noise)]
        self._rule_fns: dict[int, object] = {}
        for rid in topo_order(self.rules):
            self._rule_fns[rid] = self._lower_seq(self.rules[rid])
        self._prog_fns = [self._lower_seq(seq) for seq in self.programs]

    # -- terminal lowering -----------------------------------------------------

    @staticmethod
    def _lower_terminal(desc, nz=None):
        kind = desc[0]
        if kind == "comm":
            _, buf, params = desc
            params = dict(params)

            def comm_fn(st, comm, _buf=buf, _p=params, _nz=nz):
                return noise_mod.perturb(comm.do(st, _buf, **_p), _nz)

            return comm_fn
        if kind == "compute":
            _, x, unroll = desc
            x = tuple(int(v) for v in x)
            unroll = int(unroll)

            def compute_fn(st, comm, _x=x, _u=unroll, _nz=nz):
                return noise_mod.perturb(blocks.run_combo(st, _x, unroll=_u),
                                         _nz)

            return compute_fn
        raise ValueError(f"unknown terminal kind: {kind!r}")

    # -- sequence lowering -----------------------------------------------------

    def _callee(self, kind: str, ref: int):
        return self._term_fns[ref] if kind == "t" else self._rule_fns[ref]

    def _lower_seq(self, seq: Sequence):
        """Lower one symbol sequence to a ``(st, comm) -> st`` callable."""
        run = tuple((self._callee(kind, int(ref)), int(exp))
                    for kind, ref, exp in seq)

        def straight(st, comm, _run=run):
            for fn, e in _run:
                st = rep(fn, e, st, comm)
            return st

        return straight

    # -- execution + introspection ---------------------------------------------

    def run(self, gi: int, st: dict, comm) -> dict:
        """Execute signature group ``gi``'s program."""
        return self._prog_fns[gi](st, comm)

    def expand(self, gi: int) -> list[int]:
        """Terminal-id stream of group ``gi`` (symbolic, no execution)."""
        return expand_symbols(self.programs[gi], self.rules)

"""The port's program-table lowering: a lowered program replays the
expanded terminal sequence in order, and its walker cost is that of the
terminals it expands to."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import blocks
from repro_torch.core.progtable import ProgramTable, expand_symbols
from repro_torch.core.tracer import compute_cost
from repro_torch.sharding.collectives import LocalSim


def _compute_desc(i: int, unroll: int = 1):
    x = [0] * 11
    x[i] = 1
    x[10] = 1 + i   # x11 covers the block-turn budget sum(x1..9)
    return ("compute", tuple(x), unroll)


TERMS = [_compute_desc(0), _compute_desc(2), _compute_desc(6, unroll=2)]
RULES = {0: (("t", 0, 2), ("t", 1, 1)), 1: (("r", 0, 5), ("t", 2, 1))}
PROGRAMS = {
    "short": (("t", 0, 1), ("t", 1, 1)),
    "reused": tuple([("r", 0, 2), ("t", 1, 1)] * 3),
    "counted": (("t", 2, 6), ("r", 1, 7), ("t", 0, 1)),
    "empty": (),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_table_executes_like_manual_expansion(name):
    prog = PROGRAMS[name]
    pt = ProgramTable(TERMS, RULES, [prog])
    got = pt.run(0, blocks.init_state(0, "cpu"), LocalSim())
    want = blocks.init_state(0, "cpu")
    for gid in expand_symbols(prog, RULES):
        _, x, unroll = TERMS[gid]
        want = blocks.run_combo(want, x, unroll=unroll)
    assert pt.expand(0) == expand_symbols(prog, RULES)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_table_walker_cost_is_its_terminals(name):
    """Unrolled symbols cost their terminals; a counted loop (exponent above
    REP_UNROLL_THRESHOLD) adds one loop turn (column 11 of B) per trip."""
    prog = PROGRAMS[name]
    pt = ProgramTable(TERMS, RULES, [prog])
    got = compute_cost(lambda s: pt.run(0, s, LocalSim()),
                       blocks.init_state(0, "cpu"))
    want = np.zeros_like(got)
    for gid in expand_symbols(prog, RULES):
        _, x, unroll = TERMS[gid]
        want += blocks.combo_cost(x, unroll)
    turn = blocks.calibration_matrix()[:, 10]

    def loop_turns(symbols, mult):
        n = 0
        for kind, ref, exp in symbols:
            if exp > 4:
                n += mult * exp
            if kind == "r":
                n += loop_turns(RULES[ref], mult * exp)
        return n

    want += loop_turns(prog, 1) * turn
    np.testing.assert_array_equal(got, want)

"""Synthetic rank traces for the port's end-to-end runs.

The port's own copy of ``benchmarks/synthesize_time.py:_synthetic_traces``
(the benchmarks import the JAX package, the port must not): a halo-exchange
style SPMD loop of ``reps`` steps, each two compute events (eight close
variants that cluster into one terminal), a float32 psum and a bf16 ring
ppermute; every 16th rank ends with one extra psum, which splits the ranks
into two signature groups.  At 64 ranks it is 51,204 events.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.events import CommEvent, ComputeEvent, Event


def synthetic_rank_traces(n_ranks: int = 64, reps: int = 200,
                          ) -> list[list[Event]]:
    comm = CommEvent("psum", (16,), "float32", ("x",))
    perm = CommEvent("ppermute", (4, 4), "bfloat16", ("x",), ("shift", 1))
    base = np.array([2.1e7, 3.3e5, 1.1e7, 8.2e3, 0., 0.])
    comps = [ComputeEvent(tuple(base * (1 + 0.004 * i))) for i in range(8)]
    traces = []
    for r in range(n_ranks):
        tr = []
        for i in range(reps):
            tr += [comps[i % 8], comm, comps[(i + 3) % 8], perm]
        if r % 16 == 0:
            tr = tr + [comm]
        traces.append(tr)
    return traces

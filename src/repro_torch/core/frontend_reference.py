"""Pre-columnar per-event synthesis front end — kept as the parity oracle.

Port copy of :mod:`repro.core.frontend_reference`, kept line for line; it
runs on the port's own ``events``, ``grammar``, ``interproc`` and
:mod:`repro_torch.core.sequitur_reference`, and ``repro_torch`` imports
nothing from ``repro``.

This module preserves, verbatim, the event-loop implementations that
:mod:`repro_torch.core.trace_ir` replaced: per-event log-space
clustering and the per-rank intern+Sequitur grammar build.  It exists for
two reasons:

* **bit-exactness tests** — the columnar pipeline must produce the same
  grammar rules, terminal keys, compression ratio, and δ̄ as this code on
  every workload (``tests/test_torch_oracles.py`` pins that);
* **benchmarking** — the reference's ``benchmarks/synthesize_time.py``
  times its columnar front end against its copy of this baseline.

Do not use it in production paths; it is O(python) per event.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.events import ComputeEvent, Event, is_comm
from repro_torch.core.grammar import Grammar, TerminalTable, from_sequitur
from repro_torch.core.interproc import MergedProgram, merge_grammars
# the reference front end runs on the reference Sequitur: both oracles
# stay per-event/object-graph implementations, independent of the flat
# kernel they pin
from repro_torch.core.sequitur_reference import Sequitur


def _quantize(vec: np.ndarray, rel_tol: float) -> tuple[int, ...]:
    """Per-event log-space bucketing (the scalar original)."""
    width = math.log1p(rel_tol)
    out = []
    for v in vec:
        if v <= 0:
            out.append(-1)
        else:
            out.append(int(math.floor(math.log(v + 1.0) / width)))
    return tuple(out)


def cluster_compute_events_reference(
    events: Iterable[ComputeEvent], rel_tol: float = 0.05
) -> tuple[list[ComputeEvent], dict[int, np.ndarray]]:
    """The per-event clustering loop (pre-columnar original)."""
    buckets: dict[tuple[int, ...], int] = {}
    sums: dict[int, np.ndarray] = {}
    counts: dict[int, int] = {}
    assigned: list[tuple[ComputeEvent, int]] = []
    for ev in events:
        q = _quantize(ev.vector, rel_tol)
        if q not in buckets:
            buckets[q] = len(buckets)
        bid = buckets[q]
        sums[bid] = sums.get(bid, 0) + ev.vector
        counts[bid] = counts.get(bid, 0) + 1
        assigned.append((ev, bid))

    bids = sorted(sums)
    bucket_rep = {b: sums[b] / counts[b] for b in bids}
    remap: dict[int, int] = {}
    cluster_reps: list[np.ndarray] = []
    cluster_w: list[int] = []
    for b in bids:
        v = bucket_rep[b]
        placed = False
        for cid, rep in enumerate(cluster_reps):
            denom = np.maximum(np.maximum(np.abs(rep), np.abs(v)), 1e-30)
            if np.all(np.abs(rep - v) / denom <= rel_tol):
                w = cluster_w[cid]
                cluster_reps[cid] = (rep * w + v * counts[b]) / (w + counts[b])
                cluster_w[cid] = w + counts[b]
                remap[b] = cid
                placed = True
                break
        if not placed:
            remap[b] = len(cluster_reps)
            cluster_reps.append(v.copy())
            cluster_w.append(counts[b])

    out = [dataclasses.replace(ev, cluster_id=remap[bid])
           for ev, bid in assigned]
    reps = {cid: rep for cid, rep in enumerate(cluster_reps)}
    return out, reps


def compress_rank_traces_reference(
    rank_traces: Sequence[Sequence[Event]],
    rel_tol: float = 0.05,
    threshold: float = 0.5,
) -> tuple[list[Grammar], MergedProgram, list[list[int]], dict[int, np.ndarray]]:
    """The per-event intern+push grammar build (pre-columnar original):
    one TerminalTable/Sequitur per rank, one ``intern``+``push`` per event.
    """
    flat: list[ComputeEvent] = []
    index: list[list[int]] = []
    for tr in rank_traces:
        idx = []
        for ev in tr:
            if not is_comm(ev):
                idx.append(len(flat))
                flat.append(ev)
            else:
                idx.append(-1)
        index.append(idx)
    clustered, reps = cluster_compute_events_reference(flat, rel_tol)

    grammars: list[Grammar] = []
    rank_ids: list[list[int]] = []
    for tr, idx in zip(rank_traces, index):
        table = TerminalTable()
        seq = Sequitur()
        ids = []
        for ev, fi in zip(tr, idx):
            ev2 = clustered[fi] if fi >= 0 else ev
            tid = table.intern(ev2)
            ids.append(tid)
            seq.push(tid)
        grammars.append(from_sequitur(seq, table))
        rank_ids.append(ids)
    merged = merge_grammars(grammars, threshold)
    return grammars, merged, rank_ids, reps

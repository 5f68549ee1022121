"""Replay comm backends for generated proxy-apps (port of
:mod:`repro.sharding.collectives`, ``LocalSim`` only).

The mesh backend (``DeviceComm`` over ``torch.distributed``) and the
instrumented collective wrappers that record into a trace session are not
ported yet.
"""
from __future__ import annotations


class LocalSim:
    """Single-host replay: each collective is a sequence point.

    The reference pins the pool buffer with ``optimization_barrier`` so XLA
    cannot reorder the replay across the call.  Eager PyTorch already runs
    every op in program order on one stream, so the sequence point needs no
    op at all: ``do`` returns the state unchanged and costs nothing in the
    walker, as the barrier costs nothing in the reference's.  Shape-agnostic,
    so it serves a batch of stacked rank states as well as one state.

    ``trace_events`` counts ``do`` calls.
    """

    def __init__(self):
        self.trace_events = 0

    def do(self, st: dict, buf: str, *, kind: str, axes, detail, shape, dtype):
        self.trace_events += 1
        if buf not in st:
            raise KeyError(f"comm buffer {buf!r} missing from the replay state")
        return dict(st)

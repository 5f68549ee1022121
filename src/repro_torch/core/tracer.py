"""Cost walker over PyTorch programs (port of :mod:`repro.core.tracer`).

The reference walks a jaxpr.  PyTorch has no staged program to walk, so the
port runs the program on ``device="meta"`` (shapes only, nothing executes)
under :class:`CostWalker`, a ``TorchDispatchMode`` that charges every aten
op by the rules of :func:`repro_torch.core.metrics.op_cost`.

Loops are where a dispatch-level walker and a jaxpr walker differ: Python
runs a loop's body ``n`` times, a jaxpr holds it once.  The port's loop
helpers close that gap and reproduce ``_walk_scan``:

* :func:`counted_loop` is ``lax.fori_loop`` with a static trip count: under
  the walker it runs its body once and charges ``n`` times the body plus
  the loop counter's add (vpu 1, 12 bytes) plus ``n`` scan steps;
* :func:`scan_loop` is ``lax.scan`` with no xs: the same without the
  counter;
* outside the walker both are plain Python loops.

Python control flow is resolved eagerly, which is what the reference's
``exact_cond`` mode achieves by constant propagation: the loop over a
symbol sequence in :mod:`repro_torch.core.progtable` charges nothing for
itself, exactly like the reference's per-iteration walk of a switch-scan.

The collective-instrumented front end (``TraceSession``, per-collective
recording inside traced user programs) is not ported yet; the walker
records compute only.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.core.events import (
    CommEvent, ComputeEvent, Event, N_METRICS, is_comm,
)
from repro_torch.core.metrics import I_BYTES, I_SCAN, I_VPU, op_cost

#: cost of one ``fori_loop`` turn's counter update (``add i 1`` on int32:
#: one element op, three 4-byte operands) — the reference's B[:, 10]
_COUNTER = np.zeros(N_METRICS)
_COUNTER[I_VPU] = 1
_COUNTER[I_BYTES] = 12

_TLS = threading.local()


@dataclasses.dataclass
class Trace:
    """A template trace: one SPMD event stream plus mesh-axis metadata."""
    events: list[Event]
    axis_sizes: dict[str, int]

    def comm_events(self) -> list[CommEvent]:
        return [e for e in self.events if is_comm(e)]

    def compute_events(self) -> list[ComputeEvent]:
        return [e for e in self.events if not is_comm(e)]

    def total_compute(self) -> np.ndarray:
        vec = np.zeros(N_METRICS)
        for e in self.compute_events():
            vec += e.vector
        return vec


class CostWalker(TorchDispatchMode):
    """Charges each dispatched aten op into ``pending`` (a 6-vector)."""

    def __init__(self):
        super().__init__()
        self.pending = np.zeros(N_METRICS, dtype=np.float64)
        self.events: list[Event] = []

    def __enter__(self):
        stack = getattr(_TLS, "walkers", None)
        if stack is None:
            stack = _TLS.walkers = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _TLS.walkers.pop()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.pending += op_cost(func, args, kwargs, out)
        return out

    def flush(self) -> None:
        if self.pending.any():
            self.events.append(ComputeEvent(tuple(self.pending)))
            self.pending = np.zeros(N_METRICS, dtype=np.float64)

    def body_cost(self, fn: Callable):
        """Run ``fn`` once and return ``(its cost, its result)`` without
        charging it (the caller charges a multiple)."""
        saved = self.pending
        self.pending = np.zeros(N_METRICS, dtype=np.float64)
        try:
            out = fn()
            cost = self.pending
        finally:
            self.pending = saved
        return cost, out


def active_walker() -> CostWalker | None:
    stack = getattr(_TLS, "walkers", None)
    return stack[-1] if stack else None


def counted_loop(n: int, body: Callable, carry):
    """``carry = body(carry)``, ``n`` times: ``lax.fori_loop(0, n, ...)``.

    Under the walker: one walk of the body, charged ``n`` times together
    with the counter's add and ``n`` scan steps."""
    n = int(n)
    w = active_walker()
    if w is None:
        for _ in range(n):
            carry = body(carry)
        return carry
    if n <= 0:
        return carry
    cost, carry = w.body_cost(lambda: body(carry))
    w.pending += (cost + _COUNTER) * n
    w.pending[I_SCAN] += n
    return carry


def scan_loop(n: int, body: Callable, carry):
    """``carry = body(carry)``, ``n`` times: ``lax.scan`` with no xs (no
    counter).  Under the walker: body × n plus ``n`` scan steps."""
    n = int(n)
    w = active_walker()
    if w is None:
        for _ in range(n):
            carry = body(carry)
        return carry
    if n <= 0:
        return carry
    cost, carry = w.body_cost(lambda: body(carry))
    w.pending += cost * n
    w.pending[I_SCAN] += n
    return carry


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def trace_fn(fn: Callable, *args, axis_sizes: dict[str, int] | None = None,
             **kwargs) -> Trace:
    """Walk ``fn(*args, **kwargs)`` into a template event stream.

    Tensor arguments (nested in dicts, lists or tuples) are replaced by
    meta tensors of the same shape and dtype, so nothing is allocated or
    computed and any device's tensors may be passed."""
    args = tree_map(_to_meta, args)
    kwargs = tree_map(_to_meta, kwargs)
    w = CostWalker()
    with w:
        fn(*args, **kwargs)
    w.flush()
    return Trace(w.events, dict(axis_sizes or {}))


def compute_cost(fn: Callable, *args, **kwargs) -> np.ndarray:
    """Total 6-metric cost of a collective-free callable (block calibration)."""
    return trace_fn(fn, *args, **kwargs).total_compute()

"""Event tracing front end: the cost walker over PyTorch programs and the
host-level recorder (port of :mod:`repro.core.tracer`).

The reference walks a jaxpr.  PyTorch has no staged program to walk, so the
port runs the program on ``device="meta"`` (shapes only, nothing executes)
under :class:`CostWalker`, a ``TorchDispatchMode`` that charges every aten
op by the rules of :func:`repro_torch.core.metrics.op_cost`.  The
instrumented collectives of :mod:`repro_torch.sharding.collectives` are the
jaxpr's collective equations: under the walker each one closes the pending
compute into a :class:`ComputeEvent` and appends its :class:`CommEvent`, so
:func:`trace_fn` of a per-rank program gives the reference's template
stream, and :func:`per_rank_traces` / :func:`trace_fn_store` specialise it
per rank.  :class:`TraceSession` is the host-level recorder for drivers
whose ranks differ in Python (pipeline schedules, the scenario zoo).

Loops are where a dispatch-level walker and a jaxpr walker differ: Python
runs a loop's body ``n`` times, a jaxpr holds it once.  The port's loop
helpers close that gap and reproduce ``_walk_scan``:

* :func:`counted_loop` is ``lax.fori_loop`` with a static trip count,
  :func:`scan_loop` is ``lax.scan`` (with ``xs``: over the leading dim of
  stacked leaves, optionally stacking per-turn outputs as ``ys``);
* a body that emits a collective is walked once per turn (the exact event
  sequence, no scan steps), as the reference walks such a scan;
* a collective-free body runs once and is charged ``n`` times, plus ``n``
  scan steps (and, for ``counted_loop``, the counter's add each turn);
* slicing ``xs`` and stacking ``ys`` cost nothing, as a scan's xs and ys
  cost nothing in the reference;
* where autograd needs every turn's graph (an input requires grad), every
  turn runs and is charged, and the backward of the xs slices charges one
  scan step a turn, as the reference's transposed scan does;
* outside the walker they are plain Python loops.

Python control flow is resolved eagerly, which is what the reference's
``exact_cond`` mode achieves by constant propagation: the loop over a
symbol sequence in :mod:`repro_torch.core.progtable` charges nothing for
itself, exactly like the reference's per-iteration walk of a switch-scan.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterable

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.core.events import (
    CommEvent, ComputeEvent, Event, N_METRICS, encode_relative_perm, is_comm,
)
from repro_torch.core.metrics import (
    I_BYTES, I_GATHER, I_SCAN, I_VPU, dot_cost, op_cost, repeat_cost,
    reshape_cost, tensor_bytes,
)

#: cost of one ``fori_loop`` turn's counter update (``add i 1`` on int32:
#: one element op, three 4-byte operands) — the reference's B[:, 10]
_COUNTER = np.zeros(N_METRICS)
_COUNTER[I_VPU] = 1
_COUNTER[I_BYTES] = 12
_NO_COST = np.zeros(N_METRICS)

_TLS = threading.local()


@dataclasses.dataclass
class Trace:
    """A template trace: one SPMD event stream plus mesh-axis metadata.

    ``ppermute`` events carry their raw permutation; :func:`per_rank_traces`
    specializes them into per-rank relative-encoded events."""
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

    def total_comm_bytes(self) -> int:
        return sum(e.payload_bytes for e in self.comm_events())

    def compute_metrics_array(self) -> np.ndarray:
        """``(n_compute_events, 6)`` float64 metric rows in stream order."""
        rows = [e.metrics for e in self.compute_events()]
        if not rows:
            return np.zeros((0, N_METRICS))
        return np.asarray(rows, dtype=np.float64)


#: torch functions the walker charges as one jaxpr equation
_FUNC_COSTS = {
    "matmul": lambda args, out: dot_cost("matmul", args, out),
    "__matmul__": lambda args, out: dot_cost("matmul", args, out),
    "einsum": lambda args, out: dot_cost("einsum", args, out),
    "reshape": lambda args, out: reshape_cost(out),
    "repeat_interleave": lambda args, out: (
        repeat_cost(args[0], out) if isinstance(args[1], int) else None),
}


class _FunctionCost(TorchFunctionMode):
    """Charges a matrix product or a reshape at the function level
    (:func:`~repro_torch.core.metrics.dot_cost`, ``reshape_cost``) and the
    aten ops it decomposes into nothing."""

    def __init__(self, walker: "CostWalker"):
        super().__init__()
        self.walker = walker

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        w = self.walker
        rule = _FUNC_COSTS.get(getattr(func, "__name__", ""))
        if rule is None or w._paused:
            return func(*args, **kwargs)
        before = w.pending.copy()
        out = func(*args, **kwargs)
        cost = rule(args, out)
        if cost is not None:
            w.pending = before + cost
        return out


class CostWalker(TorchDispatchMode):
    """Charges each dispatched aten op into ``pending`` (a 6-vector);
    :meth:`emit_comm` closes it into a compute event before a collective.
    ``axis_sizes`` are the mesh axes the traced program's collectives
    name (the shapes of their per-rank outputs read them)."""

    def __init__(self, axis_sizes: dict[str, int] | None = None):
        super().__init__()
        self.pending = np.zeros(N_METRICS, dtype=np.float64)
        self.events: list[Event] = []
        self.axis_sizes: dict[str, int] = dict(axis_sizes or {})
        self._paused = 0
        self._funcs = _FunctionCost(self)

    def __enter__(self):
        stack = getattr(_TLS, "walkers", None)
        if stack is None:
            stack = _TLS.walkers = []
        stack.append(self)
        self._funcs.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        _TLS.walkers.pop()
        out = super().__exit__(*exc)
        self._funcs.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self.pending += op_cost(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def uncharged(self):
        """Ops dispatched inside cost nothing: a scan's xs slices and ys
        stacking, which the reference's walker never sees as equations."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def flush(self) -> None:
        if self.pending.any():
            self.events.append(ComputeEvent(tuple(self.pending)))
            self.pending = np.zeros(N_METRICS, dtype=np.float64)

    def emit_comm(self, ev: CommEvent) -> None:
        self.flush()
        self.events.append(ev)


def active_walker() -> CostWalker | None:
    stack = getattr(_TLS, "walkers", None)
    return stack[-1] if stack else None


def uncharged():
    """Context in which dispatched ops cost nothing under the active walker
    (a scan's ys written into stacked buffers in place); a no-op outside."""
    w = active_walker()
    return w.uncharged() if w is not None else contextlib.nullcontext()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _needs_grad(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in _tensors(tree))


class _Unstack(torch.autograd.Function):
    """The n slices of a stacked leaf as one autograd node whose backward
    stacks their gradients, both uncharged: a scan's xs and the transpose's
    ys, which the reference's walker sees as no equation.  The first such
    backward of a loop charges its n turns of the transposed scan
    (``steps``, shared by the loop's leaves)."""

    @staticmethod
    def forward(ctx, walker, steps, x):
        ctx.walker, ctx.steps = walker, steps
        ctx.set_materialize_grads(False)
        with walker.uncharged():
            return tuple(t.clone() for t in x.unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        if ctx.steps[0]:
            ctx.walker.pending[I_SCAN] += ctx.steps[0]
            ctx.steps[0] = 0
        with ctx.walker.uncharged():
            like = next((g for g in grads if g is not None), None)
            if like is None:
                return None, None, None
            return None, None, torch.stack([
                torch.zeros_like(like) if g is None else g for g in grads])


def _unstack(xs, n: int, walker: CostWalker | None, grad: bool) -> list:
    """``xs`` (a tree of leaves stacked on dim 0) as ``n`` per-turn trees.
    One ``unbind`` a leaf (views, no copies) outside the walker; uncharged
    under it."""
    leaves, spec = tree_flatten(xs)
    cols = []
    steps = [n]
    for t in leaves:
        if walker is None:
            cols.append(list(torch.unbind(t, 0)))
        elif grad and t.requires_grad:
            with walker.uncharged():
                cols.append(list(_Unstack.apply(walker, steps, t)))
        else:
            with walker.uncharged():
                cols.append(list(torch.unbind(t, 0)))
    if any(len(c) != n for c in cols):
        raise ValueError(f"scan_loop: xs leaves of leading dims "
                         f"{[len(c) for c in cols]}, want {n}")
    return [tree_unflatten([c[i] for c in cols], spec) for i in range(n)]


def _stack_ys(ys: list, n: int, walker: CostWalker | None):
    """Per-turn outputs stacked on a new leading dim of ``n`` (uncharged
    under the walker, where a walked-once body gave one turn's)."""
    if walker is None:
        return tree_map(lambda *t: torch.stack(t), *ys)
    with walker.uncharged():
        if len(ys) == n:
            return tree_map(lambda *t: torch.stack(t), *ys)
        return tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), ys[0])


def _loop(n: int, body: Callable, carry, xs, per_turn: np.ndarray,
          stack_ys: bool):
    """The engine of :func:`counted_loop` and :func:`scan_loop`."""
    n = int(n)
    w = active_walker()
    grad = _needs_grad(carry, xs)
    xs_t = None if xs is None else _unstack(xs, n, w, grad)
    ys: list = []

    def turn(i, c):
        out = body(c) if xs_t is None else body(c, xs_t[i])
        if stack_ys:
            c, y = out
            ys.append(y)
            return c
        return out

    def done(c):
        return (c, _stack_ys(ys, n, w)) if stack_ys else c

    if w is None or n <= 0:
        for i in range(n):
            carry = turn(i, carry)
        if stack_ys and n <= 0:
            raise ValueError("scan_loop: stack_ys needs at least one turn")
        return done(carry)
    n_ev = len(w.events)
    saved = w.pending
    w.pending = per_turn.copy()
    carry = turn(0, carry)
    if len(w.events) == n_ev and not grad:
        # collective-free: one walk, charged n times, n scan steps
        w.pending = saved + w.pending * n
        w.pending[I_SCAN] += n
        return done(carry)
    if len(w.events) > n_ev:
        # the body emitted: fold what was pending before the loop into the
        # compute ahead of its first collective, then walk every turn
        if saved.any():
            first = w.events[n_ev]
            if is_comm(first):
                w.events.insert(n_ev, ComputeEvent(tuple(saved)))
            else:
                w.events[n_ev] = ComputeEvent(tuple(saved + first.vector))
        for i in range(1, n):
            w.pending += per_turn
            carry = turn(i, carry)
        return done(carry)
    # collective-free, and autograd needs every turn's graph; the backward
    # of the xs slices (_Unstack) charges the transposed scan's turns
    w.pending = saved + w.pending
    for i in range(1, n):
        w.pending += per_turn
        carry = turn(i, carry)
    w.pending[I_SCAN] += n
    return done(carry)


def counted_loop(n: int, body: Callable, carry):
    """``carry = body(carry)``, ``n`` times: ``lax.fori_loop(0, n, ...)``.

    Under the walker: ``scan_loop``'s rules, plus the counter's add each
    turn."""
    return _loop(n, body, carry, None, _COUNTER, False)


def scan_loop(n: int, body: Callable, carry, xs=None, *,
              stack_ys: bool = False):
    """``lax.scan`` of ``n`` turns.  Without ``xs``: ``carry = body(carry)``;
    with ``xs`` (a tree of tensors stacked on dim 0, ``n`` long):
    ``carry = body(carry, x_i)``.  With ``stack_ys`` the body returns
    ``(carry, y)`` and the loop ``(carry, ys)``, the y's stacked on a new
    dim 0.  Under the walker see the module docstring."""
    return _loop(n, body, carry, xs, _NO_COST, stack_ys)


#: jnp's clamp of a traced start index (``lt``, ``add``, ``select_n`` on
#: int32 scalars) that ``lax.dynamic_slice`` and its update add
_START_COST = np.zeros(N_METRICS)
_START_COST[I_VPU] = 3
_START_COST[I_BYTES] = 9 + 12 + 13


def _start(start) -> tuple[int, np.ndarray]:
    """A start index (a Python int, or a 0-d int tensor: traced) as an int
    (0 on meta, where no value exists) and what normalising it costs."""
    if isinstance(start, torch.Tensor):
        return (0 if start.device.type == "meta" else int(start)), _START_COST
    return int(start), _NO_COST


def _index_cost(x: torch.Tensor, update: torch.Tensor | None,
                out: torch.Tensor) -> np.ndarray:
    """``dynamic_slice`` / ``dynamic_update_slice``: a gather of the result,
    with the operands (and one int32 start a dim) and the result as bytes."""
    c = np.zeros(N_METRICS)
    c[I_VPU] = c[I_GATHER] = out.numel()
    c[I_BYTES] = (tensor_bytes(x) + 4 * x.dim() + tensor_bytes(out)
                  + (0 if update is None else tensor_bytes(update)))
    return c


def _charge(cost: np.ndarray) -> None:
    w = active_walker()
    if w is not None:
        w.pending += cost


def dynamic_slice(x: torch.Tensor, dim: int, start, size: int
                  ) -> torch.Tensor:
    """``lax.dynamic_slice`` along ``dim`` (a copy), charged as the
    reference's walker charges it.  ``start``: an int, or a 0-d int tensor
    (a traced index, which jnp clamps first)."""
    i0, norm = _start(start)
    with uncharged():
        out = x.narrow(dim, i0, size).clone()
    _charge(_index_cost(x, None, out) + norm)
    return out


def dynamic_update_slice(x: torch.Tensor, update: torch.Tensor, dim: int,
                         start) -> torch.Tensor:
    """``lax.dynamic_update_slice`` along ``dim``: a new ``x`` with
    ``update`` written at ``start``, charged as the reference charges it."""
    i0, norm = _start(start)
    with uncharged():
        out = x.clone()
        out.narrow(dim, i0, update.shape[dim]).copy_(update)
    _charge(_index_cost(x, update, out) + norm)
    return out


def _mixed_dot(name: str, fn: Callable, args: tuple, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    with uncharged():
        out = fn(a.to(dt), b.to(dt))
    if active_walker() is not None:
        _charge(dot_cost(name, args, out))
    return out


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: mixed dtypes promote to the wider
    one inside the product, which the reference's walker charges as one
    ``dot_general`` on the operands as given (no convert)."""
    if a.dtype == b.dtype:
        return torch.einsum(eq, a, b)
    return _mixed_dot("einsum", lambda x, y: torch.einsum(eq, x, y),
                      (eq, a, b), a, b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's promotion of mixed dtypes (see :func:`einsum`)."""
    if a.dtype == b.dtype:
        return a @ b
    return _mixed_dot("matmul", torch.matmul, (a, b), a, b)


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def trace_fn(fn: Callable, *args, axis_sizes: dict[str, int] | None = None,
             **kwargs) -> Trace:
    """Walk ``fn(*args, **kwargs)`` into a template event stream.

    Tensor arguments (nested in dicts, lists or tuples) are replaced by
    meta tensors of the same shape and dtype, so nothing is allocated or
    computed and any device's tensors may be passed.  ``axis_sizes`` names
    the mesh axes of a per-rank program's collectives (their per-rank
    output shapes read it) and is kept on the trace."""
    args = tree_map(_to_meta, args)
    kwargs = tree_map(_to_meta, kwargs)
    w = CostWalker(axis_sizes)
    with w:
        fn(*args, **kwargs)
    w.flush()
    return Trace(w.events, w.axis_sizes)


def trace_fn_store(fn: Callable, *args,
                   axis_sizes: dict[str, int] | None = None, **kwargs):
    """Trace ``fn`` straight into a columnar
    :class:`~repro_torch.core.trace_ir.TraceStore`: the template is walked
    once and specialized per rank in array form.  Equivalent to
    ``TraceStore.from_rank_traces(per_rank_traces(trace_fn(...)))``."""
    from repro_torch.core.trace_ir import TraceStore
    template = trace_fn(fn, *args, axis_sizes=axis_sizes, **kwargs)
    sizes = dict(template.axis_sizes if axis_sizes is None else axis_sizes)
    return TraceStore.from_template(template, sizes)


def compute_cost(fn: Callable, *args, **kwargs) -> np.ndarray:
    """Total 6-metric cost of a collective-free callable (block calibration)."""
    return trace_fn(fn, *args, **kwargs).total_compute()


# ---------------------------------------------------------------------------
# per-rank specialization (paper §2.2 relative ranks, §2.6 SPMD merging input)
# ---------------------------------------------------------------------------


def per_rank_traces(trace: Trace, axis_sizes: dict[str, int] | None = None,
                    ) -> list[list[Event]]:
    """Specialize the SPMD template to one event list per rank.

    Ranks are the row-major flattening of the mesh axes in ``axis_sizes``
    order.  ``ppermute`` events become relative-encoded events present only
    on participating ranks (paper Fig. 2)."""
    axis_sizes = dict(axis_sizes or trace.axis_sizes)
    axes = list(axis_sizes)
    sizes = [axis_sizes[a] for a in axes]
    n_ranks = int(np.prod(sizes)) if sizes else 1

    def coords(rank: int) -> dict[str, int]:
        out = {}
        rem = rank
        for a, s in zip(reversed(axes), reversed(sizes)):
            out[a] = rem % s
            rem //= s
        return out

    traces: list[list[Event]] = []
    for rank in range(n_ranks):
        c = coords(rank)
        evs: list[Event] = []
        for ev in trace.events:
            if is_comm(ev) and ev.kind == "ppermute":
                ev2 = _specialize_ppermute(ev, c, axis_sizes)
                if ev2 is not None:
                    evs.append(ev2)
            else:
                evs.append(ev)
        traces.append(evs)
    return traces


def _specialize_ppermute(ev: CommEvent, coords: dict[str, int],
                         axis_sizes: dict[str, int]) -> CommEvent | None:
    if not ev.detail or ev.detail[0] != "rawperm":
        return ev
    perm = ev.detail[1]
    axis = ev.axes[0] if ev.axes else None
    size = axis_sizes.get(axis, max((max(s, d) for s, d in perm), default=0) + 1)
    me = coords.get(axis, 0)
    srcs = {s for s, _ in perm}
    dsts = {d for _, d in perm}
    if me not in srcs and me not in dsts:
        return None  # this rank does not participate
    rel = encode_relative_perm([tuple(p) for p in perm], size)
    return dataclasses.replace(ev, detail=rel)


# ---------------------------------------------------------------------------
# host-level interposition recorder (PMPI analog for multi-step drivers)
# ---------------------------------------------------------------------------


class TraceSession:
    """Record events emitted by instrumented wrappers in host-driver code.

    ``rank_streams[r]`` is rank r's event list.  Wrappers use
    :func:`record_event`; compute segments are costed with
    :func:`record_compute`.  Nested sessions are not supported."""

    def __init__(self, n_ranks: int, axis_sizes: dict[str, int] | None = None):
        self.n_ranks = n_ranks
        self.axis_sizes = dict(axis_sizes or {})
        self.rank_streams: list[list[Event]] = [[] for _ in range(n_ranks)]

    def __enter__(self):
        if getattr(_TLS, "session", None) is not None:
            raise RuntimeError("TraceSession already active")
        _TLS.session = self
        return self

    def __exit__(self, *exc):
        _TLS.session = None
        return False

    def emit(self, ranks: Iterable[int] | None, ev: Event) -> None:
        ranks = range(self.n_ranks) if ranks is None else ranks
        for r in ranks:
            self.rank_streams[r].append(ev)

    def to_store(self):
        """Freeze the recorded streams into a columnar
        :class:`~repro_torch.core.trace_ir.TraceStore`."""
        from repro_torch.core.trace_ir import TraceStore
        return TraceStore.from_rank_traces(self.rank_streams, self.axis_sizes)


def active_session() -> TraceSession | None:
    return getattr(_TLS, "session", None)


def record_event(ev: Event, ranks: Iterable[int] | None = None) -> None:
    s = active_session()
    if s is not None:
        s.emit(ranks, ev)


def record_compute(fn: Callable, *args, ranks: Iterable[int] | None = None,
                   **kwargs) -> None:
    """Cost ``fn`` with the walker and record one ComputeEvent."""
    s = active_session()
    if s is None:
        return
    vec = compute_cost(fn, *args, **kwargs)
    s.emit(ranks, ComputeEvent(tuple(vec)))

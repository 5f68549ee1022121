"""Collective wrappers and replay comm backends (port of
:mod:`repro.sharding.collectives`).

Two roles:

1. **Instrumented wrappers** (``psum``, ``pmax``, ``all_gather``,
   ``psum_scatter``, ``all_to_all``, ``ppermute``): the collectives a
   per-rank torch program calls, each recording the reference's
   :class:`CommEvent` (per-rank input shape, numpy dtype name, axes as
   strings, the reference's ``detail``).  Under the cost walker
   (:func:`repro_torch.core.tracer.trace_fn`) a wrapper closes the pending
   compute and appends its event, as the reference's jaxpr walker does at a
   collective equation; under a :class:`~repro_torch.core.tracer.
   TraceSession` it emits to every rank of the session.  On a meta tensor
   it returns a meta tensor of the collective's per-rank output shape, with
   axis sizes from the walker (or session).  A real tensor has no mesh to
   run on until the port's mesh slice (ROADMAP item 11): the wrapper raises
   rather than hand back its input as if the collective had run.

2. **Replay comm backends** for generated proxy-apps: :class:`LocalSim`.
   The mesh backend (``DeviceComm`` over ``torch.distributed``) waits for
   the mesh slice.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import tracer as _tracer
from repro_torch.core.events import CommEvent
from repro_torch.core.metrics import dtype_name

# ---------------------------------------------------------------------------
# instrumented wrappers
# ---------------------------------------------------------------------------


def _axes(axes) -> tuple[str, ...]:
    return ((axes,) if isinstance(axes, str) else tuple(axes))


def _axis_size(axes: tuple[str, ...]) -> int:
    w = _tracer.active_walker()
    s = _tracer.active_session()
    sizes = w.axis_sizes if w is not None else (s.axis_sizes if s else {})
    n = 1
    for a in axes:
        if a not in sizes:
            raise ValueError(f"collective over axis {a!r}: unknown size "
                             f"(axis_sizes {sizes}); pass axis_sizes= to "
                             "trace_fn / synthesize or the TraceSession")
        n *= int(sizes[a])
    return n


def _collective(kind: str, x: torch.Tensor, axes, detail: tuple,
                out_shape) -> torch.Tensor:
    """Record the event, then return the per-rank output on meta.

    ``out_shape`` maps the group size to the output shape."""
    axes_t = _axes(axes)
    if x.device.type != "meta":
        raise NotImplementedError(
            f"{kind} on a {x.device.type} tensor: a collective needs the "
            "mesh backend, which waits for the port's mesh slice (ROADMAP "
            "item 11); trace the program with trace_fn or synthesize(fn, "
            "..., axis_sizes=...), which run it on meta tensors")
    shape = tuple(out_shape(_axis_size(axes_t)))
    ev = CommEvent(kind=kind, shape=tuple(int(s) for s in x.shape),
                   dtype=dtype_name(x.dtype),
                   axes=tuple(str(a) for a in axes_t), detail=detail)
    w = _tracer.active_walker()
    if w is not None:
        w.emit_comm(ev)
    else:
        _tracer.record_event(ev)
    return torch.empty(shape, dtype=x.dtype, device="meta")


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    return _collective("psum", x, axes, (), lambda n: x.shape)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _collective("pmax", x, axes, (), lambda n: x.shape)


def all_gather(x: torch.Tensor, axis, *, gather_dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: a new dim of the group size at ``gather_dim``,
    or (``tiled``) that dim ``n`` times longer."""
    def shape(n):
        s = list(x.shape)
        if tiled:
            s[gather_dim] *= n
        else:
            s.insert(gather_dim, n)
        return s
    return _collective("all_gather", x, axis, (gather_dim,), shape)


def psum_scatter(x: torch.Tensor, axis, *, scatter_dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """``lax.psum_scatter``: ``scatter_dim`` cut ``n`` ways (``tiled``), or
    dropped (it must be ``n`` long)."""
    def shape(n):
        s = list(x.shape)
        if s[scatter_dim] % n or (not tiled and s[scatter_dim] != n):
            raise ValueError(f"psum_scatter: dim {scatter_dim} of "
                             f"{tuple(x.shape)} over {n} ranks")
        if tiled:
            s[scatter_dim] //= n
        else:
            del s[scatter_dim]
        return s
    return _collective("reduce_scatter", x, axis, (scatter_dim,), shape)


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int, *,
               tiled: bool = True) -> torch.Tensor:
    """``lax.all_to_all``: ``split_axis`` cut ``n`` ways and ``concat_axis``
    ``n`` times longer (``tiled``); untiled, ``split_axis`` (``n`` long) is
    dropped and a dim of ``n`` inserted at ``concat_axis``."""
    def shape(n):
        s = list(x.shape)
        if s[split_axis] % n or (not tiled and s[split_axis] != n):
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} over {n} ranks")
        if tiled:
            s[split_axis] //= n
            s[concat_axis] *= n
        else:
            del s[split_axis]
            s.insert(concat_axis, n)
        return s
    return _collective("all_to_all", x, axis, (split_axis, concat_axis),
                       shape)


def ppermute(x: torch.Tensor, axis, perm: Sequence[tuple[int, int]]
             ) -> torch.Tensor:
    return _collective("ppermute", x, axis,
                       ("rawperm", tuple(tuple(int(i) for i in p)
                                         for p in perm)),
                       lambda n: x.shape)


# ---------------------------------------------------------------------------
# replay comm backends
# ---------------------------------------------------------------------------


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

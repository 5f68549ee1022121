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
   axis sizes from the walker (or session).  On a real tensor it runs the
   collective with ``jax.lax``'s semantics over the process groups of the
   mesh bound by :func:`bind_mesh` (SPMD: every process of the mesh runs
   the same program), recording its event all the same.  A real tensor
   with no bound mesh, an axis the mesh lacks, or a tensor of the other
   backend's device raises: nothing passes its input through as if the
   collective had run.

2. **Replay comm backends** for generated proxy-apps:
   * :class:`LocalSim`: a sequence point per collective, for one process;
   * :class:`DeviceComm`: the recorded collective itself, over the process
     groups of a mesh placement (:class:`~repro_torch.launch.mesh.Submesh`)
     on ``torch.distributed``: NCCL for CUDA tensors, gloo for CPU ones.

Every backend folds the collective's result back into the fixed-shape pool
buffer, so a replay state keeps its shapes and dtypes through ``do``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import tracer as _tracer
from repro_torch.core.events import CommEvent, decode_relative_perm
from repro_torch.core.metrics import dtype_name, torch_dtype
from repro_torch.launch.mesh import Submesh, check_tensor_backend, mesh_groups

# ---------------------------------------------------------------------------
# instrumented wrappers
# ---------------------------------------------------------------------------


_BOUND: list[Submesh] = []


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind the instrumented wrappers' axis names to ``mesh``'s process
    groups: inside, a wrapper on a real tensor runs its collective there.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.Submesh` (used as it
    is: its ``axes_sets`` must hold the axes the program names) or a
    ``DeviceMesh``, whose groups over every ordered set of its axes
    (:func:`~repro_torch.launch.mesh.mesh_groups`) the first use of that
    mesh builds.  Building groups is collective: every process of the
    world enters ``bind_mesh`` with the same mesh, in the same order,
    members of the mesh or not."""
    if not isinstance(mesh, Submesh):
        mesh = mesh_groups(mesh)
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


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
                out_shape, run=None) -> torch.Tensor:
    """Record the event, then return the per-rank output: on meta, a meta
    tensor of ``out_shape(group size)``; on a real tensor,
    ``run(process group, members)`` over the bound mesh."""
    axes_t = _axes(axes)
    if x.device.type != "meta":
        sub = _BOUND[-1] if _BOUND else None
        if sub is None:
            raise RuntimeError(
                f"{kind} on a {x.device.type} tensor with no mesh bound: run "
                "the program inside collectives.bind_mesh(mesh), one process "
                "a device, or trace it with trace_fn / synthesize(fn, ..., "
                "axis_sizes=...), which run it on meta tensors")
        for a in axes_t:
            if a not in sub.axis_sizes:
                raise ValueError(f"collective over axis {a!r}: unknown size "
                                 f"(the bound mesh has {sub.axis_sizes})")
        check_tensor_backend(sub.backend, x.device)
        pg, members = sub.group(axes_t)
    ev = CommEvent(kind=kind, shape=tuple(int(s) for s in x.shape),
                   dtype=dtype_name(x.dtype),
                   axes=tuple(str(a) for a in axes_t), detail=detail)
    if x.device.type != "meta":
        _tracer.record_event(ev)
        return run(pg, members)
    shape = tuple(out_shape(_axis_size(axes_t)))
    w = _tracer.active_walker()
    if w is not None:
        w.emit_comm(ev)
    else:
        _tracer.record_event(ev)
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _reduce(x: torch.Tensor, op, pg) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op, group=pg)
    return y


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    return _collective("psum", x, axes, (), lambda n: x.shape,
                       lambda pg, m: _reduce(x, dist.ReduceOp.SUM, pg))


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _collective("pmax", x, axes, (), lambda n: x.shape,
                       lambda pg, m: _reduce(x, dist.ReduceOp.MAX, pg))


def all_gather(x: torch.Tensor, axis, *, gather_dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: a new dim of the group size at ``gather_dim``,
    or (``tiled``) that dim ``n`` times longer; the members' blocks in the
    order of the axes named."""
    def shape(n):
        s = list(x.shape)
        if tiled:
            s[gather_dim] *= n
        else:
            s.insert(gather_dim, n)
        return s

    def run(pg, members):
        g = _gather(x, pg, members).movedim(0, gather_dim)
        return g.reshape(shape(len(members))) if tiled else g.contiguous()
    return _collective("all_gather", x, axis, (gather_dim,), shape, run)


def psum_scatter(x: torch.Tensor, axis, *, scatter_dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """``lax.psum_scatter``: ``scatter_dim`` cut ``n`` ways (``tiled``), or
    dropped (it must be ``n`` long); member ``k`` keeps the sum of block
    ``k``."""
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

    def run(pg, members):
        out_shape = shape(len(members))
        y = _reduce_scatter(x, scatter_dim, pg, members)
        return y.reshape(out_shape)
    return _collective("reduce_scatter", x, axis, (scatter_dim,), shape, run)


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

    def run(pg, members):
        shape(len(members))                     # the checks
        if tiled:
            return _all_to_all(x, split_axis, concat_axis, pg, members)
        # blocks of one along the split dim, gathered back in its place in
        # member order, then moved to the concat position
        y = _all_to_all(x, split_axis, split_axis, pg, members)
        return y.movedim(split_axis, concat_axis).contiguous()
    return _collective("all_to_all", x, axis, (split_axis, concat_axis),
                       shape, run)


def ppermute(x: torch.Tensor, axis, perm: Sequence[tuple[int, int]]
             ) -> torch.Tensor:
    """``lax.ppermute``; a device no pair sends to receives zeros."""
    perm = tuple(tuple(int(i) for i in p) for p in perm)
    return _collective("ppermute", x, axis, ("rawperm", perm),
                       lambda n: x.shape,
                       lambda pg, m: _ppermute(x, perm, pg, m))


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


_REDUCE_OPS = {"psum": "SUM", "pmax": "MAX", "pmin": "MIN"}


class DeviceComm:
    """Mesh replay: executes the recorded collective over ``torch.distributed``.

    ``submesh`` is a placement's process groups
    (:class:`~repro_torch.launch.mesh.Submesh`), and its ``axis_sizes`` the
    sub-mesh geometry.  The payload fed to the collective has exactly the
    traced shape and dtype; the result is folded back into the pool buffer
    (mean over a gathered dim, tiles of a scattered one), so the shape *and*
    dtype of ``st[buf]`` are the same after ``do`` for every kind, as in
    the reference.  Per kind, as the reference defines them:

    * ``psum``, ``pmax``, ``pmin``: ``all_reduce``; ``psum`` divided by the
      group's size;
    * ``all_gather``: gather, then the float32 mean over the gathered dim,
      cast back;
    * ``reduce_scatter``: ``reduce_scatter_tensor`` over the scatter dim,
      tiled back and divided by the size; where the dim does not divide,
      ``all_reduce`` divided by the size;
    * ``all_to_all``: a tiled ``all_to_all_single`` on the split dim,
      concatenated on the concat dim and reshaped to the traced shape;
      where the split dim does not divide, a ring ``ppermute``;
    * ``ppermute``: ``batch_isend_irecv`` of :func:`_detail_to_perm`'s
      pairs (device indices in mesh order, wrapped at the group's size, as
      JAX lowers them); a self pair is a local copy, and a device no pair
      sends to receives zeros;
    * ``broadcast``: gather, then element ``[0]``.

    **Stacked states.**  The reference ``vmap``-s a group's stacked states
    through the collective.  Here ``do`` compares ``st[buf]`` with the
    traced shape: a buffer with a leading axis beyond it (a group replayed
    with ``per_rank_seeds``, or noisy replicas) runs **one** collective on
    the whole stack, its split, concat, scatter and gather dims shifted by
    one, with the same bits per member as one collective each wherever the
    reduction's sums are exact (a ring all-reduce may order an inexact sum
    by the buffer's size).

    NCCL runs CUDA tensors and gloo CPU tensors; a tensor of the other
    device raises (:func:`~repro_torch.launch.mesh.check_tensor_backend`).
    """

    def __init__(self, submesh):
        self.submesh = submesh
        self.axis_sizes = dict(submesh.axis_sizes)

    def do(self, st: dict, buf: str, *, kind: str, axes, detail, shape, dtype):
        st = dict(st)
        cur = st[buf]
        shape = tuple(int(s) for s in shape)
        n = math.prod(shape)
        lead = 0 if cur.numel() == n else 1
        if lead and (cur.dim() == 0 or cur.numel() != cur.shape[0] * n):
            raise ValueError(f"pool buffer {buf!r} of {tuple(cur.shape)} "
                             f"holds no whole payloads of {shape}")
        pshape = shape if not lead else (int(cur.shape[0]),) + shape
        x = cur.to(torch_dtype(dtype)).reshape(pshape)
        pg, members = self.submesh.group(axes)
        check_tensor_backend(self.submesh.backend, x.device)
        if kind in _REDUCE_OPS:
            y = _reduce(x, getattr(dist.ReduceOp, _REDUCE_OPS[kind]), pg)
            if kind == "psum":
                size = math.prod(self.axis_sizes[a] for a in axes)
                y = y / max(size, 1)
        elif kind == "all_gather":
            g = _gather(x, pg, members)
            y = torch.mean(g.to(torch.float32), dim=0).to(x.dtype)
        elif kind == "reduce_scatter":
            dim = (int(detail[0]) if detail else 0) + lead
            size = self.axis_sizes[axes[0]]
            if shape[dim - lead] % size == 0:
                xm = x.movedim(dim, 0).contiguous()
                out = xm.new_empty((xm.shape[0] // len(members),)
                                   + tuple(xm.shape[1:]))
                dist.reduce_scatter_tensor(out, xm, dist.ReduceOp.SUM,
                                           group=pg)
                y = out.movedim(0, dim)
                reps = [1] * y.dim()
                reps[dim] = size
                y = y.repeat(reps) / size
            else:
                y = x.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(y, dist.ReduceOp.SUM, group=pg)
                y = y / size
        elif kind == "all_to_all":
            split, concat = ((int(detail[0]), int(detail[1]))
                             if len(detail) >= 2 else (0, 0))
            size = self.axis_sizes[axes[0]]
            if shape[split] % size == 0:
                y = _all_to_all(x, split + lead, concat + lead, pg, members)
                y = _reshape_back(y, pshape)
            else:
                y = _ppermute(x, [(i, (i + 1) % size) for i in range(size)],
                              pg, members)
        elif kind == "ppermute":
            size = self.axis_sizes[axes[0]]
            y = _ppermute(x, _detail_to_perm(detail, size), pg, members)
        elif kind == "broadcast":
            y = _gather(x, pg, members)[0]
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        st[buf] = y.reshape(cur.shape).to(cur.dtype)
        return st


def _group_order(members: Sequence[int]) -> list[int]:
    """Group rank of each member: ``torch.distributed`` numbers a group's
    ranks in sorted order, the collective's own index runs over
    ``members``."""
    ordered = sorted(members)
    return [ordered.index(m) for m in members]


def _gather(x: torch.Tensor, pg, members) -> torch.Tensor:
    """(group size, *x.shape): every member's ``x``, in member order."""
    out = x.new_empty(len(members) * x.numel())
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=pg)
    out = out.reshape((len(members),) + tuple(x.shape))
    order = _group_order(members)
    return out if order == sorted(order) else out[order]


def _reduce_scatter(x: torch.Tensor, dim: int, pg, members) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)`` over ``dim``: member ``k`` gets the
    sum of every member's block ``k``."""
    g = len(members)
    order = _group_order(members)
    xm = x.movedim(dim, 0)
    chunks = xm.reshape((g, xm.shape[0] // g) + tuple(xm.shape[1:]))
    send = chunks.new_empty(chunks.shape)      # contiguous
    send[order] = chunks                       # block k to group rank order[k]
    out = send.new_empty(send.shape[1:])
    dist.reduce_scatter_tensor(out, send.reshape((-1,) + tuple(xm.shape[1:])),
                               dist.ReduceOp.SUM, group=pg)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, split: int, concat: int, pg,
                members) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: chunk ``k`` of ``split`` goes to
    member ``k``; the chunks received are concatenated on ``concat`` in
    member order."""
    g = len(members)
    order = _group_order(members)
    xm = x.movedim(split, 0)
    chunks = xm.reshape((g, xm.shape[0] // g) + tuple(xm.shape[1:]))
    send = chunks.new_empty(chunks.shape)      # contiguous
    send[order] = chunks                       # chunk k to group rank order[k]
    recv = send.new_empty(send.shape)
    dist.all_to_all_single(recv, send, group=pg)
    r = recv[order]                            # r[k]: from member k
    r = r.movedim(1, split + 1).movedim(0, concat)
    s = list(r.shape)
    return r.reshape(s[:concat] + [s[concat] * s[concat + 1]] + s[concat + 2:])


def _ppermute(x: torch.Tensor, perm, pg, members) -> torch.Tensor:
    """``lax.ppermute``: device ``src`` sends to device ``dst`` for each
    pair; a device no pair sends to gets zeros.  As in JAX's lowering, the
    indices count the group's devices in mesh order (whatever the order of
    the axes named) and wrap at the group's size."""
    ordered = sorted(members)
    g = len(ordered)
    me = ordered.index(dist.get_rank())
    perm = [(int(s) % g, int(d) % g) for s, d in perm]
    if len({s for s, _ in perm}) < len(perm) or \
            len({d for _, d in perm}) < len(perm):
        raise ValueError(f"ppermute sources and destinations must be "
                         f"unique, got {perm}")
    x = x.contiguous()
    y = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            y = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ordered[dst], pg))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, y, ordered[src], pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return y


def _reshape_back(y, shape):
    return y.reshape(shape) if y.numel() == math.prod(shape) else y


def _detail_to_perm(detail: tuple, size: int) -> list[tuple[int, int]]:
    if detail and detail[0] in ("shift", "perm", "empty"):
        return decode_relative_perm(detail, size)
    if detail and detail[0] == "rawperm":
        return [tuple(p) for p in detail[1]]
    return [(i, (i + 1) % size) for i in range(size)]

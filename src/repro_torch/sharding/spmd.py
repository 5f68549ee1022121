"""SPMD execution of sharded parameters: tensor-parallel on ``model``,
FSDP on ``data``.

One process a device, as the mesh tier runs (:mod:`repro_torch.launch.
mesh`; groups from :func:`~repro_torch.launch.mesh.mesh_groups`).  A
sharded parameter is a plain tensor holding this process's block of the
global array (:func:`~repro_torch.sharding.partition.local_shard`), its
spec from the config's rules.  The reference needs nothing like this
module: GSPMD inserts its collectives.  Here the model code calls them,
through the conjugate pair of Megatron-LM:

* :meth:`Spmd.copy` (*f*): the identity forward, an all-reduce of the
  gradient backward.  At the input of a column-parallel product, and on
  any tensor every process holds whole but uses only a part of (a norm's
  weight applied to the local heads).
* :meth:`Spmd.reduce` (*g*): an all-reduce forward, the identity backward.
  At the output of a row-parallel product: what follows runs whole on
  every process.
* :meth:`Spmd.gather` (an all-gather forward, a reduce-scatter of the sum
  backward): a weight whose ``embed`` dim is split over ``data`` (FSDP),
  or whose columns do not line up with this process's heads.
* :meth:`Spmd.a2a` (an all-to-all forward, the inverse all-to-all
  backward): the reference's axis-moving reshard, as attention's
  ``"batch"`` and ``"cp"`` modes move a flat projection's column blocks to
  blocks of batch rows or of query positions and back.

Each is one library collective: ``all_reduce`` (sum or max),
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single``, with blocks in the order of the group's members
(the replay tier's ``_gather``, ``_reduce_scatter`` and ``_all_to_all``).
NCCL on the card and gloo on the CPU run them, and so does a gloo group
that carries CUDA tensors (``make_test_mesh(..., device="cuda")``).  A
group of one process is never called: each helper returns its input, so
on a mesh whose rules split no parameter (and where no expert routes
across a data axis) :func:`context` is ``None`` and the model computes
exactly what one device computes.

The batch's rows are this process's block over the mesh axes that split
them (``("pod", "data")`` by the rules, where they divide the global
batch).  What depends on the global batch (attention's mode, MoE's data
shards) reads it from :meth:`Spmd.batch_axes`: the axes a caller declared
with :meth:`Spmd.rows` (the train step and the serve engine, which split
the batch), else every ``batch`` axis of the rules.

Where the mesh does not divide a dimension, the rules' filter
(``partition._filter_divisible``) leaves it whole, as the reference's
does, and the layer computes it whole on each process: every SSM head
where the ``model`` axis does not divide them, the q/k/v projections of a
``"batch"`` or ``"cp"`` call from whole weights where their flat columns do
not split, a decode cache whose length the axis does not divide.  A
region computed whole but used in part (this process's rows, positions
or output columns) takes its inputs through :meth:`Spmd.copy` (a whole
weight) or :meth:`Spmd.gather` (a split one), so the gradients sum over
``model``; :meth:`Spmd.assemble` puts the parts back together.  GQA groups
(or the SSM's B/C groups) that do not line up with a process's heads
reach each local head by an index map (:func:`kv_groups`).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_device, mesh_groups, mesh_ranks
from repro_torch.sharding.collectives import (
    _all_to_all, _gather, _reduce_scatter,
)
from repro_torch.sharding.partition import (
    LogicalRules, PartitionSpec, axis_sizes, entry_axes, is_replicated,
    sharding_for_shape, spec_for,
)

MODEL = ("model",)


# ---------------------------------------------------------------------------
# raw collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``op`` (the sum) of ``x`` over the group (``x``
    untouched)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op, group=pg)
    return y


def all_gather(x: torch.Tensor, pg, members, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of the group's processes concatenated along
    ``dim``, in the order of ``members``."""
    return torch.cat(_gather(x, pg, members).unbind(0), dim=dim)


# ---------------------------------------------------------------------------
# the conjugate collectives (autograd)
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    """f: identity forward, gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.pg), None


class _Reduce(torch.autograd.Function):
    """g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward, the gradient summed over
    the group and this process's block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, pg, members, dim):
        ctx.args = (pg, members, dim % x.dim())
        return all_gather(x, pg, members, dim)

    @staticmethod
    def backward(ctx, g):
        pg, members, dim = ctx.args
        return (_reduce_scatter(g.contiguous(), dim, pg, members).contiguous(),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    """All-to-all from ``split`` to ``concat`` forward (block ``k`` of
    ``split`` to member ``k``, the blocks received concatenated along
    ``concat`` in member order: one ``all_to_all_single``, which gloo runs
    on CUDA tensors too); backward, the inverse all-to-all of the gradient
    (from ``concat`` to ``split``)."""

    @staticmethod
    def forward(ctx, x, pg, members, split, concat):
        ctx.args = (pg, members, split % x.dim(), concat % x.dim())
        return _all_to_all(x.contiguous(), split, concat, pg, members)

    @staticmethod
    def backward(ctx, g):
        pg, members, split, concat = ctx.args
        return (_all_to_all(g.contiguous(), concat, split, pg, members),
                None, None, None, None)


# ---------------------------------------------------------------------------
# what executes
# ---------------------------------------------------------------------------


def shards_parameters(cfg, sizes: dict, rules: LogicalRules) -> bool:
    """True when the rules split some parameter of ``cfg`` on the mesh."""
    from repro_torch.configs.registry import param_specs
    from repro_torch.models.layers import tree_leaves
    return any(not is_replicated(m.spec, sizes)
               for m in tree_leaves(param_specs(cfg, sizes, rules)))


def routes_rows(cfg, sizes: dict) -> bool:
    """True when ``cfg`` routes experts on a mesh whose ``pod`` or ``data``
    axis is over 1: the reference dispatches per data shard and takes the
    aux loss's means over every shard, so the layers need the mesh even
    where the rules split no parameter."""
    return bool(cfg.n_experts) and any(int(sizes.get(a, 1)) > 1
                                       for a in ("pod", "data"))


def check_supported(cfg, sizes: dict, rules: LogicalRules) -> bool:
    """Whether ``cfg`` runs on the mesh's SPMD context (True: the rules
    split a parameter, or experts route across a data mesh) or whole on
    each process (False).  Every config runs on every mesh: what the mesh
    does not divide the rules leave whole (module docstring)."""
    return shards_parameters(cfg, sizes, rules) or routes_rows(cfg, sizes)


def kv_groups(h: int, g: int, tp: int, r: int
              ) -> tuple[int, int, list[int] | None]:
    """The groups (GQA's kv heads, the SSM's B/C groups) that the heads of
    model position ``r`` read, ``h // tp`` heads a position: [lo, hi), and
    None where they map as one block (local head i to local group i //
    (local heads / local groups)), else each local head's group less
    ``lo`` (the index map a caller expands the groups by)."""
    hl, rep = h // tp, h // g
    lo, hi = (r * hl) // rep, ((r + 1) * hl - 1) // rep + 1
    idx = [(r * hl + i) // rep - lo for i in range(hl)]
    if hl % (hi - lo) == 0 and all(j == i // (hl // (hi - lo))
                                   for i, j in enumerate(idx)):
        return lo, hi, None
    return lo, hi, idx


def span(n: int, tp: int, r: int) -> tuple[int, int]:
    """[lo, hi) of position ``r``'s part of ``n`` items dealt over ``tp``:
    equal blocks where ``tp`` divides ``n``, else the first ``n % tp``
    parts one longer."""
    q, m = divmod(n, tp)
    lo = r * q + min(r, m)
    return lo, lo + q + (r < m)


# ---------------------------------------------------------------------------
# a mesh's SPMD context for one config
# ---------------------------------------------------------------------------


class Spmd:
    """A mesh's sharded execution of one config, from this process: its
    coordinate, its groups, the config's rules and the collectives above.
    Build it with :func:`context`; ``tp`` and ``r`` are the ``model``
    axis's size and this process's index on it."""

    def __init__(self, mesh, cfg, rules: LogicalRules):
        self.mesh = mesh
        self.cfg = cfg
        self.rules = rules
        self.sizes = axis_sizes(mesh)
        self.sub = mesh_groups(mesh)
        ranks = mesh_ranks(mesh)
        me = dist.get_rank()
        if me not in ranks:
            raise ValueError(f"process {me} is not on the mesh {ranks}")
        self.coord = dict(zip(self.sizes, (int(c) for c in np.unravel_index(
            ranks.index(me), tuple(self.sizes.values())))))
        self.device = mesh_device(mesh)
        self.tp = int(self.sizes.get("model", 1))
        self.r = int(self.coord.get("model", 0))
        self._specs: dict = {}
        self._rows: tuple[str, ...] | None = None

    # -- the batch -----------------------------------------------------------

    @contextlib.contextmanager
    def rows(self, axes):
        """Declare, for the calls inside, the mesh axes that split the
        batch's rows (``()``: every process holds the whole batch, as the
        rules replicate a batch the data axes do not divide)."""
        old, self._rows = self._rows, tuple(axes)
        try:
            yield self
        finally:
            self._rows = old

    def batch_axes(self) -> tuple[str, ...]:
        """The axes (of size over 1) whose processes hold other rows: the
        declared ones, else every axis of the rules' ``batch``."""
        if self._rows is None:
            spec = spec_for(("batch",), self.sizes, self.rules)
            axes = entry_axes(spec[0] if spec else None)
        else:
            axes = self._rows
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def row_blocks(self) -> int:
        return math.prod(self.sizes[a] for a in self.batch_axes())

    def global_batch(self, rows: int) -> int:
        """The global batch of a call whose local batch has ``rows``."""
        return rows * self.row_blocks()

    def data_shards(self, batch: int) -> int:
        """The reference's ``_data_shards`` (``moe.py:43-50``): pod x data,
        halved until it divides the global ``batch``."""
        n = int(self.sizes.get("pod", 1)) * int(self.sizes.get("data", 1))
        while n > 1 and batch % n:
            n //= 2
        return max(n, 1)

    # -- geometry ------------------------------------------------------------

    def spec(self, shape, logical) -> PartitionSpec:
        key = (tuple(int(s) for s in shape), tuple(logical))
        if key not in self._specs:
            self._specs[key] = sharding_for_shape(key[0], key[1], self.sizes,
                                                  self.rules)
        return self._specs[key]

    def split(self, shape, logical, dim: int) -> tuple[str, ...]:
        """The mesh axes (of size over 1) that split dim ``dim``."""
        spec = self.spec(shape, logical)
        entry = spec[dim] if dim < len(spec) else None
        return tuple(a for a in entry_axes(entry) if self.sizes[a] > 1)

    def _group(self, axes: tuple[str, ...]):
        """(process group, members, this process's index among them) over
        ``axes``, or None for a group of one."""
        axes = tuple(a for a in axes if self.sizes.get(a, 1) > 1)
        if not axes:
            return None
        pg, members = self.sub.group(axes)
        return pg, members, members.index(dist.get_rank())

    # -- collectives ---------------------------------------------------------

    def copy(self, x, axes=MODEL):
        grp = self._group(axes)
        return x if grp is None else _Copy.apply(x, grp[0])

    def reduce(self, x, axes=MODEL):
        grp = self._group(axes)
        return x if grp is None else _Reduce.apply(x, grp[0])

    def reduce_partial(self, x, axes=MODEL):
        """The sum over the group of a statistic each process uses a part
        of: all-reduced both ways (g, then f)."""
        return self.copy(self.reduce(x, axes), axes)

    def gather(self, x, dim: int, axes=MODEL):
        grp = self._group(axes)
        return x if grp is None else _Gather.apply(x, grp[0], grp[1], dim)

    def a2a(self, x, split: int, concat: int, axes=MODEL):
        """``split`` cut into the group's blocks and ``concat`` made the
        group's size times longer (autograd: the backward is the inverse
        all-to-all)."""
        grp = self._group(axes)
        return x if grp is None else _AllToAll.apply(x, grp[0], grp[1],
                                                     split, concat)

    def all_gather(self, x, dim: int, axes=MODEL):
        """The blocks of ``x`` over the group concatenated along ``dim`` (no
        gradient)."""
        grp = self._group(axes)
        return x if grp is None else all_gather(x.detach(), grp[0], grp[1],
                                                dim)

    def max(self, x, axes=MODEL):
        """The elementwise max over the group (no gradient)."""
        grp = self._group(axes)
        return x if grp is None else all_reduce(x.detach(), grp[0],
                                                dist.ReduceOp.MAX)

    def unshard(self, w, shape, logical):
        """``w`` with every dim that a non-``model`` axis splits (FSDP's
        ``embed`` on ``data``) gathered: the gradient of the gathered
        weight is reduce-scattered back.  ``model`` splits stay: a dim
        split over ``model`` and another axis together is gathered over
        all of them as one block, then cut to this process's ``model``
        block."""
        for dim in range(len(shape)):
            axes = self.split(shape, logical, dim)
            if not any(a != "model" for a in axes):
                continue
            w = self.gather(w, dim, axes)
            if "model" in axes:
                n = shape[dim] // self.tp
                w = w.narrow(dim, self.r * n, n)
        return w

    def whole(self, w, shape, logical):
        """``w`` whole, for a region every process computes whole and uses
        in part: each split dim gathered (its gradient reduce-scattered
        back), and where nothing splits it over ``model`` through
        :meth:`copy` (its gradient summed over ``model``)."""
        on_model = False
        for dim in range(len(shape)):
            axes = self.split(shape, logical, dim)
            if axes:
                w = self.gather(w, dim, axes)
                on_model = on_model or "model" in axes
        return w if on_model else self.copy(w)

    def assemble(self, part, dim: int, n: int, lo: int, both: bool = True):
        """The whole of a tensor along ``dim`` (length ``n``) from each
        ``model`` process's part, this one's at [lo, lo + its length):
        zero-padded and summed over ``model``.  ``both``: the gradient is
        summed too (each process's backward covers a part of the whole);
        else it passes through (what follows runs whole on every process)."""
        if self.tp == 1:
            return part
        pad = [0, 0] * (part.dim() - dim - 1) + [lo, n - lo - part.shape[dim]]
        full = torch.nn.functional.pad(part, pad)
        return self.reduce_partial(full) if both else self.reduce(full)

    def block(self, axes=MODEL) -> tuple[int, int]:
        """(this process's index, number of processes) over ``axes``."""
        grp = self._group(axes)
        return (0, 1) if grp is None else (grp[2], len(grp[1]))


def context(mesh, cfg, rules: LogicalRules | None = None) -> Spmd | None:
    """The :class:`Spmd` of ``mesh`` for ``cfg`` (its rules by default), or
    None off-mesh and where :func:`check_supported` says the config runs
    whole on every process.  Kept on the mesh object, a context a set of
    rules; the first call for a mesh builds its groups
    (:func:`~repro_torch.launch.mesh.mesh_groups`, collective)."""
    if mesh is None or isinstance(mesh, Spmd):
        return mesh
    if rules is None:
        from repro_torch.configs.registry import rules_for
        rules = rules_for(cfg)
    cache = mesh.__dict__.setdefault("_repro_spmd", {})
    key = (cfg, rules)
    if key not in cache:
        sharded = check_supported(cfg, axis_sizes(mesh), rules)
        cache[key] = Spmd(mesh, cfg, rules) if sharded else None
    return cache[key]


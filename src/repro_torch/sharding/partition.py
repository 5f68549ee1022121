"""Logical-axis partitioning rules (port of :mod:`repro.sharding.partition`).

Model code annotates every parameter and batch array with *logical* axis
names ("embed", "heads", "ffn", "vocab", "batch", ...).  A
:class:`LogicalRules` table maps a logical name to mesh axes, and
:func:`sharding_for_shape` gives a tensor's :class:`PartitionSpec` on a
mesh, dropping the mesh axes that do not divide a dim.  Changing the
parallelism layout means swapping the rules, not touching model code.

A mesh here is anything with named axes and sizes: a
:class:`torch.distributed.device_mesh.DeviceMesh` (its ``mesh_dim_names``
and shape), a :class:`~repro_torch.launch.mesh.Submesh`, or a plain dict of
axis sizes (the geometry alone, for the rules and their checks without a
process group).  The spec is the port's own small tuple: one entry a tensor
dim, each ``None``, a mesh axis name, or a tuple of names; trailing
``None`` entries are dropped, as ``jax.sharding.PartitionSpec`` is built
here by the reference.  :func:`placements` turns a spec into
``torch.distributed.tensor`` placements.

A sharded tensor executes as a plain tensor holding this process's block
of the global array (one process a device: :mod:`repro_torch.launch.mesh`).
Each dim split by a spec entry is cut into equal blocks, one a position of
the entry's axes, the first axis major (:func:`local_shard`), as a
``NamedSharding`` places them on the reference's devices.
:func:`gather_full` puts the blocks back together (collective), and
:func:`shard_params` keeps the local block of every leaf of a tree.  The
model code runs on such blocks through :mod:`repro_torch.sharding.spmd`.
:func:`constraint` executes a spec on a tensor every process holds whole:
it returns this process's block.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

#: default rules for the production meshes (the reference's table):
#:   params:  TP over "model" (heads / ffn / vocab), replicated over data/pod
#:   activations: batch over ("pod","data"), model-parallel dims over "model"
DEFAULT_RULES: tuple[tuple[str, object], ...] = (
    ("batch",        ("pod", "data")),
    ("microbatch",   None),
    ("seq",          None),
    ("kv_seq",       "model"),      # decode: KV cache seq-sharded (flash-decode)
    ("embed",        None),
    ("heads",        "model"),
    ("kv_heads",     "model"),
    ("heads_flat",   "model"),      # flattened h·hd projection columns
    ("kv_flat",      "model"),
    ("qkv",          None),
    ("head_dim",     None),
    ("ffn",          "model"),
    ("vocab",        "model"),
    ("experts",      "model"),      # MoE: experts grouped over model axis
    ("expert_ffn",   None),
    ("layers",       None),
    ("ssm_state",    None),
    ("ssm_heads",    "model"),
    ("conv_dim",     "model"),
    ("frames",       None),
    ("patches",      None),
    ("fsdp",         "data"),       # optional ZeRO-style param shard axis
    ("attn_seq",     "model"),      # context-parallel fallback when heads
                                    # don't divide the model axis
    ("batch_attn",   ("pod", "data", "model")),  # fully-local attention:
                                    # batch sharded over the whole mesh
)


class PartitionSpec(tuple):
    """A tensor's mesh axes, one entry a dim: ``None``, an axis name, or a
    tuple of names (the dim split over their product, the first major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def mesh_axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec names, in order."""
        out = []
        for entry in self:
            if entry is not None:
                out.extend((entry,) if isinstance(entry, str) else entry)
        return tuple(out)


P = PartitionSpec


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a Submesh or a dict."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "axis_sizes"):
        return {str(k): int(v) for k, v in mesh.axis_sizes.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"{type(mesh).__name__} is not a mesh: pass a "
                        "DeviceMesh with named dims, a Submesh or a dict of "
                        "axis sizes")
    return {str(n): int(s) for n, s in zip(names, tuple(mesh.mesh.shape))}


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    rules: tuple[tuple[str, object], ...] = DEFAULT_RULES

    def mesh_axes(self, logical: str):
        for name, axes in self.rules:
            if name == logical:
                return axes
        return None

    def spec(self, logical_axes: Sequence[str | None], mesh) -> PartitionSpec:
        """PartitionSpec for a tensor annotated with logical axis names.

        Mesh axes absent from ``mesh`` are dropped (so the same rules work on
        single-pod and multi-pod meshes); a mesh axis may be used at most once.
        """
        names = axis_sizes(mesh)
        used: set[str] = set()
        parts = []
        for ax in logical_axes:
            entry = self.mesh_axes(ax) if ax else None
            if entry is None:
                parts.append(None)
                continue
            cand = (entry,) if isinstance(entry, str) else tuple(entry)
            picked = tuple(a for a in cand if a in names and a not in used)
            used.update(picked)
            if not picked:
                parts.append(None)
            elif len(picked) == 1:
                parts.append(picked[0])
            else:
                parts.append(picked)
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    def with_overrides(self, **over) -> "LogicalRules":
        new = [(name, over[name]) if name in over else (name, axes)
               for name, axes in self.rules]
        known = {n for n, _ in self.rules}
        new.extend((name, axes) for name, axes in over.items()
                   if name not in known)
        return LogicalRules(tuple(new))


def spec_for(logical_axes: Sequence[str | None], mesh,
             rules: LogicalRules | None = None) -> PartitionSpec:
    return (rules or LogicalRules()).spec(logical_axes, mesh)


def _filter_divisible(spec: PartitionSpec, shape: tuple[int, ...],
                      mesh) -> PartitionSpec:
    """Drop mesh axes that do not divide the corresponding dim (e.g. 4 KV
    heads cannot shard 16-way)."""
    sizes = axis_sizes(mesh)
    parts = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            parts.append(entry)
            continue
        cand = (entry,) if isinstance(entry, str) else tuple(entry)
        total = 1
        kept = []
        for a in cand:
            if shape[i] % (total * sizes[a]) == 0:
                kept.append(a)
                total *= sizes[a]
        parts.append(None if not kept else
                     (kept[0] if len(kept) == 1 else tuple(kept)))
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def sharding_for_shape(shape: tuple[int, ...],
                       logical_axes: Sequence[str | None], mesh,
                       rules: LogicalRules | None = None) -> PartitionSpec:
    """The spec with per-dim divisibility filtering (the reference returns
    it as a ``NamedSharding`` on ``mesh``)."""
    spec = spec_for(logical_axes, mesh, rules)
    return _filter_divisible(spec, tuple(int(s) for s in shape), mesh)


def is_replicated(spec: PartitionSpec, mesh) -> bool:
    """True when every mesh axis the spec names has size 1: each device
    holds the whole tensor."""
    sizes = axis_sizes(mesh)
    return all(sizes[a] == 1 for a in spec.mesh_axes())


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The spec as ``torch.distributed.tensor`` placements, one a mesh dim
    in the mesh's order: ``Shard(i)`` where the spec splits tensor dim
    ``i`` over that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for i, entry in enumerate(spec):
        if entry is not None:
            for a in (entry,) if isinstance(entry, str) else entry:
                where[a] = i
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_sizes(mesh))


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, in order (``()`` for ``None``)."""
    return (() if entry is None else
            (entry,) if isinstance(entry, str) else tuple(entry))


def block_of(entry, mesh, coord: dict) -> tuple[int, int]:
    """(block index, number of blocks) of a dim split by the spec entry
    ``entry``, for the process at mesh coordinate ``coord``: the first axis
    major."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * sizes[a] + int(coord[a])
        n *= sizes[a]
    return idx, n


def mesh_coord(mesh) -> dict[str, int]:
    """This process's coordinate on a ``DeviceMesh`` (``{axis: index}``);
    a geometry alone (a dict of sizes) has none and raises."""
    if isinstance(mesh, dict) or not hasattr(mesh, "get_coordinate"):
        raise TypeError(f"{type(mesh).__name__} has no process coordinate: "
                        "executing a sharded spec needs a DeviceMesh "
                        "(repro_torch.launch.mesh) and this process on it")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this process is not on the mesh")
    return dict(zip(axis_sizes(mesh), (int(c) for c in coord)))


def local_shard(x, spec: PartitionSpec, mesh, coord: dict | None = None):
    """This process's block of ``x`` (the whole array: a tensor or a numpy
    array) under ``spec``: a view where each split dim keeps its block.
    ``coord`` defaults to the process's own on ``mesh``."""
    coord = mesh_coord(mesh) if coord is None else coord
    for dim, entry in enumerate(spec):
        idx, n = block_of(entry, mesh, coord)
        if n > 1:
            size = x.shape[dim] // n
            x = x[(slice(None),) * dim + (slice(idx * size,
                                                (idx + 1) * size),)]
    return x


def local_copy(x, spec: PartitionSpec, mesh, coord: dict | None = None):
    """:func:`local_shard` of a tensor in memory of its own (contiguous), so
    nothing keeps the whole alive and updating it in place leaves ``x``
    as it was."""
    import torch
    return local_shard(x, spec, mesh, coord).clone(
        memory_format=torch.contiguous_format)


def gather_full(x, spec: PartitionSpec, mesh):
    """The whole array from every process's block ``x`` under ``spec`` (no
    gradient; collective over the axes ``spec`` names: each process of
    them calls it, in the same order); ``x`` itself where nothing is
    split."""
    from repro_torch.launch.mesh import mesh_groups
    from repro_torch.sharding.spmd import all_gather
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in entry_axes(entry) if sizes[a] > 1)
        if axes:
            x = all_gather(x, *mesh_groups(mesh).group(axes), dim)
    return x


def shard_params(tree, axes_tree, mesh, rules: LogicalRules | None = None):
    """The local block of every leaf of a tree of whole tensors, each
    leaf's spec from its logical axes (``axes_tree``, the tree of
    :func:`~repro_torch.models.layers.logical_axes`) and its shape: new
    tensors (a replicated leaf too), so updating them in place leaves
    ``tree`` as it was."""
    from repro_torch.models.layers import tree_map
    coord = mesh_coord(mesh)
    return tree_map(
        lambda t, ax: local_copy(
            t, sharding_for_shape(tuple(t.shape), ax, mesh, rules), mesh,
            coord), tree, axes_tree)


def constraint(x, logical_axes: Sequence[str | None], mesh=None,
               rules: LogicalRules | None = None):
    """The reference's ``with_sharding_constraint`` by logical axes, on a
    tensor every process holds whole: the identity off-mesh and where the
    spec replicates ``x``; on a ``DeviceMesh`` that splits it, this
    process's block (:func:`local_shard`).  A geometry without a process
    coordinate raises."""
    if mesh is None:
        return x
    spec = sharding_for_shape(tuple(x.shape), logical_axes, mesh, rules)
    if is_replicated(spec, mesh):
        return x
    return local_shard(x, spec, mesh)

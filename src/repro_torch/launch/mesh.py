"""Device meshes over ``torch.distributed`` (port of
:mod:`repro.launch.mesh`).

The reference builds ``jax.sharding.Mesh`` objects over the devices of one
process.  The port's model is SPMD over processes: one process per device,
and a mesh's flat device index is the process's rank in the default
process group.  A mesh is a :class:`torch.distributed.device_mesh.
DeviceMesh` whose dims are named after the traced axes; its device type
comes from the backend (NCCL means ``cuda``, gloo means ``cpu``).

Nothing here initializes a process group: the caller does, with its own
address, world size and rank (``dist.init_process_group("nccl",
store=dist.HashStore(), rank=0, world_size=1)`` for one card in one
process; ``"gloo"`` with a ``FileStore`` for CPU processes).  Without one,
every function here raises.

:class:`Submesh` is the process-group half of a placement of the mesh
sweep (:meth:`repro_torch.core.replay.ProxyProgram.mesh_sweep_plan`): the
groups a placement's collectives run on.

The data-parallel trainer (:mod:`repro_torch.train.loop`) and the
instrumented collectives on real tensors
(:func:`repro_torch.sharding.collectives.bind_mesh`) run on these meshes
too, over the groups of :func:`mesh_groups`, built once a mesh.
``make_production_mesh`` (256 devices, the multi-pod dry run) is not
ported yet: it comes with ``dryrun`` (ROADMAP, queue 1, item 12).
"""
from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the device type each backend runs tensors of
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def backend_device_type() -> str:
    """``"cuda"`` under NCCL, ``"cpu"`` under gloo; raises without an
    initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: initialize one first "
            "(dist.init_process_group('nccl' or 'gloo', ...)); the mesh "
            "functions never start one themselves")
    backend = str(dist.get_backend())
    if backend not in BACKEND_DEVICE:
        raise ValueError(f"backend {backend!r}: the mesh runs on "
                         f"{sorted(BACKEND_DEVICE)}")
    return BACKEND_DEVICE[backend]


def backend_device() -> torch.device:
    """The device this process runs the group's tensors on: the CPU under
    gloo, the current CUDA device under NCCL."""
    if backend_device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_tensor_backend(backend: str, device: torch.device) -> None:
    """NCCL runs CUDA tensors and gloo CPU tensors; anything else raises
    (no staging through the host)."""
    want = BACKEND_DEVICE.get(str(backend))
    if want is None or torch.device(device).type != want:
        raise RuntimeError(
            f"a {torch.device(device).type} tensor under a {backend} group: "
            f"{backend} runs {want} tensors here, and the port stages "
            "nothing through the host")


def _mk(shape: Sequence[int], names: Sequence[str], devices=None):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = backend_device_type()
    n = math.prod(int(s) for s in shape)
    ranks = list(range(n)) if devices is None else [int(d) for d in devices]
    world = dist.get_world_size()
    if len(ranks) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} "
                         f"devices, got {len(ranks)}")
    if ranks and (min(ranks) < 0 or max(ranks) >= world):
        raise ValueError(f"devices {ranks} outside the world of {world} "
                         "processes")
    return DeviceMesh(device_type,
                      torch.tensor(ranks, dtype=torch.int64).reshape(
                          tuple(int(s) for s in shape)),
                      mesh_dim_names=tuple(names))


def make_test_mesh(data: int = 2, model: int = 2):
    """Small 2-D mesh for tests."""
    return _mk((data, model), ("data", "model"))


def make_dp_mesh(n: int):
    return _mk((n,), ("data",))


def make_replay_mesh(axis_sizes: dict[str, int], devices=None):
    """Mesh whose dims mirror a traced program's ``axis_sizes``: the shape a
    synthesized proxy's ``DeviceComm`` collectives expect.

    ``devices`` restricts the mesh to a subset of process ranks; by default
    ranks ``0 .. n-1`` back it, so the axis sizes must multiply out to at
    most the world size.  Shrink a traced geometry onto fewer devices with
    :func:`repro_torch.core.replay.submesh_axis_sizes` first.  Every process
    of the world calls this, in the same order (the mesh creates process
    groups)."""
    return _mk(tuple(axis_sizes.values()), tuple(axis_sizes), devices)


def mesh_ranks(mesh) -> tuple[int, ...]:
    """The mesh's process ranks in flat (row-major) device order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


class Submesh:
    """A placement's devices as process groups.

    ``ranks`` are global process ranks, row-major over ``axis_sizes``.  For
    each tuple of axes in ``axes_sets`` (the axes the program's collectives
    span), one process group per class of devices that agree on every
    other axis, created with :func:`torch.distributed.new_group`.  Every
    process of the world must build the same submeshes in the same order,
    members or not: that is what ``new_group`` requires."""

    def __init__(self, ranks: Sequence[int], axis_sizes: dict[str, int],
                 axes_sets: Sequence[tuple[str, ...]]):
        self.ranks = tuple(int(r) for r in ranks)
        self.axis_sizes = dict(axis_sizes)
        names = list(self.axis_sizes)
        sizes = [int(self.axis_sizes[a]) for a in names]
        if math.prod(sizes) != len(self.ranks):
            raise ValueError(f"submesh {self.axis_sizes} over "
                             f"{len(self.ranks)} devices")
        me = dist.get_rank()
        self.backend = str(dist.get_backend())
        self._groups: dict[tuple[str, ...], tuple] = {}
        grid = np.arange(len(self.ranks)).reshape(sizes)
        for axes in axes_sets:
            axes = tuple(axes)
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            span = math.prod(sizes[d] for d in dims)
            for row in grid.transpose(rest + dims).reshape(-1, span):
                # members in the collective's own linear order over ``axes``
                members = tuple(self.ranks[i] for i in row)
                pg = dist.new_group(sorted(members))
                if me in members:
                    self._groups[axes] = (pg, members)

    def group(self, axes) -> tuple:
        """``(process group, members)`` of this process for a collective
        over ``axes``; ``members`` in the order of the axes' linear index."""
        key = tuple(axes)
        if key not in self._groups:
            raise KeyError(f"no process group over {key} for this process "
                           f"(submesh {self.axis_sizes} over {self.ranks})")
        return self._groups[key]


def mesh_groups(mesh) -> Submesh:
    """``mesh``'s process groups as a :class:`Submesh` over all its devices,
    with a group for every ordered set of its axes.  Built on the first
    call for a mesh object and kept on it: that first call is collective
    (every process of the world makes it, for its own copy of the mesh, in
    the same order as its other group-building calls)."""
    sub = getattr(mesh, "_repro_groups", None)
    if sub is None:
        names = tuple(str(n) for n in mesh.mesh_dim_names)
        sizes = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
        sets = [p for k in range(1, len(names) + 1)
                for p in itertools.permutations(names, k)]
        sub = Submesh(mesh_ranks(mesh), sizes, sets)
        mesh._repro_groups = sub
    return sub

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

The trainer and the serve engine (:mod:`repro_torch.train.loop`,
:mod:`repro_torch.serve.engine`: data-parallel, tensor-parallel and FSDP
through :mod:`repro_torch.sharding.spmd`) and the instrumented collectives
on real tensors (:func:`repro_torch.sharding.collectives.bind_mesh`) run on
these meshes too, over the groups of :func:`mesh_groups`, built once a
mesh.

:func:`make_production_mesh` is the reference's production mesh (16 × 16
over ``("data", "model")``, or 2 × 16 × 16 with ``"pod"``).  On a cluster
it runs over NCCL like every other mesh here.  The dry run
(:mod:`repro_torch.launch.dryrun`) builds it in one process that plays
rank 0 of the whole world through torch's fake backend
(:func:`fake_world`: ``dist.init_process_group("fake", ...)``), whose
tensors are meta tensors and whose collectives return at once: the
backend ``"fake"`` runs ``meta`` tensors, as NCCL runs ``cuda`` and gloo
``cpu`` ones, and nothing is staged between them.

**One opt-in: CUDA tensors over gloo.**  ``make_test_mesh(...,
device="cuda")`` builds a mesh whose tensors live on the current CUDA
device under a gloo group: NCCL refuses two processes on one card
("Duplicate GPU detected"), and gloo's all-reduce takes CUDA tensors
(staged through the host).  Only the sharded model code's collectives
(:mod:`repro_torch.sharding.spmd`) and the trainer's run there:
``chip_smoke.py`` uses it to run two processes of a ``model`` axis on one
card.  A mesh's device type is otherwise its backend's, and ``device=``
other than that raises under any backend but gloo; NCCL stays the card's
production backend.  The replay tier's collectives
(:mod:`repro_torch.sharding.collectives`) take only what their backend
runs (:func:`check_tensor_backend`).
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

#: the device type each backend runs tensors of (``fake``: the dry run's
#: world of one process, :func:`fake_world`)
BACKEND_DEVICE = {"nccl": "cuda", "gloo": "cpu", "fake": "meta"}


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


def check_tensor_backend(backend: str, device: torch.device) -> None:
    """NCCL runs CUDA tensors and gloo CPU tensors; anything else raises
    (no staging through the host)."""
    want = BACKEND_DEVICE.get(str(backend))
    if want is None or torch.device(device).type != want:
        raise RuntimeError(
            f"a {torch.device(device).type} tensor under a {backend} group: "
            f"{backend} runs {want} tensors here, and the port stages "
            "nothing through the host")


def _mk(shape: Sequence[int], names: Sequence[str], devices=None,
        device: str | None = None):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = backend_device_type()
    if device is not None and str(device) != device_type:
        if str(device) != "cuda" or str(dist.get_backend()) != "gloo":
            raise ValueError(f"a {device} mesh under {dist.get_backend()}: "
                             "only gloo may carry CUDA tensors (the opt-in "
                             "of make_test_mesh)")
        device_type = "cuda"
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


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 = 256 devices a pod; multi-pod adds the 2-pod leading axis
    (the reference's shapes and axis names).  Needs a world of 256 (512)
    processes: NCCL on a cluster, or :func:`fake_world` for the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A process group of ``world_size`` processes in which this process
    plays rank 0 alone: torch's fake backend (its tensors are meta
    tensors, its collectives return at once).  Destroyed on exit; raises
    where a process group is already initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "fake world needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_test_mesh(data: int = 2, model: int = 2,
                   device: str | None = None):
    """Small 2-D mesh for tests.  ``device="cuda"`` under gloo is the
    opt-in of the module docstring: the mesh's tensors on the current CUDA
    device."""
    return _mk((data, model), ("data", "model"), device=device)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's tensors live on: its device type (the backend's,
    or CUDA by the gloo opt-in), the current CUDA device for CUDA."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


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

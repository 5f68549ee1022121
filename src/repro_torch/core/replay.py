"""Proxy replay engine + fidelity measurement (paper §3.3).

Port of :mod:`repro.core.replay`: replay under ``LocalSim``, seeded noisy
replicas, and the mesh-sharded sweep on ``torch.distributed``.

``rep`` is the run-length replay primitive used by generated code: small
exponents unroll, large ones become a counted loop, so the walker costs a
loop that ran 10^6 times in one walk of its body — the grammar's a^i
symbols.

:class:`ProxyProgram` wraps a generated module:

  * ``run_local(ranks)`` replays ranks one at a time;
  * ``run_all(ranks)`` replays by control-flow signature group (the module
    precomputes ``SIGNATURE_GROUPS``): with the shared seed, every rank of
    a group is the same program on the same state, so the group runs once
    and its ranks share the result; with ``per_rank_seeds`` the group's
    states are stacked on a leading rank axis and replayed in one pass (the
    reference's ``vmap``);
  * ``run_all(ranks, mesh=...)`` is the **mesh-sharded sweep**: signature
    groups are placed on disjoint device subsets of a
    :class:`~torch.distributed.device_mesh.DeviceMesh`
    (:func:`plan_mesh_sweep`, driven by the per-group device hints the
    generated module carries) and replay their real collectives through
    :class:`~repro_torch.sharding.collectives.DeviceComm`, a group's stacked
    states in one pass.  The process model is SPMD: every process of the
    world (the default process group, whose broadcasts and barrier the
    sweep uses, not only the mesh's processes) calls ``run_all(mesh=...)``
    with the same arguments, runs the placements that hold its rank, and
    receives every other placement's result by a broadcast from that
    placement's first process;
  * ``time_local(rank)`` times one rank's replay;
  * ``rank_metrics(rank)`` walks the generated code with the same cost
    walker used on the original program (cached per signature);
  * ``fidelity(original)`` computes δ̄ = mean_{m,p} |A-B|/A (paper eq. 8);
  * ``noise=NoiseConfig(...)`` on ``run_all``, ``time_all`` and
    ``fidelity`` replays ``n_replicas`` seeded noisy replicas of each
    signature group, stacked on a leading replica axis in one pass (see
    :mod:`repro_torch.core.noise`); ``fidelity`` then returns a
    :class:`~repro_torch.core.noise.FidelityDistribution`.

State lives on ``device``: ``None`` means the CUDA card, where blocks 1
and 3 run as the hand-written kernels.  Replay is eager PyTorch, so there
is no compile step; the caches keep one bound program per (signature, comm
backend, state shapes), plus the placement in mesh mode, and one walker
measurement per (signature, state shapes), and ``cache_stats()`` reports
them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import blocks
from repro_torch.core import noise as noise_mod
from repro_torch.core import proxy_search
from repro_torch.core.events import Event, METRIC_NAMES, N_METRICS, is_comm
from repro_torch.core.noise import (FidelityDistribution,  # noqa: F401
                                    NoiseConfig)
from repro_torch.core.metrics import torch_dtype
from repro_torch.core.tracer import counted_loop, trace_fn
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding.collectives import DeviceComm, LocalSim

#: Exponents up to this unroll; above it ``rep`` runs a counted loop (one
#: walk of the body regardless of n).  Shared with the program-table
#: lowering in :mod:`repro_torch.core.progtable`.
REP_UNROLL_THRESHOLD = 4


def rep(fn, n: int, st: dict, comm) -> dict:
    """Repeat ``fn`` n times: unrolled when small, a counted loop otherwise."""
    if n <= REP_UNROLL_THRESHOLD:
        for _ in range(n):
            st = fn(st, comm)
        return st
    return counted_loop(n, lambda s: fn(s, comm), st)


def load_saved_module(path, name: str | None = None):
    """Re-import a previously generated proxy module from disk."""
    path = Path(path)
    name = name or path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mod.__proxy_path__ = str(path)
    return mod


def load_module(source: str, name: str = "generated_proxy",
                out_dir: str | Path | None = None):
    """Write generated source to a file and import it as a module."""
    out_dir = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(prefix="proxy_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.py"
    path.write_text(source)
    return load_saved_module(path, name)


def init_replay_state(module, seed: int = 0, device=None) -> dict:
    """Block state + the generated module's comm buffer pool, on ``device``
    (``None``: the CUDA card)."""
    st = blocks.init_state(seed, device)
    dev = st["a"].device
    for bname, (shape, dtype) in module.COMM_BUFFERS.items():
        st[bname] = torch.full(tuple(shape), 0.5, dtype=torch_dtype(dtype),
                               device=dev)
    return st


def stack_states(states: Sequence[dict]) -> dict:
    """Stack per-rank states on a new leading rank axis."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


# ---------------------------------------------------------------------------
# mesh sweep scheduling (copied from the reference's replay.py:121-262: pure
# Python over hints and sizes, so its plans are the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    """One signature group pinned to a mesh device subset.

    ``device_ids`` are flat indices into the mesh's devices; ``axis_sizes``
    is the group's sub-mesh geometry (same axis names as the traced
    program, sizes shrunk to the subset).  Hashable: a cache-key component,
    so bound programs and process groups are kept *per placement*."""
    sig: tuple
    ranks: tuple[int, ...]
    device_ids: tuple[int, ...]
    axis_sizes: tuple[tuple[str, int], ...]

    @property
    def n_devices(self) -> int:
        return len(self.device_ids)

    def key(self) -> tuple:
        return (self.device_ids, self.axis_sizes)


def submesh_axis_sizes(n_devices: int, axis_sizes: dict[str, int],
                       ) -> dict[str, int]:
    """Shrink a traced mesh geometry onto ``n_devices``.

    Keeps the axis names and order; each axis gets ``gcd(traced_size,
    devices_still_unassigned)`` so the product always divides ``n_devices``
    exactly and every collective still spans a nonempty axis.  A comm-free
    program (no traced axes) gets a single unit axis so it has a mesh to
    run under.
    """
    out: dict[str, int] = {}
    rem = max(int(n_devices), 1)
    for a, s in axis_sizes.items():
        g = math.gcd(max(int(s), 1), rem)
        out[a] = g
        rem //= g
    if not out:
        out = {"x": 1}
    return out


def _proportional_alloc(want: Sequence[int], n_devices: int,
                        axis_sizes: dict[str, int],
                        ) -> tuple[list[int], list[int]]:
    """Hint-proportional contiguous device shares (requires
    ``len(want) <= n_devices``); returns (alloc, starts)."""
    total = sum(want)
    alloc = [min(w, max(1, (n_devices * w) // total)) for w in want]
    # bumping zero-share groups to 1 device can oversubscribe the mesh;
    # shave the largest shares back until the plan fits
    while sum(alloc) > n_devices:
        i = alloc.index(max(alloc))
        alloc[i] -= 1
    # hand leftovers to the groups furthest below their hint
    while sum(alloc) < n_devices:
        gaps = [w - a for w, a in zip(want, alloc)]
        if max(gaps) <= 0:
            break
        i = gaps.index(max(gaps))
        alloc[i] += 1
    # shrink each share to the largest realizable sub-mesh size
    alloc = [_realizable(a, axis_sizes) for a in alloc]
    starts = []
    cur = 0
    for a in alloc:
        starts.append(cur)
        cur += a
    return alloc, starts


def plan_mesh_sweep(groups: Sequence[tuple[tuple, Sequence[int]]],
                    hints: dict[tuple, int],
                    axis_sizes: dict[str, int],
                    n_devices: int,
                    share_unit_groups: bool = False) -> list[GroupPlacement]:
    """Partition ``n_devices`` mesh devices among signature groups.

    Pure function of its inputs (deterministic; no device state touched):

    * every group gets at least one device and never more than its hint;
    * shares are proportional to the per-group device hints, leftovers go
      to the groups furthest below their hint;
    * device subsets are contiguous and disjoint while supply lasts; with
      more groups than devices, groups wrap round-robin onto single devices
      (their replays then serialize per device, which is still correct);
    * each subset is trimmed to the realizable sub-mesh size
      (:func:`submesh_axis_sizes`), so the placement's geometry always
      multiplies out to exactly ``len(device_ids)``;
    * with ``share_unit_groups=True``, two or more unit-hint groups are
      packed onto **one shared device** when demand exceeds supply, and the
      freed devices go to groups still below their hint.
    """
    n_devices = max(int(n_devices), 1)
    groups = [(sig, list(rs)) for sig, rs in groups]
    if not groups:
        return []
    want = [max(int(hints.get(sig, 1)), 1) for sig, _ in groups]
    n = len(groups)
    if n >= n_devices:
        alloc = [1] * n
        starts = [i % n_devices for i in range(n)]
    else:
        unit = [i for i, w in enumerate(want) if w == 1]
        big = [i for i, w in enumerate(want) if w > 1]
        if share_unit_groups and len(unit) >= 2 and big \
                and n_devices >= 2 and sum(want) > n_devices:
            big_alloc, big_starts = _proportional_alloc(
                [want[i] for i in big], n_devices - 1, axis_sizes)
            alloc = [1] * n
            starts = [n_devices - 1] * n     # unit groups share the last dev
            for i, a, s0 in zip(big, big_alloc, big_starts):
                alloc[i] = a
                starts[i] = s0
        else:
            alloc, starts = _proportional_alloc(want, n_devices, axis_sizes)
    out = []
    for (sig, rs), a, s0 in zip(groups, alloc, starts):
        out.append(GroupPlacement(
            sig=sig, ranks=tuple(rs),
            device_ids=tuple(range(s0, s0 + a)),
            axis_sizes=tuple(submesh_axis_sizes(a, axis_sizes).items())))
    return out


def _realizable(n_devices: int, axis_sizes: dict[str, int]) -> int:
    """Largest ``v <= n_devices`` whose sub-mesh geometry multiplies out to
    exactly ``v`` (1 always qualifies)."""
    for v in range(max(int(n_devices), 1), 0, -1):
        p = 1
        for s in submesh_axis_sizes(v, axis_sizes).values():
            p *= s
        if p == v:
            return v
    return 1


@dataclasses.dataclass
class FidelityReport:
    """Per-(metric, rank) relative errors (paper Table 3 / Fig. 4)."""
    delta: np.ndarray          # (n_metrics, n_ranks)
    comm_lossless: bool        # event-id sequences reproduced exactly
    mean: float                # δ̄, paper eq. 8
    mesh_checked: bool = False  # a mesh-sharded sweep ran, every leaf finite
    seed: int = 0              # replay seed provenance (deterministic: 0)
    n_replicas: int = 1        # deterministic replay is one replica

    def heatmap_csv(self) -> str:
        lines = ["metric," + ",".join(f"rank{p}"
                                      for p in range(self.delta.shape[1]))]
        for m, name in enumerate(METRIC_NAMES):
            lines.append(name + "," + ",".join(f"{v:.4f}"
                                               for v in self.delta[m]))
        return "\n".join(lines)

    def to_csv(self) -> str:
        """Heatmap CSV with seed/replica provenance headers, parseable by
        :func:`repro_torch.core.noise.parse_fidelity_csv` like
        :meth:`FidelityDistribution.to_csv`."""
        return (f"# seed={self.seed}\n# n_replicas={self.n_replicas}\n"
                + self.heatmap_csv())


class ProxyProgram:
    """A synthesized proxy-app: source + module + replay/fidelity methods."""

    def __init__(self, source: str, module, merged, combos,
                 axis_sizes: dict[str, int] | None = None, device=None):
        self.source = source
        self.module = module
        self.merged = merged
        self.combos = combos
        self.axis_sizes = dict(axis_sizes or {})
        self.device = resolve_device(device)
        self._compiled: dict = {}          # (sig, comm, shapes) -> per-rank fn
        self._compiled_mesh: dict = {}     # (sig, placement, ...) -> fn
        self._metrics_cache: dict = {}     # (sig, shapes) -> np.ndarray
        self._mesh_comms: dict = {}        # (mesh ranks, placement) -> comm
        self._sig_by_rank: dict | None = None
        self._shapes_key_cache = None
        self._counters = {"programs_bound": 0, "metric_traces": 0,
                          "batch_cache_hits": 0, "batch_cache_misses": 0}

    # -- signature grouping ----------------------------------------------------

    def signature_of(self, rank: int):
        """Control-flow signature of ``rank`` (hashable cache key)."""
        if self._sig_by_rank is None:
            self._sig_by_rank = {r: g[0] for g in self.module.SIGNATURE_GROUPS
                                 for r in g[1]}
        return self._sig_by_rank[rank]

    def _validate_ranks(self, ranks: Sequence[int]) -> None:
        bad = [r for r in ranks if not 0 <= r < self.merged.n_ranks]
        if bad:
            raise ValueError(f"ranks out of range: {bad} "
                             f"(proxy has {self.merged.n_ranks} ranks)")

    def signature_groups(self, ranks: Sequence[int] | None = None,
                         ) -> list[tuple[tuple, list[int]]]:
        """(signature, ranks) pairs covering ``ranks`` (default: all), from
        the module's ``SIGNATURE_GROUPS`` (entries ``(sig, ranks, hint)``)."""
        groups = self.module.SIGNATURE_GROUPS
        if ranks is None:
            return [(g[0], list(g[1])) for g in groups]
        want = set(ranks)
        out = [(g[0], [r for r in g[1] if r in want]) for g in groups]
        out = [(sig, rs) for sig, rs in out if rs]
        missing = want - {r for _, rs in out for r in rs}
        if missing:
            raise ValueError(
                f"ranks not in any signature group: {sorted(missing)} "
                f"(proxy has {self.merged.n_ranks} ranks)")
        return out

    def _shapes_key(self) -> tuple:
        """State-shape fingerprint: part of every cache key."""
        if self._shapes_key_cache is None:
            st = init_replay_state(self.module, device="meta")
            self._shapes_key_cache = tuple(
                sorted((k, tuple(v.shape), str(v.dtype)) for k, v in st.items()))
        return self._shapes_key_cache

    def init_state(self, seed: int = 0) -> dict:
        return init_replay_state(self.module, seed, self.device)

    # -- execution -------------------------------------------------------------

    @staticmethod
    def _comm_key(comm):
        """Cache component for the comm backend: plain LocalSims are
        interchangeable; anything else is keyed by identity."""
        return LocalSim if type(comm) is LocalSim else id(comm)

    def _fn_for_rank(self, rank: int, comm):
        sig = self.signature_of(rank)
        key = (sig, self._comm_key(comm), self._shapes_key())
        fn = self._compiled.get(key)
        if fn is None:
            mod = self.module
            self._counters["programs_bound"] += 1

            def fn(st, _rank=rank):
                return mod.run_rank(st, comm, _rank)

            self._compiled[key] = fn
        return fn

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- mesh-sharded sweep (device-parallel signature groups) -----------------

    def group_device_hints(self) -> dict[tuple, int]:
        """Per-signature device-count hints from the generated module.

        Modules generated before the hint metadata (2-tuple groups) fall
        back to the full traced mesh size, the span every collective would
        need in the worst case."""
        default = 1
        for s in self.axis_sizes.values():
            default *= max(int(s), 1)
        out: dict[tuple, int] = {}
        for g in getattr(self.module, "SIGNATURE_GROUPS", None) or ():
            out[g[0]] = int(g[2]) if len(g) > 2 else default
        return out

    def mesh_sweep_plan(self, mesh, ranks: Sequence[int] | None = None,
                        share_unit_groups: bool = True,
                        ) -> list[GroupPlacement]:
        """Deterministic placement of signature groups onto ``mesh``'s
        devices (see :func:`plan_mesh_sweep`).  Unit-hint groups share one
        device by default instead of idling devices each."""
        return plan_mesh_sweep(self.signature_groups(ranks),
                               self.group_device_hints(), self.axis_sizes,
                               len(mesh_mod.mesh_ranks(mesh)),
                               share_unit_groups=share_unit_groups)

    def _mesh_check(self, mesh) -> tuple[int, ...]:
        """The mesh's process ranks; raises without a process group or
        when the mesh's devices are not this program's."""
        dt = mesh_mod.backend_device_type()
        if dt != self.device.type or mesh.device_type != dt:
            raise ValueError(
                f"a {mesh.device_type} mesh under a {dt} backend for a proxy "
                f"on {self.device}: the mesh, the backend and the proxy's "
                "device must agree (NCCL: cuda, gloo: cpu)")
        return mesh_mod.mesh_ranks(mesh)

    def _submesh_for(self, mesh, placement: GroupPlacement):
        """The placement's process groups over the axes the program's
        collectives span.  Every process builds every placement's groups in
        plan order, which ``torch.distributed.new_group`` requires;
        :meth:`_mesh_comm` keeps them."""
        ranks = mesh_mod.mesh_ranks(mesh)
        axes_sets = sorted({tuple(ev.axes) for ev in self.merged.table.events
                            if is_comm(ev)})
        return mesh_mod.Submesh([ranks[i] for i in placement.device_ids],
                                dict(placement.axis_sizes), axes_sets)

    def _mesh_comm(self, mesh, placement: GroupPlacement) -> DeviceComm:
        """One DeviceComm per (mesh devices, placement): its ``axis_sizes``
        are the sub-mesh geometry, and its process groups are created once."""
        key = (mesh_mod.mesh_ranks(mesh), placement.key())
        comm = self._mesh_comms.get(key)
        if comm is None:
            comm = DeviceComm(self._submesh_for(mesh, placement))
            self._mesh_comms[key] = comm
        return comm

    def _fn_for_group_mesh(self, sig, rep_rank: int,
                           placement: GroupPlacement, mesh,
                           noise: bool = False):
        """The bound replay of one placed group over its DeviceComm, for
        one state or a stack alike.  Cached per (signature, mesh devices,
        placement, noise, state shapes); ``noise=True`` settles the
        replicas' draws after the replay."""
        key = (sig, noise, mesh_mod.mesh_ranks(mesh), placement.key(),
               self._shapes_key())
        fn = self._compiled_mesh.get(key)
        if fn is None:
            self._counters["batch_cache_misses"] += 1
            mod = self.module
            comm = self._mesh_comm(mesh, placement)

            def fn(st, _rank=rep_rank):
                out = mod.run_rank(st, comm, _rank)
                return noise_mod.settle(out) if noise else out

            self._compiled_mesh[key] = fn
        else:
            self._counters["batch_cache_hits"] += 1
        return fn

    def _group_work_mesh(self, ranks, seed: int, per_rank_seeds: bool,
                         mesh, batched: bool = True,
                         noise: NoiseConfig | None = None) -> list[tuple]:
        """``(fn, input_state, group_ranks, stacked, member, src)`` units of
        a mesh sweep, in plan order.

        ``batched=True`` emits one unit per signature group: its ranks'
        states stacked on a leading axis through the real collectives (or,
        with a shared seed, the program once, its result shared).
        ``batched=False`` is the sequential mesh baseline: one unit per
        rank on the *same* placement.  ``noise=`` stacks seeded replicas
        instead of ranks.  ``member`` says whether this process runs the
        unit; ``src`` is the process that broadcasts its result."""
        mesh_ranks = self._mesh_check(mesh)
        me = dist.get_rank()
        work = []
        for pl in self.mesh_sweep_plan(mesh, ranks):
            grp = list(pl.ranks)
            procs = [mesh_ranks[i] for i in pl.device_ids]
            unit = (me in procs, procs[0])
            fn = self._fn_for_group_mesh(pl.sig, grp[0], pl, mesh,
                                         noise=noise is not None)
            if noise is not None:
                work.append((fn, self._noise_group_state(grp[0], noise, seed),
                             grp, False) + unit)
            elif batched and per_rank_seeds:
                stacked = stack_states([self.init_state(seed + r)
                                        for r in grp])
                work.append((fn, stacked, grp, True) + unit)
            elif batched:
                work.append((fn, self.init_state(seed), grp, False) + unit)
            else:
                for r in grp:
                    st = self.init_state(seed + r if per_rank_seeds else seed)
                    work.append((fn, st, [r], False) + unit)
        return work

    def _share(self, res: dict | None, template: dict, src: int) -> dict:
        """Broadcast a unit's result from process ``src`` to every process:
        its leaves' bytes in one buffer, rebuilt on the receivers from the
        input state's shapes and dtypes (a replay keeps both)."""
        keys = sorted(template)
        if dist.get_rank() == src:
            flat = torch.cat([res[k].contiguous().reshape(-1)
                              .view(torch.uint8) for k in keys])
        else:
            n = sum(template[k].numel() * template[k].element_size()
                    for k in keys)
            flat = torch.empty(n, dtype=torch.uint8, device=self.device)
        dist.broadcast(flat, src)
        out, off = {}, 0
        for k in keys:
            t = template[k]
            nb = t.numel() * t.element_size()
            out[k] = flat[off:off + nb].clone().view(t.dtype).reshape(t.shape)
            off += nb
        return out

    def _run_all_mesh(self, ranks, seed: int, batched: bool,
                      per_rank_seeds: bool, mesh,
                      noise: NoiseConfig | None = None) -> dict[int, dict]:
        """Mesh-sharded sweep body: every process runs the units it is a
        member of (placements on disjoint processes run at once), then each
        unit's result is broadcast from its placement's first process, in
        plan order, and unstacked."""
        units = self._group_work_mesh(ranks, seed, per_rank_seeds, mesh,
                                      batched, noise)
        results = [fn(arg) if member else None
                   for fn, arg, _, _, member, _ in units]
        out: dict[int, dict] = {}
        for res, (_, arg, grp, stacked, _, src) in zip(results, units):
            res = self._share(res, arg, src)
            if stacked:
                for i, r in enumerate(grp):
                    out[r] = {k: v[i] for k, v in res.items()}
            else:
                for r in grp:
                    out[r] = dict(res)
        self._sync()
        return out

    def run_local(self, ranks: Sequence[int] | None = None, seed: int = 0,
                  comm=None) -> dict:
        """Replay ranks sequentially; returns the final state of the last."""
        comm = comm or LocalSim()
        if ranks is None:
            ranks = range(self.merged.n_ranks)
        else:
            self._validate_ranks(ranks)
        st = self.init_state(seed)
        out = st
        for r in ranks:
            out = self._fn_for_rank(r, comm)(st)
        self._sync()
        return out

    def run_all(self, ranks: Sequence[int] | None = None, seed: int = 0,
                comm=None, batched: bool = True,
                per_rank_seeds: bool = False, mesh=None,
                noise: NoiseConfig | None = None) -> dict[int, dict]:
        """Replay every rank; returns ``{rank: final state}``.

        ``batched=True`` replays one signature group per pass: with the
        shared seed the group's program runs once and every rank of the
        group gets its own dict over the same result tensors (replay never
        writes a tensor in place, so the sharing is not observable as
        cross-rank mutation); with ``per_rank_seeds=True`` each rank starts
        from ``seed + rank``, the group's states are stacked on a leading
        axis and replayed in one pass.  ``batched=False`` is the per-rank
        baseline with identical results.

        ``mesh=`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`,
        :func:`~repro_torch.launch.mesh.make_replay_mesh`) switches to the
        **mesh-sharded sweep**: signature groups are placed on disjoint
        device subsets (:meth:`mesh_sweep_plan`) and execute their real
        collectives through :class:`DeviceComm`.  Every process of the
        world calls it with the same arguments (SPMD: the results are
        broadcast over the default process group, so a process outside the
        mesh calls it too) and gets every rank's state.  ``comm`` is ignored in mesh mode; ``batched=False`` gives
        the sequential mesh baseline (one pass per rank on the same
        placement).  Without an initialized process group it raises.

        ``noise=NoiseConfig(...)`` replays ``n_replicas`` seeded noisy
        replicas of each group, stacked on a leading axis in one pass
        (``noise=None`` runs the deterministic program unchanged).  Every
        leaf of a rank's result then carries the replica axis; ranks of a
        group share the replicas (the noise models run-level platform
        state, not per-rank jitter), and the
        :data:`~repro_torch.core.noise.NOISE_COMPUTE` /
        :data:`~repro_torch.core.noise.NOISE_COMM` leaves hold the
        perturbed cost accumulators :meth:`fidelity` summarizes."""
        if ranks is not None:
            self._validate_ranks(ranks)
        _check_noise(noise, batched, per_rank_seeds)
        if mesh is not None:
            return self._run_all_mesh(ranks, seed, batched, per_rank_seeds,
                                      mesh, noise)
        comm = comm or LocalSim()
        out: dict[int, dict] = {}
        if not batched:
            st = None if per_rank_seeds else self.init_state(seed)
            for r in (range(self.merged.n_ranks) if ranks is None else ranks):
                out[r] = self._fn_for_rank(r, comm)(
                    self.init_state(seed + r) if per_rank_seeds else st)
            self._sync()
            return out
        for fn, arg, grp in self._group_work(ranks, seed, comm, per_rank_seeds,
                                             noise):
            res = fn(arg)
            if per_rank_seeds:
                for i, r in enumerate(grp):
                    out[r] = {k: v[i] for k, v in res.items()}
            else:   # one result for the group (noisy replicas too)
                for r in grp:
                    out[r] = dict(res)
        self._sync()
        return out

    def _noise_group_state(self, rep_rank: int, cfg: NoiseConfig,
                           seed: int = 0) -> dict:
        """``n_replicas`` noise-attached copies of one group's initial state,
        stacked on a leading replica axis.  Replica keys derive only from
        ``(cfg.seed, group representative, replica index)``."""
        base = self.init_state(seed)
        return stack_states([
            noise_mod.attach(base, noise_mod.replica_key(
                cfg.seed, rep_rank, j, self.device))
            for j in range(cfg.n_replicas)])

    def _group_work(self, ranks, seed: int, comm, per_rank_seeds: bool,
                    noise: NoiseConfig | None = None) -> list[tuple]:
        """One ``(fn, input_state, group_ranks)`` unit per signature group —
        the shared plan of :meth:`run_all` and :meth:`time_all`.  With
        ``noise=``, a unit replays the group's stacked noisy replicas and
        settles their draws (:func:`~repro_torch.core.noise.settle`)."""
        if noise is not None:
            work = []
            for sig, grp in self.signature_groups(ranks):
                fn = self._fn_for_rank(grp[0], comm)
                work.append((lambda st, fn=fn: noise_mod.settle(fn(st)),
                             self._noise_group_state(grp[0], noise, seed),
                             grp))
            return work
        st = None if per_rank_seeds else self.init_state(seed)
        work = []
        for sig, grp in self.signature_groups(ranks):
            fn = self._fn_for_rank(grp[0], comm)
            if per_rank_seeds:
                stacked = stack_states([self.init_state(seed + r) for r in grp])
                work.append((fn, stacked, grp))
            else:
                work.append((fn, st, grp))
        return work

    def time_local(self, rank: int = 0, iters: int = 1, seed: int = 0
                   ) -> float:
        """Warm wall-clock seconds of one rank's replay under ``LocalSim``
        (synchronized with the card after each run; the first run warms
        up)."""
        self._validate_ranks([rank])
        fn = self._fn_for_rank(rank, LocalSim())
        st = self.init_state(seed)
        fn(st)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(st)
            self._sync()
        return (time.perf_counter() - t0) / iters

    def time_all(self, ranks: Sequence[int] | None = None, iters: int = 1,
                 seed: int = 0, batched: bool = True,
                 per_rank_seeds: bool = False, mesh=None,
                 noise: NoiseConfig | None = None) -> float:
        """Warm wall-clock seconds of one full multi-rank replay sweep, in
        :meth:`run_all`'s modes, the noisy replicas among them (the states
        are built before the clock).  With ``mesh=``, each process times
        the placements it runs, and the sweep ends at a barrier of every
        process of the world, so each calls it (no result is broadcast)."""
        ranks = list(range(self.merged.n_ranks) if ranks is None else ranks)
        self._validate_ranks(ranks)
        _check_noise(noise, batched, per_rank_seeds)
        comm = LocalSim()
        if mesh is not None:
            work = [(fn, arg) for fn, arg, _, _, member, _ in
                    self._group_work_mesh(ranks, seed, per_rank_seeds, mesh,
                                          batched, noise) if member]
        elif batched:
            work = [(fn, arg) for fn, arg, _ in
                    self._group_work(ranks, seed, comm, per_rank_seeds,
                                     noise)]
        else:
            st = None if per_rank_seeds else self.init_state(seed)
            work = [(self._fn_for_rank(r, comm),
                     self.init_state(seed + r) if per_rank_seeds else st)
                    for r in ranks]

        def sweep():
            for fn, arg in work:
                fn(arg)
            self._sync()
            if mesh is not None:
                dist.barrier()

        sweep()  # warm-up (first use builds the kernels)
        t0 = time.perf_counter()
        for _ in range(iters):
            sweep()
        return (time.perf_counter() - t0) / iters

    def cache_stats(self) -> dict[str, int]:
        """Bound-program and walker-measurement counters; the mesh sweep's
        bound programs count per placement (``batch_cache_hits`` and
        ``batch_cache_misses``)."""
        return dict(self._counters,
                    compiled_per_rank=len(self._compiled),
                    compiled_mesh=len(self._compiled_mesh),
                    cached_metric_groups=len(self._metrics_cache))

    # -- measurement -------------------------------------------------------------

    def rank_metrics(self, rank: int, use_cache: bool = True) -> np.ndarray:
        """Walker-measured 6-metric total of this rank's generated program
        (cached per signature: ranks of a group run the same program)."""
        key = (self.signature_of(rank), self._shapes_key())
        if use_cache and key in self._metrics_cache:
            return self._metrics_cache[key]
        st = init_replay_state(self.module, device="meta")
        comm = LocalSim()
        self._counters["metric_traces"] += 1
        tr = trace_fn(lambda s: self.module.run_rank(s, comm, rank), st)
        out = tr.total_compute()
        self._metrics_cache[key] = out
        return out

    def group_program_sizes(self) -> dict[tuple, int]:
        """The program's own size per signature group: the table entries
        the group's ``run_rank`` walks (its symbol sequence, the body of
        every rule it reaches, and every terminal it reaches, each entry
        once) plus the lines of the generated source.

        The reference's :meth:`group_eqn_counts` counts the jaxpr equations
        of a group's traced executable, which is O(grammar) for the table
        flavor and grows with the trace for the unrolled one.  Eager PyTorch
        has no traced executable (its launches grow with the trace by
        design), so the port measures what the executable would be built
        from: the same grammar entries for both flavors, and the source,
        which the unrolled flavor spells out one function per entry."""
        from repro_torch.core.codegen import _main_runs
        runs = _main_runs(self.merged)
        lines = self.source.count("\n") + 1
        out: dict[tuple, int] = {}
        for sig, _grp in self.signature_groups():
            seq = [sym for ci, run_ids in sig for i in run_ids
                   for sym in runs[ci][i][1]]
            rules: set[int] = set()
            terms: set[int] = set()
            todo = list(seq)
            while todo:
                kind, ref, _exp = todo.pop()
                if kind == "t":
                    terms.add(int(ref))
                elif int(ref) not in rules:
                    rules.add(int(ref))
                    todo.extend(self.merged.rules[int(ref)])
            out[sig] = (len(seq) + sum(len(self.merged.rules[r])
                                       for r in rules) + len(terms) + lines)
        return out

    def expand_rank_ids(self, rank: int) -> list[int]:
        return self.merged.expand_rank(rank)

    def _noise_totals(self, ranks: Sequence[int], cfg: NoiseConfig,
                      mesh=None) -> tuple[dict, dict]:
        """Executed perturbed cost totals per rank: ``(compute, comm_bytes)``
        with ``compute[r]`` the ``(n_replicas, 6)`` float64 accumulator
        matrix and ``comm_bytes[r]`` the ``(n_replicas,)`` perturbed
        collective bytes.  The walker cannot see runtime randomness, so the
        noisy path executes the replicas (under LocalSim, or the mesh sweep
        with ``mesh=``) and reads the accumulators."""
        if mesh is not None:
            states = self._run_all_mesh(ranks, 0, True, False, mesh, cfg)
        else:
            states = {}
            for fn, arg, grp in self._group_work(ranks, 0, LocalSim(), False,
                                                 cfg):
                res = fn(arg)
                for r in grp:   # replicas are group-level; ranks share them
                    states[r] = res
        compute = {r: st[noise_mod.NOISE_COMPUTE].cpu().numpy()
                   for r, st in states.items()}
        comm_bytes = {r: st[noise_mod.NOISE_COMM].cpu().numpy()
                      for r, st in states.items()}
        return compute, comm_bytes

    def fidelity(self, original_rank_traces: Sequence[Sequence[Event]],
                 original_rank_keys: Sequence[Sequence[str]] | None = None,
                 sample_ranks: int | None = None,
                 batched: bool = True, mesh=None,
                 noise: NoiseConfig | None = None,
                 ) -> "FidelityReport | FidelityDistribution":
        """Compare proxy vs original per rank (paper §3.3.1).

        ``original_rank_traces`` is per-rank Event lists or a columnar
        :class:`~repro_torch.core.trace_ir.TraceStore`.  Compute metrics:
        walker totals of the generated code against the original's compute
        totals.  Communication: the merged grammar must expand to the
        original event *key* sequence exactly (losslessness).
        ``batched=False`` re-walks every rank (the parity baseline).

        ``mesh=`` also runs one mesh-sharded sweep (real collectives through
        :class:`DeviceComm`) and records in ``report.mesh_checked`` whether
        every leaf came back finite.  δ̄ itself is placement-invariant (the
        walker's metrics are keyed by signature and state shapes), so mesh
        and local reports carry bit-identical deltas.

        ``noise=NoiseConfig(...)`` returns a
        :class:`~repro_torch.core.noise.FidelityDistribution` instead: the
        proxy side becomes the *executed* perturbed-cost accumulators of
        ``n_replicas`` seeded replicas, each replica's δ matrix computed
        against the same original totals (``mesh=`` executes them in the
        mesh sweep).  A fixed ``(seed, n_replicas)`` reproduces bit for bit
        on one device, under LocalSim and the mesh alike (replica keys come
        from logical ids, and the accumulators never read a buffer).  The σ→0 limit of the
        executed totals tracks, but is not bit-equal to, the walker's (the
        accumulators sum ``combo_cost`` per occurrence and charge no loop
        bookkeeping), so the bit-parity contract binds only the
        ``noise=None`` walker path."""
        if hasattr(original_rank_traces, "compute_totals"):
            totals = original_rank_traces.compute_totals()
            n_ranks = original_rank_traces.n_ranks
        else:
            totals = None
            n_ranks = len(original_rank_traces)
        ranks = list(range(n_ranks))
        if sample_ranks and n_ranks > sample_ranks:
            step = max(n_ranks // sample_ranks, 1)
            ranks = ranks[::step][:sample_ranks]
        lossless = True
        if original_rank_keys is not None:
            for r in range(n_ranks):
                got = [self.merged.table[i].key()
                       for i in self.expand_rank_ids(r)]
                if list(original_rank_keys[r]) != got:
                    lossless = False
                    break
        if totals is not None:
            a = totals[ranks].T
        else:
            a = np.zeros((N_METRICS, len(ranks)))
            for col, r in enumerate(ranks):
                for ev in original_rank_traces[r]:
                    if not is_comm(ev):
                        a[:, col] += ev.vector
        if noise is not None:
            compute, comm_b = self._noise_totals(ranks, noise, mesh)
            bn = np.stack([compute[r] for r in ranks], axis=2)
            replica_delta = np.stack(
                [proxy_search.rel_error_matrix(a, bn[j])
                 for j in range(noise.n_replicas)])
            cb = np.stack([comm_b[r] for r in ranks], axis=1)
            return FidelityDistribution(
                replica_delta=replica_delta, comm_bytes=cb,
                ranks=tuple(ranks), seed=noise.seed,
                n_replicas=noise.n_replicas, comm_lossless=lossless,
                mesh_checked=mesh is not None and bool(
                    np.isfinite(bn).all() and np.isfinite(cb).all()))
        b = np.stack([self.rank_metrics(r, use_cache=batched) for r in ranks],
                     axis=1)
        delta = proxy_search.rel_error_matrix(a, b)
        mesh_checked = False
        if mesh is not None:
            states = self._run_all_mesh(ranks, 0, True, False, mesh)
            mesh_checked = all(bool(torch.isfinite(leaf.float()).all())
                               for st in states.values()
                               for leaf in st.values())
        return FidelityReport(delta=delta, comm_lossless=lossless,
                              mean=float(delta.mean()),
                              mesh_checked=mesh_checked)


def _check_noise(noise: NoiseConfig | None, batched: bool,
                 per_rank_seeds: bool) -> None:
    """The reference's guards: the noisy replicas own the stacked axis."""
    if noise is not None and per_rank_seeds:
        raise ValueError("noise= and per_rank_seeds are mutually "
                         "exclusive (both own the stacked batch axis)")
    if noise is not None and not batched:
        raise ValueError("noise= requires the batched replay path "
                         "(replicas ride the stacked group axis)")

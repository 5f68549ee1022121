"""The training step and the fault-tolerant trainer.

The port of ``src/repro/train/loop.py``.  ``make_train_step`` builds the
step for an ArchConfig: gradients of ``lm_loss`` by autograd (accumulated
over microbatches), then AdamW, which updates the parameters and moments in
place.  :class:`Trainer` keeps the reference's operational envelope:
checkpoint/restart (async saves, atomic commits), deterministic data
resume, failure injection with automatic restore, and elastic re-shard onto
another mesh.  Without a mesh both run on the CUDA card unless the caller
asks for another device.

**On a mesh** (a ``DeviceMesh`` of :mod:`repro_torch.launch.mesh`) the
port is SPMD on ``torch.distributed``: one process a device, every process
running the same code (NCCL on the card, gloo on the CPU), where the
reference is one controller over the mesh's devices.

* :func:`make_train_step` and :class:`Trainer` take any mesh on which the
  config's rules (``registry.rules_for``) either replicate every parameter
  (data parallel) or split them the way :mod:`repro_torch.sharding.spmd`
  executes: tensor parallel on ``model`` and FSDP on ``data`` (a
  config's ``("embed", "data")`` override) for every family.
  Each process holds its blocks of the parameters and moments and takes
  its rows of the global batch, as the reference's ``batch``-sharded
  ``device_put`` deals them.  The loss and the gradient of every leaf are
  averaged over the axes that split the batch: all-reduced over those that
  do not split the leaf, while a leaf split over ``data`` comes out of the
  backward already summed over it (its gather's reduce-scatter).  The
  clip's norm sums each leaf's squares over the processes that split it.
  A config that routes experts on a data size over 1 routes each
  process's rows as the reference's data shards (``_data_shards`` of the
  global batch), its aux loss's means taken over every shard
  (``models/moe.py``): the step declares the axes that split the batch to
  the model's SPMD context.  Every config trains on every mesh: what the
  mesh does not divide, the rules leave whole and the layers compute
  whole (``sharding/spmd.py``).
* :func:`make_manual_dp_train_step` is the reference's explicit DP step:
  per-process gradients, then the int8 error-feedback all-reduce
  (:func:`repro_torch.train.compression.compressed_psum`) leaf by leaf.
* ``TrainOptions.grad_compression`` keeps the reference's meaning: the
  reference's ``make_train_step`` reads only ``num_microbatches``, so a
  ``Trainer`` given ``"int8"`` trains as without it; the int8 all-reduce is
  the manual step's alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import param_specs, rules_for
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_device, mesh_groups, mesh_ranks
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import build_forward, init_params
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (
    P, axis_sizes, gather_full, local_copy, sharding_for_shape,
)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.compression import compressed_psum
from repro_torch.train.data import Prefetcher, TokenDataset
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    grad_compression: str = "none"     # none | int8 (manual-DP step only)


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) with grads in the tree of ``params``."""
    leaves = tree_leaves(params)
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            with spans.span("train.forward"):
                loss = loss_fn(params, batch)
            with spans.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    by_leaf = {id(p): g for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda p: by_leaf[id(p)], params)


def _microbatched_grads(loss_fn, params, batch, n_mb: int):
    if n_mb <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def part(x, i):
        b = x.shape[0] // n_mb
        return x[i * b:(i + 1) * b]

    loss_acc = None
    g_acc = None
    for i in range(n_mb):
        mb = {k: part(v, i) for k, v in batch.items()}
        loss, g = _value_and_grad(loss_fn, params, mb)
        loss_acc = loss if loss_acc is None else loss_acc + loss
        g = tree_map(lambda x: x.float(), g)
        g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
        del g
    scale = 1.0 / n_mb
    return loss_acc * scale, tree_map(lambda x: x * scale, g_acc)


def _tensor(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.asarray(v)).to(device)


class DataParallel:
    """A mesh's data-parallel geometry for one config, from this process,
    and the blocks of its parameters.

    By default the config's rules decide: they replicate every parameter
    on ``mesh`` or split them as :mod:`repro_torch.sharding.spmd` executes
    (``sharded``, which an expert-routing config on a data size over 1 is
    too: its layers need the mesh), and each batch array splits over the
    axes its ``batch`` spec names (``("pod", "data")`` as present) where
    they divide it.  With ``batch_axes``, as the manual step's
    ``shard_map`` declares its batch, every array splits over those axes
    exactly and the rules are not consulted: the parameters are replicated
    whatever they say, and each process routes its own rows.  The
    reductions run on the mesh's process groups
    (:func:`~repro_torch.launch.mesh.mesh_groups`), which the first use of
    a mesh builds on every process of the world, members or not.
    """

    def __init__(self, cfg: ArchConfig, mesh, rules=None,
                 batch_axes: tuple[str, ...] | None = None):
        self.rules = rules or rules_for(cfg)
        self.sizes = axis_sizes(mesh)
        self.batch_axes = None if batch_axes is None else tuple(batch_axes)
        self.sharded = False
        if batch_axes is None:
            self.sharded = self._check(cfg)
        for a in self.batch_axes or ():
            if a not in self.sizes:
                raise ValueError(f"no axis {a!r} in the mesh {self.sizes}")
        if isinstance(mesh, dict) or not hasattr(mesh, "mesh"):
            raise TypeError("the data-parallel step runs on a DeviceMesh "
                            "(repro_torch.launch.mesh), not on "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.ranks = mesh_ranks(mesh)
        self.sub = mesh_groups(mesh)
        me = dist.get_rank()
        self.member = me in self.ranks
        self.first = me == self.ranks[0]
        self.coord = (dict(zip(self.sizes, np.unravel_index(
            self.ranks.index(me), tuple(self.sizes.values()))))
            if self.member else None)
        self.device = mesh_device(mesh)
        #: each parameter leaf's spec and the axes (over 1) that split it,
        #: in ``tree_leaves`` order
        self.specs = [m.spec for m in tree_leaves(
            param_specs(cfg, self.sizes, self.rules))]
        self.splits = [tuple(a for a in sp.mesh_axes() if self.sizes[a] > 1)
                       for sp in self.specs]

    def _check(self, cfg: ArchConfig) -> bool:
        return spmd.check_supported(cfg, self.sizes, self.rules)

    def mesh_group(self):
        """The process group over the whole mesh (members only)."""
        return self.sub.group(tuple(self.sizes))[0]

    def _split(self, v) -> tuple[str, ...]:
        """The mesh axes that split the batch array ``v``'s rows."""
        if self.batch_axes is None:
            return _entry_axes(sharding_for_shape(
                tuple(v.shape), ("batch",) + (None,) * (v.ndim - 1),
                self.sizes, self.rules))
        n = math.prod(self.sizes[a] for a in self.batch_axes)
        if v.shape[0] % n:
            raise ValueError(f"a batch array of {tuple(v.shape)} does not "
                             f"split over {self.batch_axes} of size {n}")
        return self.batch_axes

    def local_batch(self, batch: dict) -> tuple[dict, tuple[str, ...]]:
        """This process's rows of each global batch array (on its device),
        and the mesh axes that split them (``()``: every process takes the
        whole batch, as ``_filter_divisible`` replicates a batch its data
        size does not divide)."""
        out, split = {}, None
        for k, v in batch.items():
            axes = self._split(v)
            if split is not None and axes != split:
                raise ValueError(f"batch arrays split over {split} and "
                                 f"{axes}: their batch dims differ")
            split = axes
            n = math.prod(self.sizes[a] for a in axes)
            block = 0
            for a in axes:                      # the first axis major
                block = block * self.sizes[a] + int(self.coord[a])
            rows = v.shape[0] // n
            out[k] = _tensor(v[block * rows:(block + 1) * rows], self.device)
        return out, split or ()

    def mean(self, loss, grads, axes: tuple[str, ...], err=None):
        """The loss and every gradient leaf as a mean over ``axes`` (the
        axes that split the batch), leaf by leaf in the reference's leaf
        order: all-reduced over the axes of ``axes`` that do not split the
        leaf, then divided by the processes of ``axes`` and of the data
        axes that split the leaf (whose sum its backward made).  With
        ``err`` (the manual step's error-feedback tree) each leaf goes
        through :func:`~repro_torch.train.compression.compressed_psum`
        instead, and ``err`` and the gradients are updated in place."""
        if not axes and not self.sharded:
            return loss, grads
        if err is not None:
            pg = self.sub.group(axes)[0]
            for g, e in zip(tree_leaves(grads), tree_leaves(err)):
                red, _ = compressed_psum(g, pg, e)
                g.copy_(red)
                del red
        else:
            red = {}
            for g, split in zip(tree_leaves(grads), self.splits):
                over = tuple(a for a in axes if a not in split)
                n = math.prod(self.sizes[a] for a in set(axes) | {
                    a for a in split if a != "model"})
                t = g if g.is_contiguous() else g.contiguous()
                if over:
                    dist.all_reduce(t, dist.ReduceOp.SUM,
                                    group=self.sub.group(over)[0])
                red[id(g)] = t.div_(n)
            grads = tree_map(lambda g: red[id(g)], grads)
        if not axes:
            return loss, grads
        pg, members = self.sub.group(axes)
        loss = loss.clone()
        dist.all_reduce(loss, dist.ReduceOp.SUM, group=pg)
        return loss / len(members), grads

    def norm_sq(self, sq: list) -> torch.Tensor:
        """The global sum of the leaves' sums of squares ``sq`` (one a
        leaf, ``tree_leaves`` order): summed by the set of axes that split
        the leaves, each set all-reduced over its processes (a replicated
        leaf counted once)."""
        by: dict[tuple, list] = {}
        for x, split in zip(sq, self.splits):
            by.setdefault(split, []).append(x)
        total = None
        for split, xs in by.items():
            t = torch.stack(xs).sum()
            if split:
                dist.all_reduce(t, dist.ReduceOp.SUM,
                                group=self.sub.group(split)[0])
            total = t if total is None else total + t
        return total

    def _state_specs(self, state: dict) -> dict:
        """``{id(leaf): spec}`` of a trainer state ``{"params", "opt"}``:
        the moments split as their parameters, the step replicated."""
        out = {}
        for tree in (state["params"], state["opt"]["mu"],
                     state["opt"]["nu"]):
            out.update((id(t), sp) for t, sp in zip(tree_leaves(tree),
                                                    self.specs))
        return out

    def gather_state(self, state: dict) -> dict:
        """Every leaf of a trainer state whole (collective over the mesh)."""
        specs = self._state_specs(state)
        return tree_map(lambda t: gather_full(t, specs.get(id(t), P()),
                                                   self.mesh), state)

    def local_state(self, template: dict):
        """``local(leaf, whole)`` for ``CheckpointManager.restore``: this
        process's block of a whole leaf of the state ``template``."""
        specs = self._state_specs(template)
        return lambda leaf, whole: local_copy(
            whole, specs.get(id(leaf), P()), self.mesh, self.coord)


def _entry_axes(spec) -> tuple[str, ...]:
    """The mesh axes of a spec's first entry (``()`` when it has none)."""
    entry = spec[0] if spec else None
    return (() if entry is None else
            (entry,) if isinstance(entry, str) else tuple(entry))


def _mesh_device(dp: DataParallel, device) -> torch.device:
    if device is not None and torch.device(device).type != dp.device.type:
        raise ValueError(f"device {device} under a group that runs "
                         f"{dp.device.type} tensors")
    return dp.device


def make_train_step(cfg: ArchConfig, mesh=None,
                    opt_cfg: AdamWConfig | None = None,
                    options: TrainOptions | None = None,
                    device=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    The batch's arrays (numpy or tensors) go to ``device`` (default: the
    CUDA card; raises without one); params and opt_state must live there
    and are updated in place.  On a ``mesh`` (see the module docstring) the
    batch is the global one, the device is the mesh's, params and
    opt_state are this process's blocks (``init_params(mesh=)``), and the
    step's ``data_parallel`` attribute holds the mesh's geometry."""
    opt_cfg = opt_cfg or AdamWConfig()
    options = options or TrainOptions()
    dp = DataParallel(cfg, mesh) if mesh is not None else None
    dev = _mesh_device(dp, device) if dp else resolve_device(device)
    loss_fn_raw = build_forward(cfg, "loss")
    sharded = dp is not None and dp.sharded

    def loss_fn(p, b):
        return loss_fn_raw(p, b, cfg, mesh) if sharded else \
            loss_fn_raw(p, b, cfg)

    def step(params, opt_state, batch):
        if dp is None:
            batch, axes = {k: _tensor(v, dev) for k, v in batch.items()}, ()
        else:
            batch, axes = dp.local_batch(batch)
        rows = spmd.context(mesh, cfg).rows(axes) if sharded else \
            contextlib.nullcontext()
        with rows:
            loss, grads = _microbatched_grads(loss_fn, params, batch,
                                              options.num_microbatches)
        if dp is not None:
            loss, grads = dp.mean(loss, grads, axes)
        params, opt_state, metrics = adamw_update(
            grads, params, opt_state, opt_cfg,
            norm_reduce=dp.norm_sq if sharded else None)
        metrics["loss"] = loss
        return params, opt_state, metrics

    step.data_parallel = dp
    return step


def make_manual_dp_train_step(cfg: ArchConfig, mesh,
                              opt_cfg: AdamWConfig | None = None,
                              data_axis: str = "data") -> Callable:
    """Explicit-DP step: per-process gradients, then the int8
    error-feedback all-reduce leaf by leaf.

    step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics), with ``err`` the feedback accumulator
    (:func:`repro_torch.train.compression.init_error_state` of the
    params).  Parameters are replicated on the mesh whatever the rules
    say, as the reference's ``shard_map`` declares them; each process
    takes its block of the global batch's rows along ``data_axis`` (the
    batch must divide), computes the loss of its rows alone (an expert
    router routes them alone, as the reference's ``local_step`` does), and
    the loss is averaged over ``data_axis``.  The gradients, the error
    state, the parameters and the moments are updated in place.  Each
    process keeps what its own scale gives (``compressed_psum``), so the
    processes' parameters differ, as the reference's devices' do."""
    opt_cfg = opt_cfg or AdamWConfig()
    dp = DataParallel(cfg, mesh, batch_axes=(data_axis,))
    loss_fn_raw = build_forward(cfg, "loss")

    def step(params, opt_state, err, batch):
        local, axes = dp.local_batch(batch)
        loss, grads = _value_and_grad(lambda p, b: loss_fn_raw(p, b, cfg),
                                      params, local)
        loss, grads = dp.mean(loss, grads, axes, err=err)
        params, opt_state, metrics = adamw_update(grads, params, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, err, metrics

    step.data_parallel = dp
    return step


# ---------------------------------------------------------------------------
# fault-tolerant trainer
# ---------------------------------------------------------------------------


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier(group=None) -> None:
    if str(dist.get_backend(group)) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


class Trainer:
    """The reference's trainer, on one device or SPMD on a mesh.

    On a mesh every process of the world builds the trainer and runs the
    same calls; each keeps its blocks of the state (a replica where the
    rules replicate).  The mesh's first process writes the checkpoints
    (so ``ckpt_dir`` must be one directory all of them see), whole leaves
    gathered from the blocks, in the single-device trainer's format: a
    checkpoint moves between meshes of any layout, the single-device
    trainer and the reference.  A restore waits at a barrier of the mesh
    for the writer's last save and cuts each leaf to the process's block.

    :meth:`reshard` is collective over the world's processes.  After it,
    the processes of the new mesh hold the state; for ``None``, the
    process of rank 0 does, as the reference's single controller keeps its
    arrays on its first device.  A process outside the new mesh drops its
    state, and :meth:`run` takes no step there (``active`` is False).  A
    trainer built with ``mesh=None`` never calls ``torch.distributed``.
    """

    def __init__(self, cfg: ArchConfig, mesh=None, *, global_batch: int = 8,
                 seq_len: int = 32, ckpt_dir: str | Path | None = None,
                 opt_cfg: AdamWConfig | None = None,
                 options: TrainOptions | None = None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self._device_arg = device
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.options = options or TrainOptions()
        self.dataset = TokenDataset(cfg.vocab, seq_len, global_batch, seed)
        if ckpt_dir is None:
            ckpt_dir = Path(tempfile.gettempdir()) / "repro_torch_ckpt"
        self.ckpt = ckpt_lib.CheckpointManager(ckpt_dir)
        self.params = None
        self.opt_state = None
        self._bind(mesh, controller_only=False)
        self._init_state(seed)
        self.step = 0
        self.metrics_log: list[dict] = []

    def _bind(self, mesh, controller_only: bool):
        """Build the step for ``mesh`` and this process's role on it."""
        self.mesh = mesh
        device = self._device_arg
        if mesh is None:      # after a mesh, the process keeps its device
            device = resolve_device(device if device is not None
                                    else getattr(self, "device", None))
        self.step_fn = make_train_step(self.cfg, mesh, self.opt_cfg,
                                       self.options, device)
        dp = self._dp = self.step_fn.data_parallel
        if dp is None:
            self.device = device
            self.active = not controller_only or dist.get_rank() == 0
            self._writer = self.active
            self._group = None
        else:
            self.device = dp.device
            self.active = dp.member
            self._writer = dp.first
            self._group = dp.mesh_group() if dp.member else None

    def _init_state(self, seed: int):
        self.params = None          # free the old state before the new one
        self.opt_state = None
        if self.active:
            mesh = self.mesh if self._sharded() else None
            self.params = init_params(self.cfg, seed, self.device, mesh=mesh)
            self.opt_state = adamw_init(self.params)

    def _sharded(self) -> bool:
        return self._dp is not None and self._dp.sharded

    # -- checkpoint/restart ---------------------------------------------------

    def save(self, async_: bool = True):
        """Checkpoint the state (collective on a sharded mesh: every
        process of the mesh gathers; the first writes)."""
        state = {"params": self.params, "opt": self.opt_state}
        if self._sharded() and self.active:
            state = self._dp.gather_state(state)
        if not self._writer:
            return
        extra = {"step": self.step}
        if async_:
            self.ckpt.save_async(self.step, state, extra)
        else:
            self.ckpt.save(self.step, state, extra)

    def restore(self, step: int | None = None) -> bool:
        if not self.active:
            return False
        self.ckpt.wait()
        if self._group is not None:
            _barrier(self._group)
        if self.ckpt.latest_step() is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        local = self._dp.local_state(template) if self._sharded() else None
        got_step, state, extra = self.ckpt.restore(template, step,
                                                   self.device, local=local)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = extra.get("step", got_step)
        return True

    def reshard(self, new_mesh):
        """Elastic re-scale: persist, rebuild on the new mesh, restore.
        Every process of the world calls it (see the class docstring)."""
        self.ckpt.wait()
        if self.active:
            self.save(async_=False)
        world = _world()
        if world:
            _barrier()
        self._bind(new_mesh, controller_only=world)
        self._init_state(seed=0)
        self.restore()

    # -- run loop ---------------------------------------------------------------

    def run(self, n_steps: int, ckpt_every: int = 0,
            failure_injector: Callable[[int], None] | None = None,
            max_restarts: int = 3) -> list[dict]:
        if not self.active:
            return self.metrics_log
        restarts = 0
        target = self.step + n_steps
        extras = self.dataset.extras(self.cfg)
        while self.step < target:
            pf = Prefetcher(self.dataset, start_step=self.step, extras=extras)
            try:
                while self.step < target:
                    got_step, batch = next(pf)
                    assert got_step == self.step, (got_step, self.step)
                    if failure_injector is not None:
                        failure_injector(self.step)
                    t0 = time.perf_counter()
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch)
                    loss = float(metrics["loss"])
                    self.metrics_log.append({
                        "step": self.step, "loss": loss,
                        "sec": time.perf_counter() - t0,
                    })
                    self.step += 1
                    if ckpt_every and self.step % ckpt_every == 0:
                        self.save(async_=True)
            except _InjectedFailure:
                restarts += 1
                if restarts > max_restarts:
                    raise
                self.ckpt.wait()
                self._init_state(seed=0)       # fresh process semantics
                if not self.restore():
                    self.step = 0
            finally:
                pf.close()
        self.ckpt.wait()
        return self.metrics_log


class _InjectedFailure(RuntimeError):
    """Raised by tests' failure injectors to simulate a node loss."""

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
reference is one controller over the mesh's devices.  Data parallelism is
what executes:

* :func:`make_train_step` and :class:`Trainer` take a mesh on which the
  config's logical-axis rules (``registry.rules_for``) replicate every
  parameter.  Each process takes its rows of the global batch, as the
  reference's ``batch``-sharded ``device_put`` deals them, and the
  gradients and the loss are all-reduced as a mean over the axes that
  split the batch.  A mesh on which a parameter would be sharded
  (a ``model`` axis over 1, or a config's ``("embed", "data")``
  override), and a config that routes experts on a data size over 1 (the
  reference routes the global batch: capacity and the aux loss span every
  shard), raise ``NotImplementedError``: item 12 of ROADMAP's queue 1.
* :func:`make_manual_dp_train_step` is the reference's explicit DP step:
  per-process gradients, then the int8 error-feedback all-reduce
  (:func:`repro_torch.train.compression.compressed_psum`) leaf by leaf.
* ``TrainOptions.grad_compression`` keeps the reference's meaning: the
  reference's ``make_train_step`` reads only ``num_microbatches``, so a
  ``Trainer`` given ``"int8"`` trains as without it; the int8 all-reduce is
  the manual step's alone.
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import param_specs, rules_for
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import backend_device, mesh_groups, mesh_ranks
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import build_forward, init_params
from repro_torch.sharding.partition import (
    SHARDED_EXECUTION, axis_sizes, is_replicated, sharding_for_shape,
    spec_for,
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
            loss = loss_fn(params, batch)
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
    """A mesh's data-parallel geometry for one config, from this process.

    By default the config's rules decide: they must replicate every
    parameter on ``mesh`` (else ``NotImplementedError``), an expert-routing
    config must have a data size of 1, and each batch array splits over the
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
        if batch_axes is None:
            self._check(cfg)
        for a in self.batch_axes or ():
            if a not in self.sizes:
                raise ValueError(f"no axis {a!r} in the mesh {self.sizes}")
        if isinstance(mesh, dict) or not hasattr(mesh, "mesh"):
            raise TypeError("the data-parallel step runs on a DeviceMesh "
                            "(repro_torch.launch.mesh), not on "
                            f"{type(mesh).__name__}")
        self.ranks = mesh_ranks(mesh)
        self.sub = mesh_groups(mesh)
        me = dist.get_rank()
        self.member = me in self.ranks
        self.first = me == self.ranks[0]
        self.coord = (dict(zip(self.sizes, np.unravel_index(
            self.ranks.index(me), tuple(self.sizes.values()))))
            if self.member else None)
        self.device = backend_device()

    def _check(self, cfg: ArchConfig) -> None:
        for leaf in tree_leaves(param_specs(cfg, self.sizes, self.rules)):
            if not is_replicated(leaf.spec, self.sizes):
                raise NotImplementedError(
                    f"{cfg.name} on {self.sizes}: a parameter of "
                    f"{tuple(leaf.meta.shape)} would be sharded {leaf.spec}; "
                    f"{SHARDED_EXECUTION}")
        batch = spec_for(("batch",), self.sizes, self.rules)
        n_data = math.prod(self.sizes[a] for a in _entry_axes(batch))
        if cfg.n_experts and n_data > 1:
            raise NotImplementedError(
                f"{cfg.name} routes experts: on a data size of {n_data} the "
                "reference routes the global batch (capacity and the aux "
                "loss span every shard), which per-shard routing is not; "
                "expert routing across a data mesh waits for the port's "
                "sharding substrate (ROADMAP, queue 1, item 12)")

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
        """The loss and every gradient leaf all-reduced as a mean over
        ``axes``, leaf by leaf in the reference's leaf order.  With ``err``
        (the manual step's error-feedback tree) each leaf goes through
        :func:`~repro_torch.train.compression.compressed_psum` instead, and
        ``err`` and the gradients are updated in place."""
        if not axes:
            return loss, grads
        pg, members = self.sub.group(axes)
        n = len(members)
        if err is not None:
            for g, e in zip(tree_leaves(grads), tree_leaves(err)):
                red, _ = compressed_psum(g, pg, e)
                g.copy_(red)
                del red
        else:
            red = {}
            for g in tree_leaves(grads):
                t = g if g.is_contiguous() else g.contiguous()
                dist.all_reduce(t, dist.ReduceOp.SUM, group=pg)
                red[id(g)] = t.div_(n)
            grads = tree_map(lambda g: red[id(g)], grads)
        loss = loss.clone()
        dist.all_reduce(loss, dist.ReduceOp.SUM, group=pg)
        return loss / n, grads


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
    batch is the global one, the device is the process group's, and the
    step's ``data_parallel`` attribute holds the mesh's geometry."""
    opt_cfg = opt_cfg or AdamWConfig()
    options = options or TrainOptions()
    dp = DataParallel(cfg, mesh) if mesh is not None else None
    dev = _mesh_device(dp, device) if dp else resolve_device(device)
    loss_fn_raw = build_forward(cfg, "loss")

    def loss_fn(p, b):
        return loss_fn_raw(p, b, cfg)

    def step(params, opt_state, batch):
        if dp is None:
            batch, axes = {k: _tensor(v, dev) for k, v in batch.items()}, ()
        else:
            batch, axes = dp.local_batch(batch)
        loss, grads = _microbatched_grads(loss_fn, params, batch,
                                          options.num_microbatches)
        if dp is not None:
            loss, grads = dp.mean(loss, grads, axes)
        params, opt_state, metrics = adamw_update(grads, params, opt_state,
                                                  opt_cfg)
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

    On a mesh every process of the world builds the trainer, runs the same
    calls and keeps a replica of the state; the mesh's first process writes
    the checkpoints (so ``ckpt_dir`` must be one directory all of them
    see), in the single-device trainer's format: either trainer restores
    the other's.  A restore waits at a barrier of the mesh for the
    writer's last save.

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
        dp = self.step_fn.data_parallel
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
            self.params = init_params(self.cfg, seed, self.device)
            self.opt_state = adamw_init(self.params)

    # -- checkpoint/restart ---------------------------------------------------

    def save(self, async_: bool = True):
        if not self._writer:
            return
        state = {"params": self.params, "opt": self.opt_state}
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
        got_step, state, extra = self.ckpt.restore(template, step,
                                                   self.device)
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

"""The training step and the fault-tolerant trainer.

The port of ``src/repro/train/loop.py``.  ``make_train_step`` builds the
step for an ArchConfig: gradients of ``lm_loss`` by autograd (accumulated
over microbatches), then AdamW, which updates the parameters and moments in
place.  :class:`Trainer` keeps the reference's operational envelope on one
device: checkpoint/restart (async saves, atomic commits), deterministic
data resume, failure injection with automatic restore.  Both run on the
CUDA card unless the caller asks for another device.

What needs a mesh waits for the port's mesh slice (ROADMAP, queue 1, items
11 and 13): a ``mesh``, the int8-compressed gradient all-reduce
(``grad_compression="int8"``, ``train/compression.py``),
:func:`make_manual_dp_train_step` and :meth:`Trainer.reshard` raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import build_forward, init_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import Prefetcher, TokenDataset
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update

MESH_SLICE = ("the port's mesh slice (ROADMAP, queue 1, items 11 and 13: "
              "torch.distributed and DTensor placements)")


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    grad_compression: str = "none"     # none | int8 (manual-DP step only)


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"{what} on a mesh waits for {MESH_SLICE}")


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


def make_train_step(cfg: ArchConfig, mesh=None,
                    opt_cfg: AdamWConfig | None = None,
                    options: TrainOptions | None = None,
                    device=None) -> Callable:
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    The batch's arrays (numpy or tensors) go to ``device`` (default: the
    CUDA card; raises without one); params and opt_state must live there
    and are updated in place."""
    _no_mesh(mesh, "make_train_step")
    opt_cfg = opt_cfg or AdamWConfig()
    options = options or TrainOptions()
    if options.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={options.grad_compression!r} is the manual-DP "
            f"step's; it waits for {MESH_SLICE}")
    dev = resolve_device(device)
    loss_fn_raw = build_forward(cfg, "loss")

    def loss_fn(p, b):
        return loss_fn_raw(p, b, cfg)

    def step(params, opt_state, batch):
        batch = {k: _tensor(v, dev) for k, v in batch.items()}
        loss, grads = _microbatched_grads(loss_fn, params, batch,
                                          options.num_microbatches)
        params, opt_state, metrics = adamw_update(grads, params, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


def make_manual_dp_train_step(cfg: ArchConfig, mesh,
                              opt_cfg: AdamWConfig | None = None,
                              data_axis: str = "data") -> Callable:
    """The reference's explicit-DP step with the int8 error-feedback
    all-reduce: not ported yet."""
    raise NotImplementedError(f"make_manual_dp_train_step waits for "
                              f"{MESH_SLICE}")


# ---------------------------------------------------------------------------
# fault-tolerant trainer
# ---------------------------------------------------------------------------


class Trainer:
    """Single-device trainer with the reference's operational envelope."""

    def __init__(self, cfg: ArchConfig, mesh=None, *, global_batch: int = 8,
                 seq_len: int = 32, ckpt_dir: str | Path | None = None,
                 opt_cfg: AdamWConfig | None = None,
                 options: TrainOptions | None = None, seed: int = 0,
                 device=None):
        _no_mesh(mesh, "Trainer")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.options = options or TrainOptions()
        self.dataset = TokenDataset(cfg.vocab, seq_len, global_batch, seed)
        if ckpt_dir is None:
            ckpt_dir = Path(tempfile.gettempdir()) / "repro_torch_ckpt"
        self.ckpt = ckpt_lib.CheckpointManager(ckpt_dir)
        self.step_fn = make_train_step(cfg, None, self.opt_cfg, self.options,
                                       self.device)
        self._init_state(seed)
        self.step = 0
        self.metrics_log: list[dict] = []

    def _init_state(self, seed: int):
        self.params = None          # free the old state before the new one
        self.opt_state = None
        self.params = init_params(self.cfg, seed, self.device)
        self.opt_state = adamw_init(self.params)

    # -- checkpoint/restart ---------------------------------------------------

    def save(self, async_: bool = True):
        state = {"params": self.params, "opt": self.opt_state}
        extra = {"step": self.step}
        if async_:
            self.ckpt.save_async(self.step, state, extra)
        else:
            self.ckpt.save(self.step, state, extra)

    def restore(self, step: int | None = None) -> bool:
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
        """Elastic re-scale onto another mesh: not ported yet."""
        raise NotImplementedError(f"Trainer.reshard waits for {MESH_SLICE}")

    # -- run loop ---------------------------------------------------------------

    def run(self, n_steps: int, ckpt_every: int = 0,
            failure_injector: Callable[[int], None] | None = None,
            max_restarts: int = 3) -> list[dict]:
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

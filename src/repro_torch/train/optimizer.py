"""AdamW from scratch over trees of tensors.

The port of ``src/repro/train/optimizer.py``: moments in f32 whatever the
parameter's dtype, the update clipped by the global norm of the gradients,
bias correction, decoupled weight decay on leaves of two or more dims only,
and the result cast back to the parameter's dtype, with the reference's
arithmetic in f32.  The port updates the parameters and moments in place
under ``torch.no_grad()`` (the reference returns new trees): at 3B
parameters a second copy of the optimizer state would not fit beside the
first.  Large leaves are updated in slices of ``CHUNK`` elements, so the
f32 temporaries of one leaf stay small; the arithmetic is elementwise, so
the slices change nothing in the values.

On a mesh each process holds its blocks of the parameters, gradients and
moments (the moments split as their parameters: :func:`abstract_opt_state`)
and updates them; only the clip's global norm needs the other processes:
:func:`global_norm` with ``reduce`` sums each leaf's squares over the
processes that split it, and counts a replicated leaf once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.layers import tree_leaves, tree_map

#: elements per slice of a leaf's update (256 MiB of f32 temporaries)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def adamw_init(params) -> dict:
    """Zero f32 moments beside each leaf, on its device, and step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(param_specs) -> dict:
    """The optimizer state of parameters given as MetaSpecs
    (``registry.param_specs``): f32 moments split as their parameters, the
    step count replicated."""
    from repro_torch.configs.registry import MetaSpec, _meta
    from repro_torch.sharding.partition import PartitionSpec

    def like(m):
        return MetaSpec(_meta(tuple(m.meta.shape), torch.float32), m.spec)

    return {"mu": tree_map(like, param_specs),
            "nu": tree_map(like, param_specs),
            "step": MetaSpec(_meta((), torch.int32), PartitionSpec())}


def lr_schedule(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay; an f32 scalar tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    return sum((x.float() ** 2).sum() for x in _slices(g.contiguous()))


def global_norm(tree, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  ``reduce``, on a
    mesh, takes the leaves' local sums of squares (in ``tree_leaves``
    order) and returns the global sum (``DataParallel.norm_sq``)."""
    leaves = tree_leaves(tree)
    if reduce is not None:
        return torch.sqrt(reduce([_sumsq(g) for g in leaves]))
    total = None
    for g in leaves:
        sq = _sumsq(g)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, params, opt_state: dict, cfg: AdamWConfig,
                 norm_reduce=None):
    """One AdamW step, in place; returns (params, opt_state, metrics).
    ``norm_reduce``: :func:`global_norm`'s ``reduce`` on a mesh."""
    step = opt_state["step"] + 1
    gn = global_norm(grads, norm_reduce)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=sf.device), sf)
    decay = 1.0 - lr * cfg.weight_decay
    for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                            tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"])):
        matrix = p.dim() >= 2   # decoupled weight decay on matrices only
        for gs, ps, ms, ns in zip(_slices(g.contiguous()), _slices(p),
                                  _slices(mu), _slices(nu)):
            gf = gs.float() * scale
            ms.mul_(b1).add_(gf * (1 - b1))
            ns.mul_(b2).add_(gf * (1 - b2) * gf)
            upd = (ms / bc1) / (torch.sqrt(ns / bc2) + cfg.eps)
            pf = ps.float()
            if matrix:
                pf = pf * decay
            ps.copy_(pf - lr * upd)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gn, "lr": lr, "step": step}

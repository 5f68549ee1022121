"""Seeded weights, made on the device by the benchmark and handed to both the
program and the reference.

A model's inputs are a tree (nested dicts and tuples) of :class:`Spec`
leaves, laid out as the port's parameter tree (``reference/<family>.py``
builds it from the configuration's sizes, with the published model's
initialisation of each leaf).  Each leaf is drawn whole in the type it is
served in, on a ``torch.Generator`` of its own seeded from the run's seed
and the leaf's index: so one leaf can be drawn again alone (the train
driver reads the parameters' change so) and the reference, after the
program's state is freed, draws the same tree again.

Kinds of draw: ``zeros``; ``ones``; ``normal`` (mean 0, ``a`` the standard
deviation); ``log_uniform`` (log of a uniform draw on [a, b]: Mamba2's
A_log); ``dt_bias`` (the inverse softplus of dt drawn log-uniform on [a,
b], floored at 1e-4: Mamba2's dt bias).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple[int, ...]
    kind: str = "normal"
    a: float = 0.0
    b: float = 0.0
    dtype: str = "bfloat16"


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """``(path, leaf)`` in the port's ``tree_leaves`` order (dict keys
    sorted, tuples in order); a path is dotted, ``unit.0.mixer.in_proj``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7_919 * (index + 1)) % (2 ** 63)


def make_leaf(spec: Spec, seed: int, index: int, device) -> torch.Tensor:
    dt = getattr(torch, spec.dtype)
    if spec.kind == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.kind == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if spec.kind == "normal":
        x = torch.randn(spec.shape, generator=gen, dtype=dt, device=device)
        return x.mul_(spec.a)
    u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                   device=device)
    if spec.kind == "log_uniform":
        return torch.log(spec.a + (spec.b - spec.a) * u).to(dt)
    if spec.kind == "dt_bias":
        lo, hi = math.log(spec.a), math.log(spec.b)
        t = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
        return (t + torch.log(-torch.expm1(-t))).to(dt)
    raise ValueError(f"no draw of kind {spec.kind!r}")


def make(specs, seed: int, device) -> dict:
    """The whole tree of tensors for ``seed``."""
    index = {id(s): i for i, (_, s) in enumerate(tree_items(specs))}
    return tree_map(lambda s: make_leaf(s, seed, index[id(s)], device), specs)

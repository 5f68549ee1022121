"""Model registry: one dispatch point from ArchConfig to init and serve
functions.

The port of ``src/repro/models/model.py``.  ``build_forward(cfg, kind)``
returns the training loss, the prefill or the decode step; ``init_params``
draws concrete weights on a device; ``params_from_numpy`` carries the
reference's weights across value for value.  ``init_abstract`` and
``abstract_cache`` are the reference's shape-only stand-ins: meta tensors,
which the cost walker runs on; ``logical_axes_tree`` and
``cache_logical_axes`` the parameters' and the decode cache's logical
axes, as the reference's.

On a mesh (a ``DeviceMesh``, SPMD: :mod:`repro_torch.sharding.spmd`),
``init_params``, ``params_from_numpy`` and ``init_cache`` give this
process's blocks under the config's rules: the parameters drawn (or
carried) whole, then cut, so a block is bit-equal to the slice of the
single-device tree; the forward functions take ``mesh`` as their last
argument, as the reference's do.  The encoder-decoder family
(``family == "encdec"``) dispatches to :mod:`repro_torch.models.encdec`,
every other family to :mod:`repro_torch.models.transformer`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.layers import init_tree, logical_axes, tree_map
from repro_torch.sharding.partition import (
    entry_axes, local_copy, mesh_coord, sharding_for_shape,
)


def param_tree(cfg: ArchConfig) -> dict:
    if cfg.family == "encdec":
        return E.init_encdec(cfg)
    return T.init_lm(cfg)


def logical_axes_tree(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in the parameter tree's
    structure: the leaves are tuples of axis names (or ``None``)."""
    return logical_axes(param_tree(cfg))


def _device(device, mesh):
    if mesh is not None and device is None:
        from repro_torch.launch.mesh import mesh_device
        return mesh_device(mesh)
    return resolve_device(device)


def _localizer(cfg: ArchConfig, mesh):
    from repro_torch.configs.registry import rules_for
    from repro_torch.sharding import spmd
    spmd.context(mesh, cfg)              # raises for what does not execute
    rules, coord = rules_for(cfg), mesh_coord(mesh)
    return lambda shape, axes, t: local_copy(
        t, sharding_for_shape(tuple(shape), axes, mesh, rules), mesh, coord)


def init_params(cfg: ArchConfig, seed: int = 0, device=None, mesh=None
                ) -> dict:
    """Concrete weights on ``device`` (default: the CUDA card, or the
    mesh's device; raises without one).  The reference's init rule with
    torch's generator: the structure, shapes and dtypes are the
    reference's, the values are not (see ``layers.init_tree``).  On a
    ``mesh``, this process's block of each leaf (drawn whole, then cut)."""
    dev = _device(device, mesh)
    if mesh is None:
        return init_tree(param_tree(cfg), seed, dev)
    cut = _localizer(cfg, mesh)
    return init_tree(param_tree(cfg), seed, dev,
                     local=lambda p, t: cut(p.shape, p.axes, t))


def init_abstract(cfg: ArchConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes only): the
    reference's ``init_abstract``."""
    return init_params(cfg, 0, "meta")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: move the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))      # a writable copy
    return t.to(device)


def params_from_numpy(tree, device=None, mesh=None,
                      cfg: ArchConfig | None = None) -> dict:
    """The reference's parameter tree as numpy arrays (``jax.tree.map(
    np.asarray, repro.models.model.init_params(cfg, seed))``) as the port's
    tree of tensors on ``device``, value for value (bf16 included).  On a
    ``mesh`` (with ``cfg``, whose rules and logical axes decide), this
    process's block of each leaf."""
    dev = _device(device, mesh)
    if mesh is None:
        return tree_map(lambda a: _tensor(a, dev), tree)
    cut = _localizer(cfg, mesh)
    return tree_map(lambda a, ax: cut(np.shape(a), ax, _tensor(a, dev)),
                    tree, logical_axes_tree(cfg))


def build_forward(cfg: ArchConfig, kind: str) -> Callable:
    """kind: 'loss' | 'prefill' | 'decode'."""
    if cfg.family == "encdec":
        return {"loss": E.encdec_loss, "prefill": E.encdec_prefill,
                "decode": E.encdec_decode_step}[kind]
    return {"loss": T.lm_loss, "prefill": T.lm_prefill,
            "decode": T.lm_decode_step}[kind]


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None,
               n_frames: int = 0, mesh=None):
    """Zero decode caches at context ``seq_len``; an encoder-decoder's
    cross K/V hold ``n_frames`` encoder states (default: the config's
    ``n_audio_frames``).  On a ``mesh``, this process's block of each
    buffer as ``registry.cache_specs`` lays it out (``batch`` over the
    data axes, an attention cache's sequence over ``model``)."""
    dev = _device(device, mesh)
    if mesh is not None:
        return _local_cache(cfg, batch, seq_len, dev, n_frames, mesh)
    if cfg.family == "encdec":
        return E.init_encdec_cache(cfg, batch, seq_len,
                                   n_frames or cfg.n_audio_frames, dev)
    return T.init_lm_cache(cfg, batch, seq_len, dev)


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int,
                   n_frames: int = 0) -> dict:
    """The decode cache as meta tensors: the reference's
    ``abstract_cache``."""
    return init_cache(cfg, batch, seq_len, "meta", n_frames)


def cache_logical_axes(cfg: ArchConfig, batch: int, seq_len: int,
                       n_frames: int = 0):
    """The logical axes of the decode cache, in its structure (the
    reference's walk: an SSM cache's ``state`` and ``conv`` by name, every
    other 4-dim leaf an attention cache, a 5-dim one a stacked one)."""
    from repro_torch.models.attention import KVCache

    def kv(nd):
        base = ("batch", "kv_seq", "kv_heads", "head_dim")
        return base if nd == 4 else ("layers",) + base if nd == 5 \
            else (None,) * nd

    def named(k, nd):
        base = {"state": ("batch", "ssm_heads", "head_dim", "ssm_state"),
                "conv": ("batch", None, "conv_dim")}[k]
        return base if nd == len(base) else ("layers",) + base

    def walk(node):
        if isinstance(node, dict):
            return {k: named(k, v.dim()) if k in ("state", "conv")
                    else walk(v) for k, v in node.items()}
        if isinstance(node, KVCache):
            return KVCache(kv(node.k.dim()), kv(node.v.dim()))
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return kv(node.dim())

    return walk(abstract_cache(cfg, batch, seq_len, n_frames))


#: the cross-attention caches' keys (the VLM's ``x`` layers, the
#: encoder-decoder): read only, whole where ``model`` does not divide them
CROSS_CACHE_KEYS = ("xk", "xv", "cross_k", "cross_v")


def _map_cache(fn, tree, axes, cross: bool = False):
    """``fn(leaf, axes, cross)`` over a cache and its logical axes, ``cross``
    True under a cross-attention key."""
    if isinstance(tree, dict):
        return {k: _map_cache(fn, v, axes[k], cross or k in CROSS_CACHE_KEYS)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        out = [_map_cache(fn, v, a, cross) for v, a in zip(tree, axes)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn(tree, axes, cross)


def _local_cache(cfg, batch, seq_len, dev, n_frames, mesh):
    """:func:`init_cache`'s blocks on a mesh; raises where a buffer would
    be split in a way the decode step does not execute (a self-attention
    cache whose length the ``model`` axis does not divide; an
    encoder-decoder's cross cache of other than the config's frames)."""
    from repro_torch.configs.registry import rules_for
    from repro_torch.sharding import spmd
    from repro_torch.sharding.partition import axis_sizes, block_of
    ctx = spmd.context(mesh, cfg)
    rules, coord, sizes = rules_for(cfg), mesh_coord(mesh), axis_sizes(mesh)
    if ctx is not None and ctx.tp > 1 and cfg.family == "encdec" and \
            n_frames and n_frames != cfg.n_audio_frames:
        raise NotImplementedError(
            f"{cfg.name}: a cross cache of {n_frames} frames on a sharded "
            f"mesh (the decode step reads the config's {cfg.n_audio_frames};"
            " ROADMAP, queue 1, item 12)")

    def one(meta, axes, cross):
        spec = sharding_for_shape(tuple(meta.shape), axes, mesh, rules)
        shape = list(meta.shape)
        for dim, entry in enumerate(spec):
            split = [a for a in entry_axes(entry) if sizes[a] > 1]
            kept = axes[dim] == "batch" or (
                ctx is not None and axes[dim] in ("kv_seq", "ssm_heads",
                                                  "conv_dim"))
            if split and not kept:
                raise NotImplementedError(
                    f"{cfg.name}: a decode cache of {tuple(meta.shape)} "
                    f"split {spec} on {sizes} (item 12)")
            shape[dim] //= block_of(entry, mesh, coord)[1]
        if ctx is not None and ctx.tp > 1 and "kv_seq" in axes and \
                not cross:
            dim = axes.index("kv_seq")
            if "model" not in entry_axes(spec[dim] if dim < len(spec)
                                         else None):
                raise NotImplementedError(
                    f"{cfg.name}: a decode cache of {meta.shape[dim]} "
                    f"positions does not split over the model axis of "
                    f"{ctx.tp}: the sequence-split decode needs a length "
                    "it divides (ROADMAP, queue 1, item 12)")
        return torch.zeros(shape, dtype=meta.dtype, device=dev)

    return _map_cache(one, abstract_cache(cfg, batch, seq_len, n_frames),
                      cache_logical_axes(cfg, batch, seq_len, n_frames))

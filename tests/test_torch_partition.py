"""The port's logical-axis rules against the JAX reference's, in process
(``repro.sharding.partition`` and the reference's parameter trees import
on this JAX; the rules read only a mesh's axis names and sizes, so a
stand-in mesh object carries them, with no devices needed).

Every config's parameter specs, full size and smoke, on a ``data`` mesh of
4, a 2 × 2 ``data × model`` mesh and a 2 × 2 × 2 ``pod × data × model``
mesh, equal the reference's as tuples; so do the logical axes trees, the
rules with each config's overrides and the batch specs of every run
shape.  Parity level: equal (the same table, the same pure functions).
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import SHAPES as JSHAPES
from repro.models.layers import is_param as jax_is_param
from repro.models.model import (
    _param_tree as jax_param_tree, logical_axes_tree as jax_axes_tree,
)
from repro.sharding import partition as JP
from repro_torch.configs import get, smoke
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import (
    ARCH_IDS, MetaSpec, batch_specs, param_specs, rules_for,
)
from repro_torch.models.layers import tree_leaves
from repro_torch.models.model import logical_axes_tree, param_tree
from repro_torch.sharding import partition as PP

MESHES = {"dp4": {"data": 4}, "dp2xtp2": {"data": 2, "model": 2},
          "pod2xdp2xtp2": {"pod": 2, "data": 2, "model": 2}}


def _jmesh(sizes: dict):
    """What the reference's rules read of a ``jax.sharding.Mesh``."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _plain(spec) -> tuple:
    """A spec of either package as a tuple of None / str / tuple."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _axes_leaves(tree) -> list:
    """Leaves of an axes tree, a tuple of names being one leaf (the
    reference's flatten with that ``is_leaf``)."""
    if _is_axes(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _axes_leaves(v)]
    return [tree]


def _cfgs(arch: str):
    from repro.configs import get as jget, smoke as jsmoke
    return {"full": (jget(arch), get(arch)),
            "smoke": (jsmoke(jget(arch)), smoke(get(arch)))}


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, size):
    jcfg, cfg = _cfgs(arch)[size]
    import jax
    jleaves = jax.tree.leaves(jax_param_tree(jcfg), is_leaf=jax_is_param)
    jrules = JR.rules_for(jcfg)
    for name, sizes in MESHES.items():
        jm = _jmesh(sizes)
        want = [_plain(JP._filter_divisible(JP.spec_for(p.axes, jm, jrules),
                                            p.shape, jm)) for p in jleaves]
        got = tree_leaves(param_specs(cfg, sizes))
        assert all(isinstance(g, MetaSpec) for g in got)
        assert [tuple(g.meta.shape) for g in got] == [p.shape for p in jleaves]
        assert [_plain(g.spec) for g in got] == want, (arch, size, name)
        # the unfiltered spec too
        assert [_plain(PP.spec_for(p.axes, sizes, rules_for(cfg)))
                for p in tree_leaves(param_tree(cfg))] == \
            [_plain(JP.spec_for(p.axes, jm, jrules)) for p in jleaves]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_tree_and_rules_equal_the_reference(arch):
    jcfg, cfg = _cfgs(arch)["full"]
    want = _axes_leaves(jax_axes_tree(jcfg))
    import jax
    assert want == jax.tree.leaves(jax_axes_tree(jcfg), is_leaf=_is_axes)
    got = _axes_leaves(logical_axes_tree(cfg))
    assert got == want and len(got) > 5
    assert rules_for(cfg).rules == JR.rules_for(jcfg).rules
    assert PP.DEFAULT_RULES == JP.DEFAULT_RULES


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batch_specs_equal_the_reference(shape):
    """Every config's batch at each run shape: shapes, dtypes and specs
    (the reference's ``batch_specs`` axes, through its own rules)."""
    for arch in ARCH_IDS:
        jcfg, cfg = _cfgs(arch)["full"]
        js = JSHAPES[shape]
        b, s = js.global_batch, js.seq_len
        axes = {"tokens": ("batch", "seq") if js.kind != "decode"
                else ("batch", None), "labels": ("batch", "seq"),
                "vision_embeds": ("batch", "patches", "embed"),
                "audio_frames": ("batch", "frames", "embed")}
        for name, sizes in MESHES.items():
            jm = _jmesh(sizes)
            got = batch_specs(cfg, SHAPES[shape], sizes)
            want_keys = {"tokens"} | ({"labels"} if js.kind == "train"
                                      else set())
            if js.kind != "decode":
                want_keys |= ({"vision_embeds"} if jcfg.n_vision_tokens
                              else set())
                want_keys |= ({"audio_frames"} if jcfg.n_audio_frames
                              else set())
            assert set(got) == want_keys, (arch, shape)
            for k, ms in got.items():
                shp = tuple(ms.meta.shape)
                assert shp[0] == b and (k not in ("tokens", "labels") or
                                        shp[1] == (1 if js.kind == "decode"
                                                   else s))
                assert ms.meta.dtype == (torch.int32 if k in
                                         ("tokens", "labels")
                                         else getattr(torch, cfg.dtype))
                want = JP._filter_divisible(
                    JP.spec_for(axes[k], jm, JR.rules_for(jcfg)), shp, jm)
                assert _plain(ms.spec) == _plain(want), (arch, shape, k, name)


def test_placements_replication_and_constraint():
    """Specs as DTensor placements, one a mesh dim; a spec is replicated
    where each axis it names has size 1; ``constraint`` is the identity
    there, and on a sharded spec needs a process coordinate (a geometry
    alone raises; ``tests/test_torch_tp.py`` executes it on four
    processes); ``local_shard`` cuts the block of a coordinate, the first
    axis of an entry major."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = PP.P(("pod", "data"), None, "model")
    assert PP.placements(spec, sizes) == (Shard(0), Shard(0), Shard(2))
    assert PP.placements(PP.P(None, "model"), sizes) == \
        (Replicate(), Replicate(), Shard(1))
    assert PP.placements(PP.P(), {"data": 4}) == (Replicate(),)
    assert not PP.is_replicated(spec, sizes)
    assert PP.is_replicated(PP.P("model"), {"data": 4, "model": 1})
    x = torch.ones(8, 4)
    assert PP.constraint(x, ("batch", "embed")) is x
    assert PP.constraint(x, ("embed", "ffn"), {"data": 4}) is x
    with pytest.raises(TypeError, match="no process coordinate"):
        PP.constraint(x, ("batch", "embed"), {"data": 4})
    assert torch.equal(PP.local_shard(x, PP.P("data"), {"data": 4},
                                      {"data": 1}), x[2:4])
    y = torch.arange(8 * 3 * 4).reshape(8, 3, 4)
    assert torch.equal(PP.local_shard(y, spec, sizes,
                                      {"pod": 1, "data": 0, "model": 1}),
                       y[4:6, :, 2:4])
    with pytest.raises(TypeError, match="not a mesh"):
        PP.axis_sizes(object())
    # the rules replicate every Llama parameter on a data mesh and shard
    # DeepSeek's embed dims on it (its ("embed", "data") override)
    for arch, want in (("llama3.2-3b", True), ("deepseek-moe-16b", False)):
        cfg = smoke(get(arch))
        leaves = tree_leaves(param_specs(cfg, {"data": 4}))
        assert all(PP.is_replicated(m.spec, {"data": 4})
                   for m in leaves) == want, arch
    assert repr(PP.P("data", None)) == "PartitionSpec('data', None)"

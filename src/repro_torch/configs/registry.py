"""Architecture registry and the scenario zoo.

``get(arch_id)`` resolves the assigned ids (``src/repro/configs/
registry.py:31-49``).  ``SCENARIOS``/:func:`build_scenario` are the port of
the reference's model-zoo workloads (``registry.py:146-314``): one traced
scenario per model family, combining real compute costs (the cost walker
over the family's smoke-config step functions on meta tensors:
:func:`_model_costs`) with the family's canonical parallelism schedule
recorded through :class:`~repro_torch.core.tracer.TraceSession`.  Builders
return columnar :class:`~repro_torch.core.trace_ir.TraceStore` traces.
All five scenarios trace, and :func:`ingest_scenarios` streams them into a
:class:`~repro_torch.core.corpus_store.CorpusStore`.

:func:`rules_for` is a config's logical-axis rules (the defaults with the
config's ``rules_overrides``); :func:`param_specs` and :func:`batch_specs`
pair each parameter and batch array, as a meta tensor, with its
:class:`~repro_torch.sharding.partition.PartitionSpec` on a mesh, and
:func:`cache_specs` and :func:`input_specs` the decode cache and the
dry-run argument tuples (train: params, optimizer state, batch; prefill:
params, batch; decode: params, cache, batch, position) the same way.  The
decode cache's layout is what ``model.init_cache(mesh=)`` allocates and
the sharded decode step executes; the dry run that lowers these arguments
waits (ROADMAP, queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.configs.base import ArchConfig, RunShape, smoke
from repro_torch.sharding.partition import (
    LogicalRules, PartitionSpec, sharding_for_shape,
)

_MODULES = {
    "gemma3-4b": "gemma3_4b",
    "qwen3-32b": "qwen3_32b",
    "qwen3-8b": "qwen3_8b",
    "llama3.2-3b": "llama32_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "mamba2-2.7b": "mamba2_27b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v01_52b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def rules_for(cfg: ArchConfig) -> LogicalRules:
    rules = LogicalRules()
    if cfg.rules_overrides:
        rules = rules.with_overrides(**dict(cfg.rules_overrides))
    return rules


@dataclasses.dataclass(frozen=True)
class MetaSpec:
    """An array's stand-in (a meta tensor: shape and dtype) with its spec on
    a mesh: the port's ``ShapeDtypeStruct(..., sharding=...)``."""
    meta: torch.Tensor
    spec: PartitionSpec


def batch_specs(cfg: ArchConfig, shape: RunShape, mesh, rules=None) -> dict:
    """The batch of ``shape``'s kind as MetaSpecs (modalities stubbed)."""
    rules = rules or rules_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def sds(shp, dtype, axes):
        return MetaSpec(_meta(shp, dtype),
                        sharding_for_shape(shp, axes, mesh, rules))

    if shape.kind == "train":
        out = {"tokens": sds((b, s), torch.int32, ("batch", "seq")),
               "labels": sds((b, s), torch.int32, ("batch", "seq"))}
    elif shape.kind == "prefill":
        out = {"tokens": sds((b, s), torch.int32, ("batch", "seq"))}
    else:  # decode: one new token
        out = {"tokens": sds((b, 1), torch.int32, ("batch", None))}
    if cfg.n_vision_tokens and shape.kind != "decode":
        out["vision_embeds"] = sds((b, cfg.n_vision_tokens, cfg.d_model), dt,
                                   ("batch", "patches", "embed"))
    if cfg.n_audio_frames and shape.kind != "decode":
        out["audio_frames"] = sds((b, cfg.n_audio_frames, cfg.d_model), dt,
                                  ("batch", "frames", "embed"))
    return out


def param_specs(cfg: ArchConfig, mesh, rules=None) -> dict:
    """Every parameter as a MetaSpec, in the parameter tree's structure."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import init_abstract, logical_axes_tree
    rules = rules or rules_for(cfg)
    return tree_map(
        lambda t, ax: MetaSpec(t, sharding_for_shape(tuple(t.shape), ax, mesh,
                                                     rules)),
        init_abstract(cfg), logical_axes_tree(cfg))


def cache_specs(cfg: ArchConfig, shape: RunShape, mesh, rules=None):
    """The decode cache of ``shape`` (its global batch and context) as
    MetaSpecs, in the cache's structure."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import abstract_cache, cache_logical_axes
    rules = rules or rules_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    return tree_map(
        lambda t, ax: MetaSpec(t, sharding_for_shape(tuple(t.shape), ax, mesh,
                                                     rules)),
        abstract_cache(cfg, b, s), cache_logical_axes(cfg, b, s))


def input_specs(arch_id: str, shape_name: str, mesh, *,
                with_opt: bool = True):
    """``(cfg, args)``: the step's argument tuple of (arch x shape) as
    MetaSpecs, as the reference's ``input_specs`` gives them.

    train   -> (params, opt_state, batch)   (``with_opt=False``: no
               opt_state)
    prefill -> (params, batch)
    decode  -> (params, cache, batch, pos)
    """
    from repro_torch.configs.base import SHAPES
    cfg = get(arch_id)
    shape = SHAPES[shape_name]
    rules = rules_for(cfg)
    params = param_specs(cfg, mesh, rules)
    batch = batch_specs(cfg, shape, mesh, rules)
    if shape.kind == "train":
        if not with_opt:
            return cfg, (params, batch)
        from repro_torch.train.optimizer import abstract_opt_state
        return cfg, (params, abstract_opt_state(params), batch)
    if shape.kind == "prefill":
        return cfg, (params, batch)
    pos = MetaSpec(_meta((), torch.int32), PartitionSpec())
    return cfg, (params, cache_specs(cfg, shape, mesh, rules), batch, pos)


# ---------------------------------------------------------------------------
# scenario zoo (corpus-level synthesis targets)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One model-zoo workload: which architecture's step functions provide
    the (walked) compute costs, and which parallelism schedule shapes the
    recorded communication pattern."""
    name: str
    arch_id: str
    family: str          # transformer | flash | ssm | moe | encdec
    parallelism: str
    n_ranks: int         # default trace width
    steps: int           # default steps / microbatches / decode tokens


SCENARIOS: dict[str, ScenarioSpec] = {
    "transformer-dp": ScenarioSpec(
        "transformer-dp", "qwen3-8b", "transformer", "data_parallel", 8, 4),
    "flash-ring": ScenarioSpec(
        "flash-ring", "gemma3-4b", "flash", "ring_attention", 8, 2),
    "ssm-decode": ScenarioSpec(
        "ssm-decode", "mamba2-2.7b", "ssm", "tp_decode", 8, 6),
    "moe-ep": ScenarioSpec(
        "moe-ep", "deepseek-moe-16b", "moe", "expert_parallel", 8, 4),
    "encdec-pipeline": ScenarioSpec(
        "encdec-pipeline", "whisper-large-v3", "encdec", "pipeline", 8, 4),
}

SCENARIO_IDS = tuple(SCENARIOS)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_sds(cfg: ArchConfig, b: int, s: int, kind: str) -> dict:
    """Batch of meta tensors (tracing needs shapes only).  Decode steps
    never carry the modalities (prefill populated the cache)."""
    out = {"tokens": _meta((b, s), torch.int32)}
    if kind == "loss":
        out["labels"] = _meta((b, s), torch.int32)
    dt = getattr(torch, cfg.dtype)
    if cfg.n_vision_tokens and kind != "decode":
        out["vision_embeds"] = _meta((b, cfg.n_vision_tokens, cfg.d_model), dt)
    if cfg.n_audio_frames and kind != "decode":
        out["audio_frames"] = _meta((b, cfg.n_audio_frames, cfg.d_model), dt)
    return out


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _model_costs(cfg: ArchConfig, kinds=("train", "prefill", "decode"),
                 b: int = 2, s: int = 8) -> dict[str, tuple]:
    """The six-metric costs of the family's step functions: train (loss and
    its gradient in every parameter), prefill of ``s`` tokens, and one
    decode step against a cache of ``4 s``, walked on meta tensors.

    The reference traces the decode position as a scalar; the port's decode
    takes a Python int, here ``s`` (the token after an ``s``-token
    prompt)."""
    from repro_torch.core.tracer import compute_cost
    from repro_torch.models.model import (
        abstract_cache, build_forward, init_abstract,
    )

    params = init_abstract(cfg)
    out: dict[str, tuple] = {}
    if "train" in kinds:
        loss = build_forward(cfg, "loss")

        def value_and_grad(p, bt):
            leaves = _leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            with torch.enable_grad():
                val = loss(p, bt, cfg)
                grads = torch.autograd.grad(val, leaves, allow_unused=True)
            return val, grads

        out["train"] = tuple(compute_cost(value_and_grad, params,
                                          _batch_sds(cfg, b, s, "loss")))
    if "prefill" in kinds:
        prefill = build_forward(cfg, "prefill")
        out["prefill"] = tuple(compute_cost(
            lambda p, bt: prefill(p, bt, cfg), params,
            _batch_sds(cfg, b, s, "prefill")))
    if "decode" in kinds:
        decode = build_forward(cfg, "decode")
        cache = abstract_cache(cfg, b, 4 * s)
        out["decode"] = tuple(compute_cost(
            lambda p, c, bt: decode(p, c, bt, s, cfg), params, cache,
            _batch_sds(cfg, b, 1, "decode")))
    return out


def build_scenario(name: str, n_ranks: int | None = None,
                   steps: int | None = None):
    """Trace one zoo scenario into a columnar
    :class:`~repro_torch.core.trace_ir.TraceStore`."""
    from repro_torch.core.events import CommEvent, ComputeEvent
    from repro_torch.core.tracer import TraceSession, compute_cost

    spec = SCENARIOS[name]
    n = spec.n_ranks if n_ranks is None else n_ranks
    steps = spec.steps if steps is None else steps
    cfg = smoke(get(spec.arch_id))
    kinds = {"transformer": ("train",), "flash": ("prefill",),
             "ssm": ("decode",), "moe": ("train", "prefill"),
             "encdec": ("prefill", "decode")}[spec.family]
    costs = _model_costs(cfg, kinds)
    d = cfg.d_model

    if spec.family == "transformer":
        # data-parallel training: step compute + bucketed gradient psums
        g1 = CommEvent("psum", (d, cfg.d_ff), "float32", ("dp",))
        g2 = CommEvent("psum", (cfg.padded_vocab, d), "float32", ("dp",))
        with TraceSession(n, {"dp": n}) as sess:
            for _ in range(steps):
                sess.emit(None, ComputeEvent(costs["train"]))
                sess.emit(None, g1)
                sess.emit(None, g2)
        return sess.to_store()

    if spec.family == "flash":
        # ring-attention prefill: per hop, one flash chunk + KV-block shift
        from repro_torch.models.flash import flash_attention
        b, s, h, g, hd = 2, 16, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = _meta((b, s, h, hd), torch.float32)
        kv = _meta((b, s, g, hd), torch.float32)
        chunk = tuple(compute_cost(
            lambda q, k, v: flash_attention(q, k, v, causal=False,
                                            q_chunk=8, kv_chunk=8),
            q, kv, kv))
        shift = CommEvent("ppermute", (b, s, g, hd), "float32", ("ring",),
                          ("shift", 1))
        with TraceSession(n, {"ring": n}) as sess:
            for _ in range(steps):
                for _hop in range(n - 1):
                    sess.emit(None, ComputeEvent(chunk))
                    sess.emit(None, shift)
                sess.emit(None, ComputeEvent(costs["prefill"]))
                sess.emit(None, CommEvent("all_gather", (b, s // 2 or 1, d),
                                          "float32", ("ring",), (0,)))
        return sess.to_store()

    if spec.family == "ssm":
        # tensor-parallel decode: one SSM decode step + logits psum a token
        logits = CommEvent("psum", (2, cfg.padded_vocab), "float32", ("mp",))
        with TraceSession(n, {"mp": n}) as sess:
            for _ in range(steps):
                sess.emit(None, ComputeEvent(costs["decode"]))
                sess.emit(None, logits)
        return sess.to_store()

    if spec.family == "moe":
        # expert-parallel training: token dispatch/combine all_to_alls
        # around the expert compute, then the gradient psum
        tok = (2 * 8 // n or 1, d)
        disp = CommEvent("all_to_all", tok, "float32", ("ep",), (0, 0))
        grads = CommEvent("psum", (d, cfg.d_ff_expert or cfg.d_ff),
                          "float32", ("ep",))
        with TraceSession(n, {"ep": n}) as sess:
            for _ in range(steps):
                sess.emit(None, ComputeEvent(costs["prefill"]))
                sess.emit(None, disp)
                sess.emit(None, ComputeEvent(costs["train"]))
                sess.emit(None, disp)
                sess.emit(None, grads)
        return sess.to_store()

    # encdec: a two-stage pipeline; encoder ranks prefill and ship their
    # activations to a decoder peer, which runs decode steps (heterogeneous
    # per-rank mains: the Algorithm 1 clustering case)
    half = max(n // 2, 1)
    act = CommEvent("ppermute", (2, 8, d), "float32", ("stage",),
                    ("shift", half))
    with TraceSession(n, {"stage": n}) as sess:
        for _ in range(steps):
            for r in range(half):
                peer = r + half
                sess.emit([r], ComputeEvent(costs["prefill"]))
                if peer < n:
                    sess.emit([r, peer], act)
                    sess.emit([peer], ComputeEvent(costs["decode"]))
        sess.emit(None, CommEvent("psum", (d,), "float32", ("stage",)))
    return sess.to_store()


def ingest_scenarios(corpus_store, names=None, **build_kwargs) -> list[str]:
    """Stream zoo scenarios into a
    :class:`repro_torch.core.corpus_store.CorpusStore` **one at a time** —
    each :func:`build_scenario` result is appended (and incrementally
    clustered) before the next is built, so the corpus never needs the
    whole zoo in memory.  Scenarios already in the store are skipped
    (re-running is an idempotent catch-up).  Returns the names added.
    (The reference's ``registry.py:317-331``.)
    """
    added = []
    for name in (SCENARIO_IDS if names is None else names):
        if name in corpus_store:
            continue
        corpus_store.add_scenario(name, build_scenario(name, **build_kwargs))
        added.append(name)
    return added

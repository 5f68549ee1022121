"""Decoder-only LM assembly: the training loss, prefill and decode for the
dense and SSM families.

The port of ``src/repro/models/transformer.py`` for layer kinds ``g``
(global attention), ``l`` (sliding window) and ``m`` (Mamba2).  Parameters
and caches keep the reference's stacked layout: layers are grouped into the
config's repeating unit, every leaf of ``params["unit"]`` has a leading
``n_units`` dim, and remainder layers sit in the ``rest`` tuple.  Where the
reference scans over the units, the port runs
:func:`~repro_torch.core.tracer.scan_loop` over the stacked leaves: a
Python loop over views of each unit, which the cost walker charges as the
reference's walker charges the scan (the slices cost nothing, one scan
step a unit).  ``cfg.remat`` checkpoints each unit
(``torch.utils.checkpoint``, which saves nothing inside it: the
reference's ``nothing_saveable`` policy).
MoE layers (:mod:`repro_torch.models.moe`) take the layer's index, as in
the reference, and ``backbone`` sums their balance loss over the layers.
Cross-attention inside the LM (kind ``x``, the VLM) waits for a later
slice of the port and raises.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tracer import scan_loop, uncharged
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.layers import (
    Param, chunked_loss, embed_lookup, embed_params, mlp_apply, mlp_params,
    rms_norm, torch_dtype, unembed,
)

PORTED_KINDS = ("g", "l", "m")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def check_ported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not run yet."""
    bad = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: layer kinds {bad} are not ported yet (the VLM's "
            "cross-attention layers: ROADMAP, queue 1, item 4)")


def unit_len(cfg: ArchConfig) -> int:
    u = len(cfg.layer_pattern)
    if cfg.n_experts:
        u = _lcm(u, cfg.moe_every)
    return min(u, cfg.n_layers)


def _layer_param(cfg: ArchConfig, kind: str, li: int) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    p: dict[str, Any] = {"ln1": Param((d,), ("embed",), scale=0.0, dtype="float32")}
    if kind == "m":
        p["mixer"] = S.ssm_params(d, expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim,
                                  n_state=cfg.ssm_state,
                                  n_groups=cfg.ssm_groups, dtype=dt)
    else:
        p["attn"] = A.attn_params(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                  cfg.qk_norm, dt)
    if cfg.is_moe_layer(li):
        p["ln2"] = Param((d,), ("embed",), scale=0.0, dtype="float32")
        p["moe"] = M.moe_params(d, cfg.n_experts, cfg.d_ff_expert,
                                cfg.n_shared_experts, cfg.d_ff_expert, dt)
    elif cfg.d_ff:
        p["ln2"] = Param((d,), ("embed",), scale=0.0, dtype="float32")
        p["mlp"] = mlp_params(d, cfg.d_ff, dt)
    return p


def _stack(p: Any, n: int) -> Any:
    """Prepend a ("layers", n) stacking dim to every Param leaf."""
    if isinstance(p, dict):
        return {k: _stack(v, n) for k, v in p.items()}
    return Param((n,) + p.shape, ("layers",) + p.axes, p.scale, p.dtype)


def init_lm(cfg: ArchConfig) -> dict:
    """The Param tree of the LM (the reference's ``init_lm``)."""
    check_ported(cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    return {
        "embed": embed_params(cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "final_norm": Param((cfg.d_model,), ("embed",), scale=0.0,
                            dtype="float32"),
        "unit": tuple(_stack(_layer_param(cfg, kinds[j], j), n_units)
                      for j in range(u)),
        "rest": tuple(_layer_param(cfg, kinds[n_units * u + j],
                                   n_units * u + j)
                      for j in range(cfg.n_layers % u)),
    }


def _layers(cfg: ArchConfig, tree: dict):
    """(kind, unit index or None, slot, subtree) of every layer in order:
    the stacked unit layers, then the remainder."""
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    for i in range(n_units):
        for j in range(u):
            yield kinds[j], i, j, tree["unit"][j]
    for j, sub in enumerate(tree["rest"]):
        yield kinds[n_units * u + j], None, j, sub


def _index(tree: Any, i: int | None) -> Any:
    """Layer ``i`` of a stacked subtree (views, no copies)."""
    if i is None:
        return tree
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, A.KVCache):
        return A.KVCache(tree.k[i], tree.v[i])
    return tree[i]


def _write_back(dst: Any, src: Any) -> None:
    """Store a layer's new cache into its slot of the stacked buffers, in
    place (a leaf that is already a view of its slot was updated in place).
    The reference returns the new caches as the unit scan's ys, which its
    walker charges nothing for: so does the port's."""
    if isinstance(dst, dict):
        for k in dst:
            _write_back(dst[k], src[k])
        return
    if isinstance(dst, A.KVCache):
        _write_back(dst.k, src.k)
        _write_back(dst.v, src.v)
        return
    if dst is not src and (dst.device.type == "meta"
                           or dst.data_ptr() != src.data_ptr()):
        with uncharged():
            dst.copy_(src)


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    x = embed_lookup(params["embed"], batch["tokens"])
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _ffn(cfg: ArchConfig, li: int, p: dict, x: torch.Tensor):
    """The layer's feed-forward half: (x, MoE aux loss or None)."""
    if cfg.is_moe_layer(li):
        ff, aux = M.moe_apply(p["moe"], rms_norm(x, p["ln2"]), cfg.top_k,
                              cfg.capacity_factor)
        return x + ff, aux
    if cfg.d_ff:
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))
    return x, None


def _apply_layer(cfg: ArchConfig, kind: str, li: int, p: dict,
                 x: torch.Tensor, positions: torch.Tensor):
    """One layer of the training forward (no cache): (x, aux or None)."""
    h = rms_norm(x, p["ln1"])
    if kind == "m":
        mix = S.ssm_apply(p["mixer"], h, head_dim=cfg.ssm_head_dim,
                          n_state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                          expand=cfg.ssm_expand, chunk=cfg.ssm_chunk)
    else:
        win = cfg.window if kind == "l" and cfg.window else None
        mix, _ = A.attention(p["attn"], h, positions, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                             theta=cfg.rope_theta, window=win, causal=True)
    return _ffn(cfg, li, p, x + mix)


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """Embedded input (b, s, d) -> (final hidden states (b, s, d), aux).

    aux is the MoE balance loss of the reference, summed over the MoE
    layers (0 without any).  It rides in the unit loop's carry, inside the
    checkpointed unit, as in the reference's scan."""
    check_ported(cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def add(aux, a):
        return aux if a is None else aux + a

    def unit_body(h, aux, unit_p):
        for j in range(u):
            h, a = _apply_layer(cfg, kinds[j], j, unit_p[j], h, positions)
            aux = add(aux, a)
        return h, aux

    def body(carry, unit_p):
        if cfg.remat:
            return checkpoint(unit_body, *carry, unit_p, use_reentrant=False)
        return unit_body(*carry, unit_p)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = scan_loop(n_units, body, (x, aux), xs=params["unit"])
    for j, p in enumerate(params["rest"]):
        li = n_units * u + j
        x, a = _apply_layer(cfg, kinds[li], li, p, x, positions)
        aux = add(aux, a)
    return rms_norm(x, params["final_norm"]), aux


def lm_loss(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Causal-LM CE loss (+ 0.01 x the MoE aux loss): batch =
    {tokens (b, s), labels (b, s)}.  Builds no decode cache."""
    x = embed_inputs(params, batch, cfg)
    h, aux = backbone(params, x, cfg)
    loss = chunked_loss(h, params["embed"], batch["labels"], cfg.loss_chunk)
    return loss + 0.01 * aux


def _cache_len(cfg: ArchConfig, kind: str, seq_len: int) -> int:
    if kind == "l" and cfg.window and cfg.window < seq_len:
        return cfg.window
    return seq_len


def init_lm_cache(cfg: ArchConfig, batch: int, seq_len: int, device) -> dict:
    """Zero caches for decode at context length ``seq_len``."""
    check_ported(cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    dt = torch_dtype(cfg.dtype)

    def one(kind: str, lead: tuple):
        if kind == "m":
            c = S.init_ssm_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                                 head_dim=cfg.ssm_head_dim,
                                 n_state=cfg.ssm_state,
                                 n_groups=cfg.ssm_groups, dtype=dt,
                                 device=device)
            return {k: v.expand(lead + v.shape).contiguous()
                    for k, v in c.items()}
        shape = lead + (batch, _cache_len(cfg, kind, seq_len),
                        cfg.n_kv_heads, cfg.hd)
        return A.KVCache(torch.zeros(shape, dtype=dt, device=device),
                         torch.zeros(shape, dtype=dt, device=device))

    return {"unit": tuple(one(kinds[j], (n_units,)) for j in range(u)),
            "rest": tuple(one(kinds[n_units * u + j], ())
                          for j in range(cfg.n_layers % u))}


def lm_prefill(params: dict, batch: dict, cfg: ArchConfig):
    """Full-sequence forward building decode caches.

    Returns (last-position logits (b, vocab), cache).  Attention caches hold
    the full (or window-tail, in ring order) K/V in ``cfg.dtype``; SSM
    caches hold the final state and the conv tail.  The cache has the
    reference's stacked layout: the unit scan's ys."""
    check_ported(cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    x = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    dt = torch_dtype(cfg.dtype)

    def prefill_layer(kind, li, p, h):
        hh = rms_norm(h, p["ln1"])
        if kind == "m":
            mix, cache = S.ssm_apply(p["mixer"], hh, head_dim=cfg.ssm_head_dim,
                                     n_state=cfg.ssm_state,
                                     n_groups=cfg.ssm_groups,
                                     expand=cfg.ssm_expand,
                                     chunk=cfg.ssm_chunk, return_cache=True)
        else:
            win = cfg.window if kind == "l" and cfg.window else None
            mix, (k, v) = A.attention(p["attn"], hh, positions,
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                      theta=cfg.rope_theta, window=win,
                                      causal=True)
            cl = _cache_len(cfg, kind, s)
            if cl < s:
                # ring layout: position p lives at slot p % window
                k = torch.roll(k[:, s - cl:], s % cl, dims=1)
                v = torch.roll(v[:, s - cl:], s % cl, dims=1)
            cache = A.KVCache(k.to(dt), v.to(dt))
        return _ffn(cfg, li, p, h + mix)[0], cache

    def unit_body(h, unit_p):
        caches = []
        for j in range(u):
            h, c = prefill_layer(kinds[j], j, unit_p[j], h)
            caches.append(c)
        return h, tuple(caches)

    x, unit_cache = scan_loop(n_units, unit_body, x, xs=params["unit"],
                              stack_ys=True)
    rest_cache = []
    for j, p in enumerate(params["rest"]):
        li = n_units * u + j
        x, c = prefill_layer(kinds[li], li, p, x)
        rest_cache.append(c)
    x = rms_norm(x, params["final_norm"])
    logits = unembed(x[:, -1:], params["embed"])[:, 0]
    return logits, {"unit": unit_cache, "rest": tuple(rest_cache)}


def _decode_layer(cfg: ArchConfig, kind: str, li: int, p: dict,
                  x: torch.Tensor, c: Any, pos: int):
    h = rms_norm(x, p["ln1"])
    if kind == "m":
        mix, new = S.ssm_decode(p["mixer"], h, c, head_dim=cfg.ssm_head_dim,
                                n_state=cfg.ssm_state,
                                n_groups=cfg.ssm_groups,
                                expand=cfg.ssm_expand)
    else:
        win = cfg.window if kind == "l" and cfg.window else None
        mix, new = A.decode_attention(p["attn"], h, c, pos,
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                      theta=cfg.rope_theta, window=win)
    _write_back(c, new)
    return _ffn(cfg, li, p, x + mix)[0]


def lm_decode_step(params: dict, cache: dict, batch: dict, pos: int,
                   cfg: ArchConfig):
    """One new token against the cache.  batch = {tokens (b,1)}.

    Returns (logits (b, vocab), cache); the cache's buffers are updated in
    place (the reference returns new ones)."""
    check_ported(cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    x = embed_inputs(params, batch, cfg)

    def unit_body(h, pc):
        unit_p, unit_c = pc
        for j in range(u):
            h = _decode_layer(cfg, kinds[j], j, unit_p[j], h, unit_c[j],
                              pos)
        return h

    x = scan_loop(n_units, unit_body, x, xs=(params["unit"], cache["unit"]))
    for j, p in enumerate(params["rest"]):
        li = n_units * u + j
        x = _decode_layer(cfg, kinds[li], li, p, x, cache["rest"][j], pos)
    x = rms_norm(x, params["final_norm"])
    logits = unembed(x[:, 0:1], params["embed"])[:, 0]
    return logits, cache

"""Decoder-only LM assembly: the training loss, prefill and decode for the
dense, SSM, MoE and vision-language families.

The port of ``src/repro/models/transformer.py`` for every layer kind of the
zoo: ``g`` and ``s`` (global causal self-attention), ``l`` (sliding
window), ``m`` (Mamba2) and ``x`` (the VLM's image layers: self-attention,
then cross-attention to the vision states).  Parameters
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
The VLM's vision frontend is the reference's stub: precomputed patch
embeddings (b, n_vision_tokens, d) under ``vision_embeds``, cast to the
config's dtype and normed by ``vision_norm`` (:func:`vision_states`); an
``x`` layer's prefill caches the cross K/V of those states beside its self
cache, and decode reads them back.  As in the reference, an ``x`` layer's
prefill projects the vision states to K/V twice (inside
``cross_attention`` and for the cache).

The entry points take the reference's ``mesh``: a ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`) on which this process runs its part, SPMD.
The parameters, the batch rows and the caches are this process's blocks
(``partition.shard_params``, the batch's ``("batch", ...)`` spec,
``model.init_cache(mesh=)``); prefill's logits are its vocab block.  Where
the config's rules split parameters, or experts route across a data mesh,
the layers run on the mesh's SPMD context
(:mod:`repro_torch.sharding.spmd`): every family and layer kind, on any
``data × model`` (and ``pod``) mesh, attention in the reference's mode
(``models/attention.py``) and MoE layers with their experts or their
expert FFN split over ``model`` and their routing per data shard
(``models/moe.py``).  The vision states are this process's batch rows,
every patch (``("batch", "patches", "embed")``).
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
from repro_torch.sharding import spmd

PORTED_KINDS = ("g", "l", "m", "s", "x")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def check_ported(cfg: ArchConfig) -> None:
    """Raise for a layer kind the port does not know (every kind of the
    reference's zoo is ported)."""
    bad = sorted(set(cfg.layer_kinds()) - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: unknown layer kinds {bad} (the port runs "
            f"{list(PORTED_KINDS)})")


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
    if kind == "x":
        p["xattn"] = A.attn_params(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                   cfg.qk_norm, dt)
        p["ln_x"] = Param((d,), ("embed",), scale=0.0, dtype="float32")
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
    params = {
        "embed": embed_params(cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "final_norm": Param((cfg.d_model,), ("embed",), scale=0.0,
                            dtype="float32"),
        "unit": tuple(_stack(_layer_param(cfg, kinds[j], j), n_units)
                      for j in range(u)),
        "rest": tuple(_layer_param(cfg, kinds[n_units * u + j],
                                   n_units * u + j)
                      for j in range(cfg.n_layers % u)),
    }
    if cfg.n_vision_tokens:
        params["vision_norm"] = Param((cfg.d_model,), ("embed",), scale=0.0,
                                      dtype="float32")
    return params


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


def _norm_w(mesh, w: torch.Tensor) -> torch.Tensor:
    """A norm's weight (d,), its ``embed`` split gathered on a mesh."""
    if mesh is None:
        return w
    return mesh.unshard(w, (mesh.cfg.d_model,), ("embed",))


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig, mesh=None
                 ) -> torch.Tensor:
    mesh = spmd.context(mesh, cfg)
    x = embed_lookup(params["embed"], batch["tokens"], mesh)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def vision_states(params: dict, batch: dict, cfg: ArchConfig, mesh=None):
    """The VLM's normed vision states (b, n_vision_tokens, d) from the
    batch's ``vision_embeds``, or None (no vision tokens, or none given).
    The embeddings are cast to the config's dtype first, as the
    encoder-decoder's frames are (``encdec.encode``): the data pipeline
    draws them in f32, and a bf16 model's projections take bf16 (a no-op
    in f32 and for the serve engine's embeddings)."""
    if not cfg.n_vision_tokens or "vision_embeds" not in batch:
        return None
    v = batch["vision_embeds"].to(torch_dtype(cfg.dtype))
    return rms_norm(v, _norm_w(mesh, params["vision_norm"]))


def _cross(cfg: ArchConfig, p: dict, x: torch.Tensor, vision, kv=None,
           mesh=None):
    """An ``x`` layer's cross-attention half: x + its cross-attention to
    the vision states (or to the cached ``kv``)."""
    hx = rms_norm(x, _norm_w(mesh, p["ln_x"]))
    return x + A.cross_attention(p["xattn"], hx, vision, n_heads=cfg.n_heads,
                                 n_kv=cfg.n_kv_heads, head_dim=cfg.hd, kv=kv,
                                 mesh=mesh, kv_len=cfg.n_vision_tokens)


def _ffn(cfg: ArchConfig, li: int, p: dict, x: torch.Tensor, mesh=None):
    """The layer's feed-forward half: (x, MoE aux loss or None)."""
    if cfg.is_moe_layer(li):
        ff, aux = M.moe_apply(p["moe"], rms_norm(x, _norm_w(mesh, p["ln2"])),
                              cfg.top_k, cfg.capacity_factor, mesh)
        return x + ff, aux
    if cfg.d_ff:
        x = x + mlp_apply(p["mlp"], rms_norm(x, _norm_w(mesh, p["ln2"])),
                          mesh)
    return x, None


def _apply_layer(cfg: ArchConfig, kind: str, li: int, p: dict,
                 x: torch.Tensor, positions: torch.Tensor, vision=None,
                 mesh=None):
    """One layer of the training forward (no cache): (x, aux or None)."""
    h = rms_norm(x, _norm_w(mesh, p["ln1"]))
    if kind == "m":
        mix = S.ssm_apply(p["mixer"], h, head_dim=cfg.ssm_head_dim,
                          n_state=cfg.ssm_state, n_groups=cfg.ssm_groups,
                          expand=cfg.ssm_expand, chunk=cfg.ssm_chunk,
                          mesh=mesh)
    else:
        win = cfg.window if kind == "l" and cfg.window else None
        mix, _ = A.attention(p["attn"], h, positions, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                             theta=cfg.rope_theta, window=win, causal=True,
                             mesh=mesh)
    x = x + mix
    if kind == "x":
        x = _cross(cfg, p, x, vision, mesh=mesh)
    return _ffn(cfg, li, p, x, mesh)


def backbone(params: dict, x: torch.Tensor, cfg: ArchConfig, vision=None,
             mesh=None):
    """Embedded input (b, s, d) -> (final hidden states (b, s, d), aux).

    aux is the MoE balance loss of the reference, summed over the MoE
    layers (0 without any).  It rides in the unit loop's carry, inside the
    checkpointed unit, as in the reference's scan.  ``vision`` is the VLM's
    vision states (:func:`vision_states`), which every ``x`` layer
    attends to."""
    check_ported(cfg)
    mesh = spmd.context(mesh, cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def add(aux, a):
        return aux if a is None else aux + a

    def unit_body(h, aux, unit_p, vis):
        for j in range(u):
            h, a = _apply_layer(cfg, kinds[j], j, unit_p[j], h, positions,
                                vis, mesh)
            aux = add(aux, a)
        return h, aux

    def body(carry, unit_p):
        if cfg.remat:
            return checkpoint(unit_body, *carry, unit_p, vision,
                              use_reentrant=False)
        return unit_body(*carry, unit_p, vision)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = scan_loop(n_units, body, (x, aux), xs=params["unit"])
    for j, p in enumerate(params["rest"]):
        li = n_units * u + j
        x, a = _apply_layer(cfg, kinds[li], li, p, x, positions, vision,
                            mesh)
        aux = add(aux, a)
    return rms_norm(x, _norm_w(mesh, params["final_norm"])), aux


def lm_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
            ) -> torch.Tensor:
    """Causal-LM CE loss (+ 0.01 x the MoE aux loss): batch =
    {tokens (b, s), labels (b, s)[, vision_embeds (b, n_vision_tokens, d)]}.
    Builds no decode cache.  On a mesh, the mean over this process's rows
    (the same on each process of a ``model`` group)."""
    mesh = spmd.context(mesh, cfg)
    x = embed_inputs(params, batch, cfg, mesh)
    h, aux = backbone(params, x, cfg, vision_states(params, batch, cfg, mesh),
                      mesh)
    loss = chunked_loss(h, params["embed"], batch["labels"], cfg.loss_chunk,
                        mesh)
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
        kv = A.KVCache(torch.zeros(shape, dtype=dt, device=device),
                       torch.zeros(shape, dtype=dt, device=device))
        if kind == "x":
            xshape = lead + (batch, cfg.n_vision_tokens, cfg.n_kv_heads,
                             cfg.hd)
            return {"self": kv,
                    "xk": torch.zeros(xshape, dtype=dt, device=device),
                    "xv": torch.zeros(xshape, dtype=dt, device=device)}
        return kv

    return {"unit": tuple(one(kinds[j], (n_units,)) for j in range(u)),
            "rest": tuple(one(kinds[n_units * u + j], ())
                          for j in range(cfg.n_layers % u))}


def lm_prefill(params: dict, batch: dict, cfg: ArchConfig, mesh=None):
    """Full-sequence forward building decode caches.

    Returns (last-position logits (b, vocab), cache).  Attention caches hold
    the full (or window-tail, in ring order) K/V in ``cfg.dtype``; SSM
    caches hold the final state and the conv tail; an ``x`` layer's cache
    is ``{"self": its KV cache, "xk", "xv": the cross K/V of the vision
    states}``.  The cache has the reference's stacked layout: the unit
    scan's ys.  On a mesh the logits are this process's vocab block and
    the K/V its kv heads (``attention.PREFILL_KV_AXES``)."""
    check_ported(cfg)
    mesh = spmd.context(mesh, cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    x = embed_inputs(params, batch, cfg, mesh)
    vision = vision_states(params, batch, cfg, mesh)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    dt = torch_dtype(cfg.dtype)

    def prefill_layer(kind, li, p, h):
        hh = rms_norm(h, _norm_w(mesh, p["ln1"]))
        if kind == "m":
            mix, cache = S.ssm_apply(p["mixer"], hh, head_dim=cfg.ssm_head_dim,
                                     n_state=cfg.ssm_state,
                                     n_groups=cfg.ssm_groups,
                                     expand=cfg.ssm_expand,
                                     chunk=cfg.ssm_chunk, return_cache=True,
                                     mesh=mesh)
        else:
            win = cfg.window if kind == "l" and cfg.window else None
            mix, (k, v) = A.attention(p["attn"], hh, positions,
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                      theta=cfg.rope_theta, window=win,
                                      causal=True, mesh=mesh)
            k, v = A.cache_rows(mesh, k, b), A.cache_rows(mesh, v, b)
            cl = _cache_len(cfg, kind, s)
            if cl < s:
                # ring layout: position p lives at slot p % window
                k = torch.roll(k[:, s - cl:], s % cl, dims=1)
                v = torch.roll(v[:, s - cl:], s % cl, dims=1)
            cache = A.KVCache(k.to(dt), v.to(dt))
        h = h + mix
        if kind == "x":
            h = _cross(cfg, p, h, vision, mesh=mesh)
            ck, cv = A.cross_kv(p["xattn"], vision, cfg.n_kv_heads, cfg.hd,
                                mesh)
            cache = {"self": cache, "xk": ck.to(dt), "xv": cv.to(dt)}
        return _ffn(cfg, li, p, h, mesh)[0], cache

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
    x = rms_norm(x, _norm_w(mesh, params["final_norm"]))
    logits = unembed(x[:, -1:], params["embed"], mesh)[:, 0]
    return logits, {"unit": unit_cache, "rest": tuple(rest_cache)}


def _decode_layer(cfg: ArchConfig, kind: str, li: int, p: dict,
                  x: torch.Tensor, c: Any, pos: int, mesh=None):
    h = rms_norm(x, _norm_w(mesh, p["ln1"]))
    if kind == "m":
        mix, new = S.ssm_decode(p["mixer"], h, c, head_dim=cfg.ssm_head_dim,
                                n_state=cfg.ssm_state,
                                n_groups=cfg.ssm_groups,
                                expand=cfg.ssm_expand, mesh=mesh)
    elif kind == "x":
        mix, selfc = A.decode_attention(p["attn"], h, c["self"], pos,
                                        n_heads=cfg.n_heads,
                                        n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                        theta=cfg.rope_theta, mesh=mesh)
        new = {"self": selfc, "xk": c["xk"], "xv": c["xv"]}
    else:
        win = cfg.window if kind == "l" and cfg.window else None
        mix, new = A.decode_attention(p["attn"], h, c, pos,
                                      n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                      theta=cfg.rope_theta, window=win,
                                      mesh=mesh)
    _write_back(c, new)
    x = x + mix
    if kind == "x":
        x = _cross(cfg, p, x, None, kv=(c["xk"], c["xv"]), mesh=mesh)
    return _ffn(cfg, li, p, x, mesh)[0]


def lm_decode_step(params: dict, cache: dict, batch: dict, pos: int,
                   cfg: ArchConfig, mesh=None):
    """One new token against the cache.  batch = {tokens (b,1)}; an ``x``
    layer reads the vision states' K/V from its cache.

    Returns (logits (b, vocab), cache); the cache's buffers are updated in
    place (the reference returns new ones).  On a mesh the cache is this
    process's block (``model.init_cache(mesh=)``) and the logits its vocab
    block."""
    check_ported(cfg)
    mesh = spmd.context(mesh, cfg)
    u = unit_len(cfg)
    n_units = cfg.n_layers // u
    kinds = cfg.layer_kinds()
    x = embed_inputs(params, batch, cfg, mesh)

    def unit_body(h, pc):
        unit_p, unit_c = pc
        for j in range(u):
            h = _decode_layer(cfg, kinds[j], j, unit_p[j], h, unit_c[j],
                              pos, mesh)
        return h

    x = scan_loop(n_units, unit_body, x, xs=(params["unit"], cache["unit"]))
    for j, p in enumerate(params["rest"]):
        li = n_units * u + j
        x = _decode_layer(cfg, kinds[li], li, p, x, cache["rest"][j], pos,
                          mesh)
    x = rms_norm(x, _norm_w(mesh, params["final_norm"]))
    logits = unembed(x[:, 0:1], params["embed"], mesh)[:, 0]
    return logits, cache

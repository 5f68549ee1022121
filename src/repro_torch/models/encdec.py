"""Encoder-decoder backbone (the whisper-large-v3 family).

The port of ``src/repro/models/encdec.py``.  The conv/mel front end is a
stub, as in the reference: the batch carries precomputed frame embeddings
(b, frames, d) under ``audio_frames``.  Encoder layers are non-causal
self-attention and an MLP; decoder layers causal self-attention,
cross-attention to the encoder states and an MLP.  RMSNorm and RoPE stand
in for Whisper's LayerNorm and learned positions, as in the reference.

The frames are cast to the config's dtype first.  The reference's serve
engine feeds them in that dtype; its data pipeline makes them f32, and
with bf16 weights jnp then promotes the encoder to f32 and the decoder's
scan carry from bf16 to f32 at its first cross-attention, where
``lax.scan`` raises (a reference-side problem, ROADMAP §3).  In f32, and
for frames already in the config's dtype, the cast changes nothing.

The reference's layer scans are :func:`~repro_torch.core.tracer.scan_loop`
over the stacked leaves, and its ``nothing_saveable`` remat is
``torch.utils.checkpoint`` of each layer, as in ``transformer.py``.  The
decode step writes the self-attention caches in place; the cross K/V
cache, filled by the prefill, is read only.

On a mesh (a ``DeviceMesh``; :mod:`repro_torch.sharding.spmd`) every
function takes ``mesh`` last, as the reference's, and runs SPMD on this
process's batch rows: the encoder's unmasked self-attention, the
decoder's causal self-attention and its cross-attention in the
reference's attention mode (``models/attention.py``), the MLPs column and
row parallel, the vocab split over ``model``.  The encoder states are
this process's rows, every frame, on each process of a ``model`` group.
The decode caches follow ``cache_specs``: the cross K/V's frames are
split over ``model`` where the axis divides them, else whole on each
process, whatever their number (``init_cache(n_frames=)`` keeps it on the
SPMD context, where the decode step reads it).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tracer import scan_loop
from repro_torch.models import attention as A
from repro_torch.models.layers import (
    Param, chunked_loss, embed_lookup, embed_params, mlp_apply, mlp_params,
    rms_norm, torch_dtype, unembed,
)
from repro_torch.models.transformer import _norm_w, _stack, _write_back
from repro_torch.sharding import spmd


def _enc_layer(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": Param((d,), ("embed",), scale=0.0, dtype="float32"),
        "attn": A.attn_params(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              cfg.qk_norm, cfg.dtype),
        "ln2": Param((d,), ("embed",), scale=0.0, dtype="float32"),
        "mlp": mlp_params(d, cfg.d_ff, cfg.dtype),
    }


def _dec_layer(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": Param((d,), ("embed",), scale=0.0, dtype="float32"),
        "attn": A.attn_params(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              cfg.qk_norm, cfg.dtype),
        "ln_x": Param((d,), ("embed",), scale=0.0, dtype="float32"),
        "xattn": A.attn_params(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               cfg.qk_norm, cfg.dtype),
        "ln2": Param((d,), ("embed",), scale=0.0, dtype="float32"),
        "mlp": mlp_params(d, cfg.d_ff, cfg.dtype),
    }


def init_encdec(cfg: ArchConfig) -> dict:
    """The Param tree (the reference's ``init_encdec``)."""
    return {
        "embed": embed_params(cfg.padded_vocab, cfg.d_model, cfg.dtype),
        "frame_norm": Param((cfg.d_model,), ("embed",), scale=0.0,
                            dtype="float32"),
        "encoder": _stack(_enc_layer(cfg), cfg.enc_layers),
        "enc_norm": Param((cfg.d_model,), ("embed",), scale=0.0,
                          dtype="float32"),
        "decoder": _stack(_dec_layer(cfg), cfg.n_layers),
        "final_norm": Param((cfg.d_model,), ("embed",), scale=0.0,
                            dtype="float32"),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _layers(cfg: ArchConfig, body, x, stack, n: int):
    """``scan_loop`` of ``body(h, layer_params)`` over the ``n`` layers of
    a stacked tree, each layer checkpointed under ``cfg.remat``."""
    def step(h, p):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(body, h, p, use_reentrant=False)
        return body(h, p)

    return scan_loop(n, step, x, xs=stack)


def _attn(cfg: ArchConfig, p: dict, h: torch.Tensor, positions, causal,
          mesh=None):
    return A.attention(p, h, positions, n_heads=cfg.n_heads,
                       n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                       theta=cfg.rope_theta, causal=causal, mesh=mesh)


def _cross(cfg: ArchConfig, p: dict, h: torch.Tensor, enc, kv=None,
           mesh=None):
    return A.cross_attention(p, h, enc, n_heads=cfg.n_heads,
                             n_kv=cfg.n_kv_heads, head_dim=cfg.hd, kv=kv,
                             mesh=mesh)


def _norm(mesh, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rms_norm(h, _norm_w(mesh, w))


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig, mesh=None
           ) -> torch.Tensor:
    """frames: precomputed (b, F, d) embeddings -> encoder states (in the
    config's dtype, which the frames are cast to)."""
    mesh = spmd.context(mesh, cfg)
    x = _norm(mesh, frames.to(torch_dtype(cfg.dtype)), params["frame_norm"])
    positions = _positions(x)

    def body(h, p):
        mix, _ = _attn(cfg, p["attn"], _norm(mesh, h, p["ln1"]), positions,
                       causal=False, mesh=mesh)
        h = h + mix
        return h + mlp_apply(p["mlp"], _norm(mesh, h, p["ln2"]), mesh)

    x = _layers(cfg, body, x, params["encoder"], cfg.enc_layers)
    return _norm(mesh, x, params["enc_norm"])


def _embed(params: dict, tokens: torch.Tensor, cfg: ArchConfig, mesh=None):
    x = embed_lookup(params["embed"], tokens, mesh)
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)


def _decoder_forward(params: dict, x: torch.Tensor, enc: torch.Tensor,
                     cfg: ArchConfig, mesh=None) -> torch.Tensor:
    positions = _positions(x)

    def body(h, p):
        mix, _ = _attn(cfg, p["attn"], _norm(mesh, h, p["ln1"]), positions,
                       causal=True, mesh=mesh)
        h = h + mix
        h = h + _cross(cfg, p["xattn"], _norm(mesh, h, p["ln_x"]), enc,
                       mesh=mesh)
        return h + mlp_apply(p["mlp"], _norm(mesh, h, p["ln2"]), mesh)

    x = _layers(cfg, body, x, params["decoder"], cfg.n_layers)
    return _norm(mesh, x, params["final_norm"])


def encdec_loss(params: dict, batch: dict, cfg: ArchConfig, mesh=None
                ) -> torch.Tensor:
    """Decoder CE loss: batch = {tokens, labels (b, s), audio_frames (b, F,
    d)}.  On a mesh, the mean over this process's rows."""
    mesh = spmd.context(mesh, cfg)
    enc = encode(params, batch["audio_frames"], cfg, mesh)
    x = _embed(params, batch["tokens"], cfg, mesh)
    h = _decoder_forward(params, x, enc, cfg, mesh)
    return chunked_loss(h, params["embed"], batch["labels"], cfg.loss_chunk,
                        mesh)


# -- prefill / decode ---------------------------------------------------------


def encdec_prefill(params: dict, batch: dict, cfg: ArchConfig, mesh=None):
    """Encode the audio and prefill the decoder tokens -> (last-position
    logits (b, vocab), cache).  The cache holds each decoder layer's self
    K/V and its cross K/V of the encoder states, in ``cfg.dtype``, stacked
    on a leading layer dim (the reference's scan ys).  On a mesh the
    logits are this process's vocab block and the K/V in the prefill
    cache's layout (``attention.PREFILL_KV_AXES``)."""
    mesh = spmd.context(mesh, cfg)
    enc = encode(params, batch["audio_frames"], cfg, mesh)
    x = _embed(params, batch["tokens"], cfg, mesh)
    positions = _positions(x)
    dt = torch_dtype(cfg.dtype)
    b = x.shape[0]

    def body(h, p):
        mix, (k, v) = _attn(cfg, p["attn"], _norm(mesh, h, p["ln1"]),
                            positions, causal=True, mesh=mesh)
        k, v = A.cache_rows(mesh, k, b), A.cache_rows(mesh, v, b)
        h = h + mix
        h = h + _cross(cfg, p["xattn"], _norm(mesh, h, p["ln_x"]), enc,
                       mesh=mesh)
        ck, cv = A.cross_kv(p["xattn"], enc, cfg.n_kv_heads, cfg.hd, mesh)
        h = h + mlp_apply(p["mlp"], _norm(mesh, h, p["ln2"]), mesh)
        return h, (A.KVCache(k.to(dt), v.to(dt)), ck.to(dt), cv.to(dt))

    x, (self_cache, cross_k, cross_v) = scan_loop(
        cfg.n_layers, body, x, xs=params["decoder"], stack_ys=True)
    x = _norm(mesh, x, params["final_norm"])
    logits = unembed(x[:, -1:], params["embed"], mesh)[:, 0]
    return logits, {"self": self_cache, "cross_k": cross_k,
                    "cross_v": cross_v}


def init_encdec_cache(cfg: ArchConfig, batch: int, seq_len: int,
                      n_frames: int, device) -> dict:
    """Zero caches: self K/V at context ``seq_len`` and cross K/V of
    ``n_frames`` encoder states, each (L, b, len, g, hd)."""
    dt = torch_dtype(cfg.dtype)
    L, g, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(n):
        return torch.zeros((L, batch, n, g, hd), dtype=dt, device=device)

    return {"self": A.KVCache(zeros(seq_len), zeros(seq_len)),
            "cross_k": zeros(n_frames), "cross_v": zeros(n_frames)}


def encdec_decode_step(params: dict, cache: dict, batch: dict, pos: int,
                       cfg: ArchConfig, mesh=None):
    """One new token against the cache: (logits (b, vocab), cache), the
    self caches updated in place.  On a mesh the cache is this process's
    block (``model.init_cache(mesh=)``) and the logits its vocab block."""
    mesh = spmd.context(mesh, cfg)
    x = _embed(params, batch["tokens"], cfg, mesh)

    def body(h, pc):
        p, sc, ck, cv = pc
        mix, new = A.decode_attention(p["attn"], _norm(mesh, h, p["ln1"]),
                                      sc, pos, n_heads=cfg.n_heads,
                                      n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                                      theta=cfg.rope_theta, mesh=mesh)
        _write_back(sc, new)
        h = h + mix
        h = h + _cross(cfg, p["xattn"], _norm(mesh, h, p["ln_x"]), None,
                       kv=(ck, cv), mesh=mesh)
        return h + mlp_apply(p["mlp"], _norm(mesh, h, p["ln2"]), mesh)

    x = scan_loop(cfg.n_layers, body, x,
                  xs=(params["decoder"], cache["self"], cache["cross_k"],
                      cache["cross_v"]))
    x = _norm(mesh, x, params["final_norm"])
    logits = unembed(x[:, 0:1], params["embed"], mesh)[:, 0]
    return logits, cache

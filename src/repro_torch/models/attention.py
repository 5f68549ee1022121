"""GQA attention: prefill self-attention, cross-attention and single-token
decode against a KV cache.

The port of ``src/repro/models/attention.py``.  Projection parameters are
stored flattened, as in the reference: wq (d, h·hd), wk/wv (d, g·hd), wo
(h·hd, d).  Long sequences (``s >= FLASH_MIN_SEQ``) take
``models/flash.py::flash_attention`` (the flash kernels: CUDA on the card,
their plain versions on the CPU, with a backward), which takes any length,
so nothing pads; short ones the direct ``_sdpa``, as in the reference.
Cross-attention (the encoder-decoder's decoder) takes the flash path
without a mask for a query of ``FLASH_MIN_SEQ`` tokens or more, with s and
t unequal.  Decode stays plain torch: ``_sdpa`` over the cache, which the
reference also computes outside any kernel.  The reference's sharding
constraints wait for the execution of sharded specs (ROADMAP, queue 1,
item 12).

Decode updates the cache **in place** (the reference's
``dynamic_update_slice`` returns a new buffer): one token's K/V is written
into its slot, so a step moves bytes in proportion to the token, not to the
cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import Param, rms_norm, rope

NEG_INF = -2.0 ** 30
FLASH_MIN_SEQ = 1024


def attn_params(d: int, n_heads: int, n_kv: int, head_dim: int,
                qk_norm: bool, dtype: str) -> dict:
    p = {
        "wq": Param((d, n_heads * head_dim), ("embed", "heads_flat"), dtype=dtype),
        "wk": Param((d, n_kv * head_dim), ("embed", "kv_flat"), dtype=dtype),
        "wv": Param((d, n_kv * head_dim), ("embed", "kv_flat"), dtype=dtype),
        "wo": Param((n_heads * head_dim, d), ("heads_flat", "embed"), dtype=dtype),
    }
    if qk_norm:
        p["q_norm"] = Param((head_dim,), ("head_dim",), scale=0.0, dtype="float32")
        p["k_norm"] = Param((head_dim,), ("head_dim",), scale=0.0, dtype="float32")
    return p


def _split_heads(y: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = y.shape
    return y.reshape(b, s, n, hd)


def _project_qkv(p, x, positions, theta, n_heads, n_kv, head_dim):
    q = _split_heads(x @ p["wq"], n_heads, head_dim)
    k = _split_heads(x @ p["wk"], n_kv, head_dim)
    v = _split_heads(x @ p["wv"], n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return rope(q, positions, theta), rope(k, positions, theta), v


def _merge_out(out: torch.Tensor, p: dict) -> torch.Tensor:
    b, s, h, hd = out.shape
    return out.reshape(b, s, h * hd) @ p["wo"]


def _sdpa(q, k, v, mask):
    """Grouped scaled-dot-product attention; q: (b,s,h,k), kv: (b,t,g,k)."""
    b, s, h, hd = q.shape
    g = k.shape[2]
    q = q.reshape(b, s, g, h // g, hd)
    scores = torch.einsum("bsgrk,btgk->bgrst", q, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(hd)))
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgrst,btgk->bsgrk", w, v)
    return out.reshape(b, s, h, hd)


def causal_mask(s: int, t: int, window: int | None = None, device=None):
    """(1,1,1,s,t) boolean mask; window => sliding-window causal."""
    i = torch.arange(s, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    m = j <= i
    if window is not None:
        m = m & (j > i - window)
    return m[None, None, None]


def attention(p, x, positions, *, n_heads: int, n_kv: int, head_dim: int,
              theta: float = 1e4, window: int | None = None,
              causal: bool = True):
    """Prefill self-attention; returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, positions, theta, n_heads, n_kv, head_dim)
    s = x.shape[1]
    if s >= FLASH_MIN_SEQ:
        out = flash_attention(q, k, v, causal=causal, window=window)
    else:
        mask = causal_mask(s, s, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask)
    return _merge_out(out, p), (k, v)


def cross_kv(p, kv_states, n_kv: int, head_dim: int):
    """Project encoder states to cross-attention K/V (cacheable)."""
    b, t, _ = kv_states.shape
    k = (kv_states @ p["wk"]).reshape(b, t, n_kv, head_dim)
    v = (kv_states @ p["wv"]).reshape(b, t, n_kv, head_dim)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    return k, v


def cross_attention(p, x, kv_states, *, n_heads: int, n_kv: int,
                    head_dim: int, kv=None):
    """x (b, s, d) attends to ``kv_states`` (b, t, d), unmasked.  ``kv``
    short-circuits with precomputed (k, v) (the decode-time cache)."""
    q = _split_heads(x @ p["wq"], n_heads, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    k, v = cross_kv(p, kv_states, n_kv, head_dim) if kv is None else kv
    if x.shape[1] >= FLASH_MIN_SEQ:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = _sdpa(q, k, v, None)
    return _merge_out(out, p)


# ---------------------------------------------------------------------------
# KV cache decode
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor          # (b, cache_len, g, hd)
    v: torch.Tensor


def init_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
               dtype: torch.dtype, device) -> KVCache:
    shape = (batch, cache_len, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(p, x, cache: KVCache, pos: int, *, n_heads: int,
                     n_kv: int, head_dim: int, theta: float = 1e4,
                     window: int | None = None):
    """One-token decode: x (b,1,d), pos the next position (an int).

    A sliding-window layer whose cache is at most ``window`` long is a ring
    buffer (slot = pos % window); otherwise the cache is absolute-indexed
    and positions beyond ``pos`` (and outside the window) are masked.
    Writes the token's K/V into ``cache`` in place and returns
    ``(out, cache)``."""
    b = x.shape[0]
    q = _split_heads(x @ p["wq"], n_heads, head_dim)
    k = _split_heads(x @ p["wk"], n_kv, head_dim)
    v = _split_heads(x @ p["wv"], n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    posv = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q = rope(q, posv, theta)
    k = rope(k, posv, theta)

    cache_len = cache.k.shape[1]
    ring = window is not None and cache_len <= window
    slot = pos % cache_len if ring else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)

    j = torch.arange(cache_len, device=x.device)
    if ring:
        valid = torch.ones_like(j, dtype=torch.bool) if pos + 1 >= cache_len \
            else j <= slot
    else:
        valid = j <= pos
        if window is not None:
            valid = valid & (j > pos - window)
    out = _sdpa(q, cache.k, cache.v, valid[None, None, None, None, :])
    return _merge_out(out, p), cache

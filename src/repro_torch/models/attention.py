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
reference also computes outside any kernel.

**On a mesh** (``mesh``: an :class:`~repro_torch.sharding.spmd.Spmd`
context) attention is tensor-parallel over heads, the reference's
``"heads"`` mode: the flattened projection columns are this process's
heads, so the projections come out as the local heads and ``wo`` is
row-parallel.  Where the kv heads do not divide the ``model`` axis the
rules leave K/V replicated: each process projects every kv head (the
prefill cache's layout) and attends with the groups of its own q heads.
The decode cache follows ``cache_specs``: its *sequence* is split over
``model`` (flash-decode), with every kv head on each process.  A decode
step gathers the step's q and new K/V row (small), the slot's owner writes
the row, each process attends over its own positions, the partial results
are combined from all-reduced maxima, sums and P·V, and the local heads go
through ``wo``.  A ring cache (``slot = pos % window``) keeps its slots
across the shards.

Decode updates the cache **in place** (the reference's
``dynamic_update_slice`` returns a new buffer): one token's K/V is written
into its slot, so a step moves bytes in proportion to the token, not to the
cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.flash import (
    _tp_size, check_heads_mode, flash_attention,
)
from repro_torch.models.layers import Param, rms_norm, rope
from repro_torch.sharding.spmd import kv_groups

NEG_INF = -2.0 ** 30
FLASH_MIN_SEQ = 1024


def tp_size(mesh) -> int:
    """Size of the tensor-parallel (``model``) mesh axis (1 off-mesh)."""
    return _tp_size(mesh)


def head_sharded(mesh, n_heads: int) -> bool:
    return n_heads % tp_size(mesh) == 0


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


def _merge_out(out: torch.Tensor, p: dict, mesh=None) -> torch.Tensor:
    b, s, h, hd = out.shape
    if mesh is None:
        return out.reshape(b, s, h * hd) @ p["wo"]
    d = mesh.cfg.d_model
    wo = mesh.unshard(p["wo"], (h * hd * mesh.tp, d), ("heads_flat", "embed"))
    return mesh.reduce(out.reshape(b, s, h * hd) @ wo)


def _tp_qkv(p, x, positions, theta, n_heads, n_kv, head_dim, mesh):
    """This process's q heads and K/V on a mesh: (q, k, v, sel).  ``sel`` is
    None where the kv heads split as the q heads (k/v are this process's
    kv heads), else the [lo, hi) of every kv head's k/v (all projected)
    that the local q heads read."""
    d = x.shape[-1]
    hl = n_heads // mesh.tp
    wq = mesh.unshard(p["wq"], (d, n_heads * head_dim),
                      ("embed", "heads_flat"))
    kshape, kaxes = (d, n_kv * head_dim), ("embed", "kv_flat")
    wk = mesh.unshard(p["wk"], kshape, kaxes)
    wv = mesh.unshard(p["wv"], kshape, kaxes)
    x = mesh.copy(x)
    q = _split_heads(x @ wq, hl, head_dim)
    sel = None
    if n_kv % mesh.tp:
        if mesh.split(kshape, kaxes, 1):
            wk, wv = mesh.gather(wk, 1), mesh.gather(wv, 1)
        sel = kv_groups(n_heads, n_kv, mesh.tp, mesh.r)
        g = n_kv
    else:
        g = n_kv // mesh.tp
    k = _split_heads(x @ wk, g, head_dim)
    v = _split_heads(x @ wv, g, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, mesh.copy(p["q_norm"]))
        k = rms_norm(k, mesh.copy(p["k_norm"]))
    return rope(q, positions, theta), rope(k, positions, theta), v, sel


def _pick(t: torch.Tensor, sel) -> torch.Tensor:
    return t if sel is None else t[:, :, sel[0]:sel[1]].contiguous()


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
              causal: bool = True, mesh=None):
    """Prefill self-attention; returns (out, (k, v)).  On a mesh, k/v are
    this process's kv heads (every kv head where the rules replicate
    them)."""
    if mesh is None:
        q, k, v = _project_qkv(p, x, positions, theta, n_heads, n_kv,
                               head_dim)
        qa, ka, va = q, k, v
    else:
        check_heads_mode(mesh, n_heads, x.shape[0])
        q, k, v, sel = _tp_qkv(p, x, positions, theta, n_heads, n_kv,
                               head_dim, mesh)
        qa, ka, va = q, _pick(k, sel), _pick(v, sel)
    s = x.shape[1]
    if s >= FLASH_MIN_SEQ:
        out = flash_attention(qa, ka, va, causal=causal, window=window)
    else:
        mask = causal_mask(s, s, window, x.device) if causal else None
        out = _sdpa(qa, ka, va, mask)
    return _merge_out(out, p, mesh), (k, v)


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


def cache_logical_axes() -> KVCache:
    ax = ("batch", "kv_seq", "kv_heads", "head_dim")
    return KVCache(ax, ax)


#: the logical axes of prefill's K/V (the reference's ``"heads"`` mode)
PREFILL_KV_AXES = ("batch", None, "kv_heads", "head_dim")


def decode_attention(p, x, cache: KVCache, pos: int, *, n_heads: int,
                     n_kv: int, head_dim: int, theta: float = 1e4,
                     window: int | None = None, mesh=None):
    """One-token decode: x (b,1,d), pos the next position (an int).

    A sliding-window layer whose cache is at most ``window`` long is a ring
    buffer (slot = pos % window); otherwise the cache is absolute-indexed
    and positions beyond ``pos`` (and outside the window) are masked.
    Writes the token's K/V into ``cache`` in place and returns
    ``(out, cache)``.  On a mesh ``cache`` is this process's block of the
    sequence (module docstring)."""
    if mesh is not None:
        return _decode_split(p, x, cache, pos, n_heads=n_heads, n_kv=n_kv,
                             head_dim=head_dim, theta=theta, window=window,
                             mesh=mesh)
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
    valid = _valid(j, pos, slot, cache_len, ring, window)
    out = _sdpa(q, cache.k, cache.v, valid[None, None, None, None, :])
    return _merge_out(out, p), cache


def _valid(j, pos: int, slot: int, cache_len: int, ring: bool, window):
    """Which cache positions ``j`` a decode step at ``pos`` reads."""
    if ring:
        return torch.ones_like(j, dtype=torch.bool) if pos + 1 >= cache_len \
            else j <= slot
    valid = j <= pos
    if window is not None:
        valid = valid & (j > pos - window)
    return valid


def _decode_split(p, x, cache: KVCache, pos: int, *, n_heads, n_kv,
                  head_dim, theta, window, mesh):
    """:func:`decode_attention` on a sequence-split cache (the module
    docstring's steps).  The cache holds positions [r·tl, (r+1)·tl) of
    every kv head, ``r`` this process's model position."""
    b = x.shape[0]
    tp, r = mesh.tp, mesh.r
    posv = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k, v, sel = _tp_qkv(p, x, posv, theta, n_heads, n_kv, head_dim, mesh)
    q = mesh.gather(q, 2)                              # (b, 1, h, hd)
    if sel is None:
        k, v = mesh.gather(k, 2), mesh.gather(v, 2)    # (b, 1, g, hd)
    tl = cache.k.shape[1]
    cache_len = tl * tp
    ring = window is not None and cache_len <= window
    slot = pos % cache_len if ring else pos
    owner, off = divmod(slot, tl)
    if owner == r:
        cache.k[:, off] = k[:, 0].to(cache.k.dtype)
        cache.v[:, off] = v[:, 0].to(cache.v.dtype)
    j = r * tl + torch.arange(tl, device=x.device)
    valid = _valid(j, pos, slot, cache_len, ring, window)
    g = n_kv
    qg = q.reshape(b, 1, g, n_heads // g, head_dim)
    scores = torch.einsum("bsgrk,btgk->bgrst", qg, cache.k).float()
    scores = scores / torch.sqrt(torch.tensor(float(head_dim)))
    scores = torch.where(valid[None, None, None, None, :], scores, NEG_INF)
    m = mesh.max(scores.amax(dim=-1, keepdim=True))
    e = torch.exp(scores - m)
    w = (e / mesh.reduce(e.sum(dim=-1, keepdim=True))).to(cache.v.dtype)
    out = torch.einsum("bgrst,btgk->bsgrk", w.float(), cache.v.float())
    out = mesh.reduce(out).to(cache.v.dtype).reshape(b, 1, n_heads, head_dim)
    hl = n_heads // tp
    return _merge_out(out[:, :, r * hl:(r + 1) * hl], p, mesh), cache

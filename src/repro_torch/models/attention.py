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
context) the projections are column-parallel (their flat columns split
over ``model``) and ``wo`` row-parallel, and attention runs in the
reference's mode (``flash.attn_mode`` of the global batch):

* ``"heads"`` (the heads divide the ``model`` axis): the column block is
  this process's heads.  Where the kv heads do not divide the axis the
  rules leave K/V replicated: each process projects every kv head (the
  prefill cache's layout) and attends with the groups of its own q heads,
  by an index map where they do not line up with them (24 q and 8 kv heads
  on 3: K/V expanded to one kv head a local q head, so the kernels run it
  as MHA).
* ``"batch"`` (else, where the global batch divides the whole mesh): the
  *flat* projection outputs move by an all-to-all from column blocks to
  blocks of batch rows (``batch_attn``: pod, data, then model), where a
  column block may end inside a head (the reference's ``_reshard_flat``):
  every head runs on this process's rows, and the output moves back to
  column blocks before ``wo``.
* ``"cp"`` (else): q's flat columns move to blocks of query positions
  (``attn_seq``) and K/V are gathered whole; attention runs the block
  against every key with its position offset (the flash kernels'
  ``q_offset``), and the output moves back.  A sequence the axis does not
  divide stays whole, as the reference's rules leave it: q is gathered
  too, and the output's column block is cut from it.

Where the flat columns do not split over ``model`` (3 heads of 18 columns
on 4), or the rows of a ``"batch"`` call do not divide it, the two modes
take their part whole (:func:`_modal_whole`): the q/k/v projections of
this process's rows (or its query positions, against every key) from whole
weights, every head, and the output assembled over ``model``.

Cross-attention runs the same modes without a mask, its K/V projected
from the encoder's or the vision states.
The decode caches follow ``cache_specs``: a self-attention cache's
*sequence* is split over ``model`` (flash-decode), with every kv head on
each process, and so is a cross cache whose length the axis divides (else
it is whole on each, and so is a self cache: the step writes its K/V row
on every process and attends with the local heads, :func:`_decode_whole`).
A split decode step gathers the step's q and new K/V row
(small; flat columns, so any head count), the slot's owner writes the
row, each process attends over its own positions, the partial results are
combined from all-reduced maxima, sums and P·V, and this process's column
block goes through ``wo``.  A ring cache (``slot = pos % window``) keeps
its slots across the shards.

Decode updates the cache **in place** (the reference's
``dynamic_update_slice`` returns a new buffer): one token's K/V is written
into its slot, so a step moves bytes in proportion to the token, not to the
cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.flash import _tp_size, attn_mode, flash_attention
from repro_torch.models.layers import Param, rms_norm, rope
from repro_torch.sharding.spmd import kv_groups, span

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
    return _wo(out.reshape(b, s, h * hd), p, mesh)


def _wo(y: torch.Tensor, p: dict, mesh) -> torch.Tensor:
    """The row-parallel out-projection of a flat column block (b, s, h·hd
    / tp), summed over ``model``."""
    d = mesh.cfg.d_model
    wo = mesh.unshard(p["wo"], (y.shape[-1] * mesh.tp, d),
                      ("heads_flat", "embed"))
    return mesh.reduce(y @ wo)


def _proj(mesh, w, shape, axes):
    """A projection weight with its FSDP splits gathered, and whether its
    columns split over ``model``; a weight they do not split goes through
    :meth:`~repro_torch.sharding.spmd.Spmd.copy` (each process uses a part
    of what it projects, so its gradient is summed over ``model``)."""
    w = mesh.unshard(w, shape, axes)
    split = bool(mesh.split(shape, axes, 1))
    return (w if split else mesh.copy(w)), split


def _kv_weights(p: dict, d: int, n_kv: int, head_dim: int, mesh):
    """(wk, wv) as :func:`_proj` gives them, and whether their columns
    split over ``model``."""
    kshape, kaxes = (d, n_kv * head_dim), ("embed", "kv_flat")
    wk, split = _proj(mesh, p["wk"], kshape, kaxes)
    return wk, _proj(mesh, p["wv"], kshape, kaxes)[0], split


def _weights(p: dict, d: int, n_heads: int, n_kv: int, head_dim: int, mesh):
    """(wq, wk, wv, whether the q columns split over ``model``, whether the
    kv columns do)."""
    wq, qsplit = _proj(mesh, p["wq"], (d, n_heads * head_dim),
                       ("embed", "heads_flat"))
    wk, wv, ksplit = _kv_weights(p, d, n_kv, head_dim, mesh)
    return wq, wk, wv, qsplit, ksplit


def _tp_qkv(p, x, positions, theta, n_heads, n_kv, head_dim, mesh,
            kv_x=None):
    """This process's q heads and K/V on a mesh in ``"heads"`` mode: (q, k,
    v, sel).  ``sel`` is None where the kv heads split as the q heads (k/v
    are this process's kv heads), else which of every kv head's k/v (all
    projected) the local q heads read (:func:`~repro_torch.sharding.spmd.
    kv_groups`: a block, or an index map, :func:`_pick`).  ``kv_x``: the
    states K/V
    are projected from (cross-attention: no rope), else ``x``."""
    hl = n_heads // mesh.tp
    wq, wk, wv, _, ksplit = _weights(p, x.shape[-1], n_heads, n_kv,
                                     head_dim, mesh)
    x = mesh.copy(x)
    kv_x = x if kv_x is None else mesh.copy(kv_x)
    q = _split_heads(x @ wq, hl, head_dim)
    sel = None
    if n_kv % mesh.tp:
        if ksplit:
            wk, wv = mesh.gather(wk, 1), mesh.gather(wv, 1)
        sel = kv_groups(n_heads, n_kv, mesh.tp, mesh.r)
        g = n_kv
    else:
        g = n_kv // mesh.tp
    k = _split_heads(kv_x @ wk, g, head_dim)
    v = _split_heads(kv_x @ wv, g, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, mesh.copy(p["q_norm"]))
        k = rms_norm(k, mesh.copy(p["k_norm"]))
    if positions is None:
        return q, k, v, sel
    return rope(q, positions, theta), rope(k, positions, theta), v, sel


def _mode(mesh, n_heads: int, rows: int) -> str:
    """The reference's attention mode of a call whose local batch has
    ``rows`` (``attn_mode`` of the global batch)."""
    return attn_mode(mesh.sizes, n_heads, mesh.global_batch(rows))


def _by_blocks(mesh, d: int, n_heads: int, head_dim: int, mode: str,
               rows: int) -> bool:
    """Whether a ``"batch"`` or ``"cp"`` call moves column blocks by
    all-to-all (:func:`_modal`): the flat q columns split over ``model``,
    and in ``"batch"`` mode the axis divides the rows; else
    :func:`_modal_whole`."""
    return bool(mesh.split((d, n_heads * head_dim), ("embed", "heads_flat"),
                           1)) and (mode == "cp" or rows % mesh.tp == 0)


def _rows_of(mesh, y: torch.Tensor) -> torch.Tensor:
    """This process's block of ``y``'s rows over ``model``."""
    n = y.shape[0] // mesh.tp
    return y[mesh.r * n:(mesh.r + 1) * n]


def _to_mode(mesh, y: torch.Tensor, mode: str, split: bool, seq_q: bool
             ) -> tuple[torch.Tensor, int]:
    """A flat projection output ``y`` (b, s, columns: this process's block
    where ``split``, else all) in the mode's layout, and the position of its
    first row: ``"batch"``, this process's rows with every column;
    ``"cp"``, with ``seq_q`` (a query whose length the axis divides) this
    process's positions with every column, else the whole."""
    if mode == "batch":
        return (mesh.a2a(y, 0, 2) if split else _rows_of(mesh, y)), 0
    s = y.shape[1]
    if seq_q and s % mesh.tp == 0:
        n = s // mesh.tp
        if split:
            return mesh.a2a(y, 1, 2), mesh.r * n
        return y[:, mesh.r * n:(mesh.r + 1) * n], mesh.r * n
    return (mesh.gather(y, 2) if split else y), 0


def _from_mode(mesh, y: torch.Tensor, mode: str, s: int) -> torch.Tensor:
    """Attention's flat output (:func:`_to_mode`'s layout of q, every
    column) back to this process's column block (b, s, h·hd / tp)."""
    if mode == "batch":
        return mesh.a2a(y, 2, 0)
    if y.shape[1] != s:
        return mesh.a2a(y, 2, 1)
    n = y.shape[-1] // mesh.tp
    return y[..., mesh.r * n:(mesh.r + 1) * n]


def _modal(p, x, kv_x, positions, theta, n_heads, n_kv, head_dim, mesh,
           mode):
    """q, k, v (every head) in the ``"batch"`` or ``"cp"`` layout, and q's
    position offset.  ``kv_x`` None: self-attention (rope on q and k),
    else the states of a cross-attention (no rope)."""
    wq, wk, wv, _, ksplit = _weights(p, x.shape[-1], n_heads, n_kv,
                                     head_dim, mesh)
    x = mesh.copy(x)
    src = x if kv_x is None else mesh.copy(kv_x)
    qf, off = _to_mode(mesh, x @ wq, mode, True, seq_q=True)
    kf, _ = _to_mode(mesh, src @ wk, mode, ksplit, seq_q=False)
    vf, _ = _to_mode(mesh, src @ wv, mode, ksplit, seq_q=False)
    q = _split_heads(qf, n_heads, head_dim)
    k = _split_heads(kf, n_kv, head_dim)
    v = _split_heads(vf, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, mesh.copy(p["q_norm"]))
    if "k_norm" in p:
        k = rms_norm(k, mesh.copy(p["k_norm"]))
    if kv_x is None:
        if mode == "batch":
            qpos = kpos = _rows_of(mesh, positions)
        else:
            qpos, kpos = positions[:, off:off + q.shape[1]], positions
        q, k = rope(q, qpos, theta), rope(k, kpos, theta)
    return q, k, v, off


def _modal_whole(p, x, kv_x, positions, theta, n_heads, n_kv, head_dim,
                 mesh, mode, causal, window):
    """Attention in the ``"batch"`` or ``"cp"`` mode where the column blocks
    do not move (:func:`_by_blocks`): this process's part (its
    :func:`~repro_torch.sharding.spmd.span` of the rows, or of the query
    positions against every key) projected with every head from whole
    weights (``Spmd.whole``), attended, and through ``wo``: the output
    assembled over ``model`` and cut to this process's column block where
    ``wo``'s rows split, else this part's rows of the output, assembled.
    Returns (out, (k, v)): k/v of this process's rows in ``"batch"`` mode,
    every row in ``"cp"`` mode."""
    b, s, d = x.shape
    dim = 0 if mode == "batch" else 1
    n = x.shape[dim]
    lo, hi = span(n, mesh.tp, mesh.r)
    qshape, kshape = (d, n_heads * head_dim), (d, n_kv * head_dim)
    wq = mesh.whole(p["wq"], qshape, ("embed", "heads_flat"))
    wk = mesh.whole(p["wk"], kshape, ("embed", "kv_flat"))
    wv = mesh.whole(p["wv"], kshape, ("embed", "kv_flat"))
    x = mesh.copy(x)
    src = x if kv_x is None else mesh.copy(kv_x)
    if mode == "batch":
        src = src[lo:hi]
    q = _split_heads(x.narrow(dim, lo, hi - lo) @ wq, n_heads, head_dim)
    k = _split_heads(src @ wk, n_kv, head_dim)
    v = _split_heads(src @ wv, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, mesh.copy(p["q_norm"]))
    if "k_norm" in p:
        k = rms_norm(k, mesh.copy(p["k_norm"]))
    off = lo if mode == "cp" else 0
    if kv_x is None:
        kpos = positions[lo:hi] if mode == "batch" else positions
        q, k = rope(q, kpos[:, off:off + q.shape[1]], theta), \
            rope(k, kpos, theta)
    out = _attend(q, k, v, s, causal, window, off)
    y = out.reshape(out.shape[0], out.shape[1], n_heads * head_dim)
    oshape, oaxes = (n_heads * head_dim, d), ("heads_flat", "embed")
    if mesh.split(oshape, oaxes, 0):
        c = n_heads * head_dim // mesh.tp
        y = mesh.assemble(y, dim, n, lo)[..., mesh.r * c:(mesh.r + 1) * c]
        return _wo(y, p, mesh), (k, v)
    wo = mesh.whole(p["wo"], oshape, oaxes)
    return mesh.assemble(y @ wo, dim, n, lo, both=False), (k, v)


def _pick(t: torch.Tensor, sel) -> torch.Tensor:
    """The kv heads a process's q heads read (``sel``: :func:`~repro_torch.
    sharding.spmd.kv_groups`' answer, None for all): a block, or by the
    index map one kv head a local q head."""
    if sel is None:
        return t
    lo, hi, idx = sel
    if idx is None:
        return t[:, :, lo:hi].contiguous()
    return t[:, :, [lo + i for i in idx]]


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


def causal_mask(s: int, t: int, window: int | None = None, device=None,
                q_offset: int = 0):
    """(1,1,1,s,t) boolean mask; window => sliding-window causal.  Row i is
    position ``q_offset + i``."""
    i = torch.arange(s, device=device)[:, None]
    if q_offset:
        i = i + q_offset
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
    them) in ``"heads"`` mode, this process's rows in ``"batch"`` mode and
    the whole in ``"cp"`` mode (:func:`cache_rows` gives the prefill
    cache's layout of each)."""
    s = x.shape[1]
    if mesh is None:
        q, k, v = _project_qkv(p, x, positions, theta, n_heads, n_kv,
                               head_dim)
        out = _attend(q, k, v, s, causal, window, 0)
        return _merge_out(out, p), (k, v)
    mode = _mode(mesh, n_heads, x.shape[0])
    if mode == "heads":
        q, k, v, sel = _tp_qkv(p, x, positions, theta, n_heads, n_kv,
                               head_dim, mesh)
        out = _attend(q, _pick(k, sel), _pick(v, sel), s, causal, window, 0)
        return _merge_out(out, p, mesh), (k, v)
    if not _by_blocks(mesh, x.shape[-1], n_heads, head_dim, mode,
                      x.shape[0]):
        return _modal_whole(p, x, None, positions, theta, n_heads, n_kv,
                            head_dim, mesh, mode, causal, window)
    q, k, v, off = _modal(p, x, None, positions, theta, n_heads, n_kv,
                          head_dim, mesh, mode)
    out = _attend(q, k, v, s, causal, window, off)
    b, sq = out.shape[:2]
    y = _from_mode(mesh, out.reshape(b, sq, n_heads * head_dim), mode, s)
    return _wo(y, p, mesh), (k, v)


def _attend(q, k, v, s: int, causal: bool, window, q_offset: int):
    """Attention of q (its first row at position ``q_offset``) to k/v:
    flash for a sequence ``s`` of ``FLASH_MIN_SEQ`` or more, as the
    reference decides on the whole sequence, else the direct ``_sdpa``."""
    if s >= FLASH_MIN_SEQ:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    mask = causal_mask(q.shape[1], k.shape[1], window, q.device,
                       q_offset) if causal else None
    return _sdpa(q, k, v, mask)


def cache_rows(mesh, k: torch.Tensor, rows: int) -> torch.Tensor:
    """Prefill's K or V of a layer in the prefill cache's layout
    (``PREFILL_KV_AXES``: this process's batch rows): ``"batch"`` mode's
    block of rows gathered over ``model`` (its span, where the axis does
    not divide the rows)."""
    if mesh is None or k.shape[0] == rows:
        return k
    if k.shape[0] * mesh.tp == rows:
        return mesh.all_gather(k, 0)
    return mesh.assemble(k.detach(), 0, rows,
                         span(rows, mesh.tp, mesh.r)[0], both=False)


def cross_kv(p, kv_states, n_kv: int, head_dim: int, mesh=None):
    """Project encoder states to cross-attention K/V (cacheable).  On a
    mesh, this process's kv heads where they split over ``model``, else
    every kv head (``PREFILL_KV_AXES``)."""
    b, t, _ = kv_states.shape
    if mesh is None:
        wk, wv = p["wk"], p["wv"]
        g = n_kv
    else:
        wk, wv, ksplit = _kv_weights(p, kv_states.shape[-1], n_kv, head_dim,
                                     mesh)
        kv_states = mesh.copy(kv_states)
        if ksplit and n_kv % mesh.tp:
            wk, wv = mesh.gather(wk, 1), mesh.gather(wv, 1)
        g = n_kv // mesh.tp if ksplit and n_kv % mesh.tp == 0 else n_kv
        if "k_norm" in p:
            p = dict(p, k_norm=mesh.copy(p["k_norm"]))
    k = (kv_states @ wk).reshape(b, t, g, head_dim)
    v = (kv_states @ wv).reshape(b, t, g, head_dim)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"])
    return k, v


def cross_attention(p, x, kv_states, *, n_heads: int, n_kv: int,
                    head_dim: int, kv=None, mesh=None):
    """x (b, s, d) attends to ``kv_states`` (b, t, d), unmasked.  ``kv``
    short-circuits with precomputed (k, v) (the decode-time cache); on a
    mesh that is this process's block of the cross cache."""
    s = x.shape[1]
    if mesh is None:
        q = _split_heads(x @ p["wq"], n_heads, head_dim)
        if "q_norm" in p:
            q = rms_norm(q, p["q_norm"])
        k, v = cross_kv(p, kv_states, n_kv, head_dim) if kv is None else kv
        return _merge_out(_attend(q, k, v, s, False, None, 0), p)
    if kv is not None:
        return _cross_cached(p, x, kv, n_heads=n_heads, n_kv=n_kv,
                             head_dim=head_dim, mesh=mesh)
    mode = _mode(mesh, n_heads, x.shape[0])
    if mode == "heads":
        q, k, v, sel = _tp_qkv(p, x, None, 0.0, n_heads, n_kv, head_dim,
                               mesh, kv_x=kv_states)
        out = _attend(q, _pick(k, sel), _pick(v, sel), s, False, None, 0)
        return _merge_out(out, p, mesh)
    if not _by_blocks(mesh, x.shape[-1], n_heads, head_dim, mode,
                      x.shape[0]):
        return _modal_whole(p, x, kv_states, None, 0.0, n_heads, n_kv,
                            head_dim, mesh, mode, False, None)[0]
    q, k, v, _ = _modal(p, x, kv_states, None, 0.0, n_heads, n_kv,
                        head_dim, mesh, mode)
    out = _attend(q, k, v, s, False, None, 0)
    b, sq = out.shape[:2]
    y = _from_mode(mesh, out.reshape(b, sq, n_heads * head_dim), mode, s)
    return _wo(y, p, mesh)


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
        fn = _decode_split if _seq_split(mesh, cache.k, "self") \
            else _decode_whole
        return fn(p, x, cache, pos, n_heads=n_heads, n_kv=n_kv,
                  head_dim=head_dim, theta=theta, window=window, mesh=mesh)
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


def _whole_heads(mesh, y: torch.Tensor, n: int, head_dim: int,
                 split: bool) -> torch.Tensor:
    """A flat projection output (this process's column block where
    ``split``) as every head (b, s, n, hd)."""
    return _split_heads(mesh.gather(y, 2) if split else y, n, head_dim)


def mark_kv_len(buf: torch.Tensor, n: int) -> None:
    """Record on a decode cache buffer (this process's block of it on a
    mesh) ``n``, its sequence's global length.  The mark lives on the
    buffer's storage, so every view of it (a layer's slot of the stacked
    buffers) reads it, and it goes with the buffer: two caches of one
    local length, one whole and one this process's block of a longer one,
    keep their own layouts."""
    buf.untyped_storage().kv_len = n


def _seq_split(mesh, buf: torch.Tensor, kind: str) -> bool:
    """Whether a decode cache buffer (b, t, ...) (``kind``: ``"self"`` or
    ``"cross"``) is this process's block of a sequence split over
    ``model`` (its global length t times the axis), else whole (t): by the
    length :func:`mark_kv_len` recorded (``model.init_cache(mesh=)``)."""
    if mesh.tp == 1:
        return False
    t = buf.shape[1]
    n = getattr(buf.untyped_storage(), "kv_len", None)
    if n is None:
        raise ValueError(f"a {kind} decode cache on a mesh of model "
                         f"{mesh.tp} without its global length: lay it out "
                         "with model.init_cache(mesh=)")
    if n not in (t, t * mesh.tp):
        raise ValueError(f"a {kind} cache of {t} positions a process, not "
                         f"{n} or {n} / {mesh.tp}")
    return n != t


def _out(mesh, out: torch.Tensor, p: dict) -> torch.Tensor:
    """Every head's output (b, s, h, hd), the same on every process, through
    ``wo``: this process's flat column block through its rows, summed over
    ``model``, where they split; else the whole product on each."""
    b, s, h, hd = out.shape
    shape, axes = (h * hd, mesh.cfg.d_model), ("heads_flat", "embed")
    if not mesh.split(shape, axes, 0):
        return out.reshape(b, s, h * hd) @ mesh.unshard(p["wo"], shape, axes)
    n = h * hd // mesh.tp
    return _wo(out.reshape(b, s, h * hd)[..., mesh.r * n:(mesh.r + 1) * n],
               p, mesh)


def _combine(mesh, q, k, v, valid, n_heads: int, head_dim: int):
    """Softmax attention of q (b, 1, h, hd) over this process's block of a
    sequence-split k/v, ``valid`` its positions' mask (or None), from the
    all-reduced maximum, sum and P·V: (b, 1, h, hd) in v's dtype."""
    b, g = q.shape[0], k.shape[2]
    qg = q.reshape(b, 1, g, n_heads // g, head_dim)
    scores = torch.einsum("bsgrk,btgk->bgrst", qg, k).float()
    scores = scores / torch.sqrt(torch.tensor(float(head_dim)))
    if valid is not None:
        scores = torch.where(valid[None, None, None, None, :], scores,
                             NEG_INF)
    m = mesh.max(scores.amax(dim=-1, keepdim=True))
    e = torch.exp(scores - m)
    w = (e / mesh.reduce(e.sum(dim=-1, keepdim=True))).to(v.dtype)
    out = torch.einsum("bgrst,btgk->bsgrk", w.float(), v.float())
    return mesh.reduce(out).to(v.dtype).reshape(b, 1, n_heads, head_dim)


def _decode_split(p, x, cache: KVCache, pos: int, *, n_heads, n_kv,
                  head_dim, theta, window, mesh):
    """:func:`decode_attention` on a sequence-split cache (the module
    docstring's steps), in any attention mode.  The cache holds positions
    [r·tl, (r+1)·tl) of every kv head, ``r`` this process's model
    position."""
    b = x.shape[0]
    tp, r = mesh.tp, mesh.r
    wq, wk, wv, qsplit, ksplit = _weights(p, x.shape[-1], n_heads, n_kv,
                                          head_dim, mesh)
    q = _whole_heads(mesh, x @ wq, n_heads, head_dim, qsplit)
    k = _whole_heads(mesh, x @ wk, n_kv, head_dim, ksplit)
    v = _whole_heads(mesh, x @ wv, n_kv, head_dim, ksplit)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    posv = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k = rope(q, posv, theta), rope(k, posv, theta)
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
    out = _combine(mesh, q, cache.k, cache.v, valid, n_heads, head_dim)
    return _out(mesh, out, p), cache


def _decode_whole(p, x, cache: KVCache, pos: int, *, n_heads, n_kv,
                  head_dim, theta, window, mesh):
    """:func:`decode_attention` on a cache every process holds whole (its
    length the ``model`` axis does not divide): the step's K/V row, every
    kv head, written on each process, then attention over the cache with
    this process's q heads, through its rows of ``wo``; every head where
    the axis does not divide them.  The local q heads read their kv heads
    in place: they take their own slots among the q heads of the kv heads
    they span (:func:`~repro_torch.sharding.spmd.kv_groups`' [lo, hi)),
    the other slots zero and their outputs dropped, so GQA runs over a
    view of the cache where an index map would copy all of it a step."""
    b = x.shape[0]
    wq, wk, wv, qsplit, ksplit = _weights(p, x.shape[-1], n_heads, n_kv,
                                          head_dim, mesh)
    local = qsplit and n_heads % mesh.tp == 0
    q = _split_heads(x @ wq, n_heads // mesh.tp, head_dim) if local else \
        _whole_heads(mesh, x @ wq, n_heads, head_dim, qsplit)
    k = _whole_heads(mesh, x @ wk, n_kv, head_dim, ksplit)
    v = _whole_heads(mesh, x @ wv, n_kv, head_dim, ksplit)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    posv = torch.full((b, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k = rope(q, posv, theta), rope(k, posv, theta)
    cache_len = cache.k.shape[1]
    ring = window is not None and cache_len <= window
    slot = pos % cache_len if ring else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    j = torch.arange(cache_len, device=x.device)
    mask = _valid(j, pos, slot, cache_len, ring, window)[None, None, None,
                                                          None, :]
    if not local:
        return _out(mesh, _sdpa(q, cache.k, cache.v, mask), p), cache
    lo, hi, _ = kv_groups(n_heads, n_kv, mesh.tp, mesh.r)
    rep, hl = n_heads // n_kv, n_heads // mesh.tp
    off = mesh.r * hl - lo * rep
    qg = q.new_zeros(b, 1, (hi - lo) * rep, head_dim)
    qg[:, :, off:off + hl] = q
    out = _sdpa(qg, cache.k[:, :, lo:hi], cache.v[:, :, lo:hi], mask)
    return _merge_out(out[:, :, off:off + hl], p, mesh), cache


def _cross_cached(p, x, kv, *, n_heads, n_kv, head_dim, mesh):
    """Cross-attention decode on a mesh against this process's block of
    the cross cache: split over ``model``, the partial results combined as
    a self decode's; else whole, attended on every process.  Every head,
    then this process's column block through ``wo``."""
    ck, cv = kv
    wq, qsplit = _proj(mesh, p["wq"], (x.shape[-1], n_heads * head_dim),
                       ("embed", "heads_flat"))
    q = _whole_heads(mesh, x @ wq, n_heads, head_dim, qsplit)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
    if _seq_split(mesh, ck, "cross"):
        out = _combine(mesh, q, ck, cv, None, n_heads, head_dim)
    else:
        out = _sdpa(q, ck, cv, None)
    return _out(mesh, out, p)

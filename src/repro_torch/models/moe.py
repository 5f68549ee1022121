"""Mixture-of-Experts block: top-k routing, capacity-bounded dispatch per
data shard, batched expert SwiGLU.

The port of ``src/repro/models/moe.py`` (``moe_params``, ``moe_apply``)
in the reference's ``(n_sh, tl, d)`` layout: without a mesh one data
shard (``n_sh = 1``); on a mesh (an :class:`~repro_torch.sharding.spmd.
Spmd` context) the reference's ``_data_shards`` of the global batch (pod x
data, halved until it divides it), of which this process's rows hold
``n_sh / (the batch's blocks)``.  Each shard routes its own tokens with
its own capacity, as the reference's per-shard dispatch does; only the
aux loss's means ``me`` and ``ce`` span every shard, their sums
all-reduced over the axes that split the rows both ways
(``Spmd.reduce_partial``: the data-parallel mean of the gradients then
gives each process's rows the reference's aux gradient, not 1/n of it).
Where the shards do not deal evenly over the batch's blocks (a shard
across processes: 4 rows in one shard on ``pod`` 2 × ``data`` 3, whose 6
halve to 1), each process gathers the batch's rows (``Spmd.gather`` over
the axes that split them) and runs every shard, then keeps its rows: the
aux loss is then whole on each process, and the gather's reduce-scatter
with the data-parallel mean again gives the reference's gradients.
The router is replicated over ``model``, so every process of a ``model``
group routes the same tokens the same way.  Where the experts split over
``model`` (DeepSeek's 64, Jamba's 16) a process dispatches to its own
experts' slots only, and where each expert's FFN splits (Mixtral's
``("expert_ffn", "model")`` override) it runs its columns of every
expert; either way its output is a partial sum, which is all-reduced over
``model`` once, with the shared experts' row-parallel output.  The
partial region's inputs (the tokens and the gates) go through
``Spmd.copy``, so their gradients are summed over ``model``; the router's
own product stays whole on every process.
It computes what the reference computes, with three points where a
literal translation of the jnp would not:

* **Top-k order on ties.** ``jax.lax.top_k`` puts the lower index first
  among equal values; ``torch.topk`` does not promise an order.  The port
  takes a stable descending sort and its first k (:func:`top_k`).  Ties
  are common: the router product is in the activation dtype (bf16).
* **Stable sort of the picks.** ``jnp.argsort`` is stable, so the picks
  of one expert keep token order and the first ``cap`` of them are kept.
  A pick's position among its expert's is its sorted index less the
  expert's first index (the reference's cumulative sum of the one-hot
  gives the same integers, at a cost on the card: :func:`route`).
* **The capacity drop empties the last kept slot.** The reference writes
  every dropped pick to its expert's slot ``cap - 1`` (token 0, not ok),
  with ``.at[].set`` on duplicate indices; XLA applies the updates in
  order, so a dropped pick (they sort after the kept ones) overwrites the
  kept pick at position ``cap - 1``.  An over-full expert thus serves
  ``cap - 1`` tokens, and the pick that sat in its last slot keeps its
  gate but gathers the expert's output of a zero row (0).  A scatter with
  duplicate indices has no defined order in PyTorch, so the port writes
  the kept picks to their own (distinct) slots and then states the
  clobber: slot ``cap - 1`` of every expert with more than ``cap`` picks
  is emptied.  No write here depends on the order of duplicate indices.
  The dispatch table is built whole on every process, so an emptied slot
  is empty for whichever process owns that expert.

Nothing has a data-dependent shape and nothing syncs with the host, so the
cost walker runs it on meta tensors and a decode step stays asynchronous.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Param


def moe_params(d: int, n_experts: int, d_ff_e: int, n_shared: int,
               d_ff_shared: int, dtype: str) -> dict:
    p = {
        "router": Param((d, n_experts), ("embed", None), dtype="float32"),
        "wi": Param((n_experts, d, d_ff_e), ("experts", "embed", "expert_ffn"), dtype=dtype),
        "wg": Param((n_experts, d, d_ff_e), ("experts", "embed", "expert_ffn"), dtype=dtype),
        "wo": Param((n_experts, d_ff_e, d), ("experts", "expert_ffn", "embed"), dtype=dtype),
    }
    if n_shared:
        p["shared"] = {
            "wi": Param((d, d_ff_shared * n_shared), ("embed", "ffn"), dtype=dtype),
            "wg": Param((d, d_ff_shared * n_shared), ("embed", "ffn"), dtype=dtype),
            "wo": Param((d_ff_shared * n_shared, d), ("ffn", "embed"), dtype=dtype),
        }
    return p


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, the lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: the reference's ``max(1, round(...))`` (Python's
    round, half to even)."""
    return int(max(1, round(tokens * top_k / n_experts * capacity_factor)))


def route(p: dict, xf: torch.Tensor, k: int, capacity_factor: float,
          mean=None):
    """The routing of ``moe_apply`` on ``xf`` (n_sh, tl, d): a dict with the
    gates, the picks, the aux loss, ``cap``, the dispatch (``tok``, ``ok``:
    (n_sh, e·cap)), the inverse map (``inv_slot``, ``inv_ok``: (n_sh,
    tl·k), in the picks' original order) and ``emptied`` (n_sh, e·cap):
    the last slots of the over-full experts, which the clobber empties.
    ``mean(t)``: the aux loss's mean of (n_sh, tl, e) over its first two
    dims (on a mesh, over every process's shards too)."""
    n_sh, tl, _ = xf.shape
    e = p["router"].shape[-1]
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                  # (n_sh, tl, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # Switch-style aux loss (global means)
    if mean is None:
        mean = lambda t: t.mean(dim=(0, 1))  # noqa: E731
    me = mean(probs)
    ce = mean(F.one_hot(expert_idx[..., 0], e).float())
    aux = e * (me * ce).sum()

    cap = capacity(tl, k, e, capacity_factor)
    tk = tl * k
    flat_e = expert_idx.reshape(n_sh, tk)
    flat_g = gate_vals.reshape(n_sh, tk)
    flat_tok = torch.arange(tl, device=xf.device).repeat_interleave(k)
    flat_tok = flat_tok[None].expand(n_sh, tk)

    order = torch.argsort(flat_e, dim=-1, stable=True)      # per-shard sort
    se = torch.gather(flat_e, 1, order)
    stok = torch.gather(flat_tok, 1, order)

    # each pick's position among its expert's picks.  The reference takes
    # the cumulative sum of the one-hot (n_sh, tk, e) along the picks;
    # on the card PyTorch scans that outer dim at 13 ms a layer at
    # DeepSeek's prefill.  The picks are sorted by expert, so the position
    # is the pick's index less its expert's first index: the same integers
    counts = F.one_hot(se, e).sum(dim=1)                     # (n_sh, e)
    first = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(tk, device=xf.device) - torch.gather(first, 1, se)
    keep = pos < cap
    slot = se * cap + torch.where(keep, pos, cap - 1)

    # kept picks to their slots (distinct); every dropped pick to one spare
    # slot past the end, all with the same values, then cut off
    dst = torch.where(keep, slot, e * cap)
    tok = torch.zeros((n_sh, e * cap + 1), dtype=torch.int64,
                      device=xf.device).scatter(1, dst, torch.where(
                          keep, stok, 0))[:, :e * cap]
    ok = torch.zeros((n_sh, e * cap + 1), dtype=torch.bool,
                     device=xf.device).scatter(1, dst, keep)[:, :e * cap]
    # the reference's clobber: a dropped pick lands in slot cap - 1 of its
    # expert last, so an over-full expert's last slot ends empty
    full = counts > cap                                      # (n_sh, e)
    last = torch.arange(cap, device=xf.device) == cap - 1
    emptied = (full[..., None] & last).reshape(n_sh, e * cap)
    tok = torch.where(emptied, 0, tok)
    ok = ok & ~emptied

    # inverse map, in the picks' original order (order is a permutation)
    inv_slot = torch.zeros_like(slot).scatter(1, order, slot)
    inv_ok = torch.zeros_like(keep).scatter(1, order, keep)
    return {"gates": flat_g, "experts": flat_e, "aux": aux, "cap": cap,
            "tok": tok, "ok": ok, "inv_slot": inv_slot, "inv_ok": inv_ok,
            "emptied": emptied}


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(table (n, r, d), idx (n, m)[..., None], axis=1)``
    as one ``F.embedding`` over the flattened rows, whose backward sums
    each row's gradients in index order (an ``index_put_`` or
    ``scatter_add`` backward adds in no fixed order on the card)."""
    n, r, d = table.shape
    off = torch.arange(n, device=idx.device)[:, None] * r
    return F.embedding(idx + off, table.reshape(n * r, d))


def moe_apply(p: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, mesh=None):
    """x: (b, s, d) -> (y: (b, s, d), aux load-balance loss).  On a mesh,
    ``x`` is this process's rows (module docstring)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    if mesh is not None and mesh.data_shards(mesh.global_batch(b)) % \
            mesh.row_blocks():
        axes = mesh.batch_axes()
        i, _ = mesh.block(axes)
        with mesh.rows(()):
            y, aux = moe_apply(p, mesh.gather(x, 0, axes), top_k,
                               capacity_factor, mesh)
        return y[i * b:(i + 1) * b], aux
    if mesh is None:
        n_sh, mean = 1, None
        router = p["router"]
    else:
        n_sh, mean = _shards(mesh, b, s)
        router = mesh.unshard(p["router"], (d, e), ("embed", None))
    tl = b * s // n_sh
    xf = x.reshape(n_sh, tl, d)
    r = route(dict(p, router=router), xf, top_k, capacity_factor, mean)
    cap = r["cap"]
    f = p["wi"].shape[-1] if mesh is None else mesh.cfg.d_ff_expert
    wi, wg, wo, lo, el = _experts(p, mesh, e, d, f)
    partial = mesh is not None and (el < e or wi.shape[-1] < f)
    xin = mesh.copy(xf) if partial else xf
    gates = mesh.copy(r["gates"]) if partial else r["gates"]

    # gather tokens to (n_sh, el, cap, d) slots of this process's experts
    tok, slot_ok = r["tok"], r["ok"]
    if el < e:
        tok = tok[:, lo * cap:(lo + el) * cap]
        slot_ok = slot_ok[:, lo * cap:(lo + el) * cap]
    xe = _rows(xin, tok)
    xe = xe * slot_ok[..., None].to(xe.dtype)
    xe = xe.reshape(n_sh, el, cap, d)

    # expert SwiGLU, batched over (expert, slot)
    hg = torch.einsum("xecd,edf->xecf", xe, wg)
    hi = torch.einsum("xecd,edf->xecf", xe, wi)
    h = F.silu(hg) * hi
    ye = torch.einsum("xecf,efd->xecd", h, wo)

    # combine: gather each token's top-k slots and weight them by the gate
    # (on a mesh, the picks that landed on this process's experts)
    yflat = ye.reshape(n_sh, el * cap, d).to(x.dtype)
    inv, ok = r["inv_slot"], r["inv_ok"]
    if el < e:
        inv = inv - lo * cap
        here = (inv >= 0) & (inv < el * cap)
        inv, ok = torch.where(here, inv, 0), ok & here
    picked = _rows(yflat, inv)
    w = (gates * ok).to(x.dtype)                             # (n_sh, tl·k)
    y = (picked * w[..., None]).reshape(n_sh, tl, top_k, d).sum(dim=2)

    if "shared" in p:           # one reduce for both partial sums
        ys, s_partial = _shared(p["shared"], xf, mesh)
        if s_partial and not partial:
            ys = mesh.reduce(ys)
        elif partial and not s_partial:
            y, partial = mesh.reduce(y), False
        y = y + ys.to(y.dtype)
    if partial:
        y = mesh.reduce(y)
    return y.reshape(b, s, d), r["aux"]


def _shards(mesh, b: int, s: int):
    """(this process's data shards, the aux loss's mean) on a mesh: the
    reference's ``_data_shards`` of the global batch, dealt evenly over
    the batch's blocks, and the means' sums all-reduced over the axes that
    split the rows."""
    blocks = mesh.row_blocks()
    n_all = mesh.data_shards(mesh.global_batch(b))
    axes = mesh.batch_axes()
    total = n_all * (b * s // (n_all // blocks))

    def mean(t):
        return mesh.reduce_partial(t.sum(dim=(0, 1)), axes) / total

    return n_all // blocks, mean


def _experts(p: dict, mesh, e: int, d: int, f: int):
    """The expert weights this process runs (FSDP splits gathered), the
    first expert's index and their number."""
    if mesh is None:
        return p["wi"], p["wg"], p["wo"], 0, e
    axes_in = ("experts", "embed", "expert_ffn")
    wi = mesh.unshard(p["wi"], (e, d, f), axes_in)
    wg = mesh.unshard(p["wg"], (e, d, f), axes_in)
    wo = mesh.unshard(p["wo"], (e, f, d), ("experts", "expert_ffn", "embed"))
    el = wi.shape[0]
    return wi, wg, wo, (mesh.r * el if el < e else 0), el


def _shared(sp: dict, xf: torch.Tensor, mesh):
    """The shared experts' output, and whether it is a partial sum over
    ``model`` (their FFN columns split, Megatron's column/row parallel)."""
    if mesh is None:
        hs = F.silu(xf @ sp["wg"]) * (xf @ sp["wi"])
        return hs @ sp["wo"], False
    d, ff = xf.shape[-1], mesh.cfg.d_ff_expert * mesh.cfg.n_shared_experts
    wi = mesh.unshard(sp["wi"], (d, ff), ("embed", "ffn"))
    wg = mesh.unshard(sp["wg"], (d, ff), ("embed", "ffn"))
    wo = mesh.unshard(sp["wo"], (ff, d), ("ffn", "embed"))
    partial = wi.shape[1] < ff
    x = mesh.copy(xf) if partial else xf
    return (F.silu(x @ wg) * (x @ wi)) @ wo, partial

"""Mixture-of-Experts block: top-k routing, capacity-bounded dispatch per
data shard, batched expert SwiGLU.

The port of ``src/repro/models/moe.py`` (``moe_params``, ``moe_apply``)
without a mesh: one data shard (``n_sh = 1``), in the reference's
``(n_sh, tl, d)`` layout, so expert routing across a data mesh (ROADMAP,
queue 1, item 12) can add shards.
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


def route(p: dict, xf: torch.Tensor, k: int, capacity_factor: float):
    """The routing of ``moe_apply`` on ``xf`` (n_sh, tl, d): a dict with the
    gates, the picks, the aux loss, ``cap``, the dispatch (``tok``, ``ok``:
    (n_sh, e·cap)), the inverse map (``inv_slot``, ``inv_ok``: (n_sh,
    tl·k), in the picks' original order) and ``emptied`` (n_sh, e·cap):
    the last slots of the over-full experts, which the clobber empties."""
    n_sh, tl, _ = xf.shape
    e = p["router"].shape[-1]
    logits = (xf @ p["router"].to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                  # (n_sh, tl, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)

    # Switch-style aux loss (global means)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx[..., 0], e).float().mean(dim=(0, 1))
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
              capacity_factor: float = 1.25):
    """x: (b, s, d) -> (y: (b, s, d), aux load-balance loss)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    n_sh = 1
    tl = b * s // n_sh
    xf = x.reshape(n_sh, tl, d)
    r = route(p, xf, top_k, capacity_factor)
    cap = r["cap"]

    # gather tokens to (n_sh, e, cap, d) slots
    xe = _rows(xf, r["tok"])
    xe = xe * r["ok"][..., None].to(xe.dtype)
    xe = xe.reshape(n_sh, e, cap, d)

    # expert SwiGLU, batched over (expert, slot)
    hg = torch.einsum("xecd,edf->xecf", xe, p["wg"])
    hi = torch.einsum("xecd,edf->xecf", xe, p["wi"])
    h = F.silu(hg) * hi
    ye = torch.einsum("xecf,efd->xecd", h, p["wo"])

    # combine: gather each token's top-k slots and weight them by the gate
    yflat = ye.reshape(n_sh, e * cap, d).to(x.dtype)
    picked = _rows(yflat, r["inv_slot"])
    w = (r["gates"] * r["inv_ok"]).to(x.dtype)               # (n_sh, tl·k)
    y = (picked * w[..., None]).reshape(n_sh, tl, top_k, d).sum(dim=2)

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(xf @ sp["wg"]) * (xf @ sp["wi"])
        y = y + (hs @ sp["wo"]).to(y.dtype)
    return y.reshape(b, s, d), r["aux"]
